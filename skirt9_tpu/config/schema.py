"""Declarative item schema: defaults + conditional relevance.

Counterpart of the SMILE schema layer (ref: SMILE/schema/
NameManager.hpp:42 name-set accumulation, BooleanExpression.hpp:56
condition evaluation, ItemInfo ATTRIBUTE_DEFAULT_VALUE /
ATTRIBUTE_RELEVANT_IF declarations). Instead of C++ macros compiled into a
SchemaDef, item metadata lives in one python registry that BOTH the writer
(config/skiwriter.py: materializing defaults into parameters.xml) and the
round-trip tests consume — a single source of truth, so a loader default
cannot silently diverge from the regenerated record (round-2 advisory:
skiwriter._DEFAULTS drift risk).

Name sets: walking the hierarchy accumulates names (item tags plus names
INSERTED by enum values — e.g. simulationMode="DustEmission" inserts
"Emission" like MonteCarloSimulation.hpp:227-236); a property's
`relevant_if` boolean expression is evaluated against the accumulated set,
and only relevant properties get their defaults materialized.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Prop:
    """One declared property (ref: ITEM PROPERTY_* + ATTRIBUTE_* macros)."""

    name: str
    default: str | None = None       # ski-syntax literal (with units)
    relevant_if: str | None = None   # boolean expression over the name set


@dataclasses.dataclass(frozen=True)
class ItemDef:
    props: tuple = ()
    # names inserted when the item appears (beyond its own tag), possibly
    # keyed on an attribute value: list of (attr, value_or_None, names)
    inserts: tuple = ()


# ------------------------------------------------- boolean expressions

def evaluate(expr: str, names: set) -> bool:
    """Evaluate a SMILE-style boolean expression ("A&(B|!C)") against a
    name set (ref: BooleanExpression.hpp:56 — identifiers, !, &, |,
    parentheses; & binds tighter than |)."""
    pos = 0

    def peek():
        nonlocal pos
        while pos < len(expr) and expr[pos].isspace():
            pos += 1
        return expr[pos] if pos < len(expr) else ""

    def parse_or():
        v = parse_and()
        while peek() == "|":
            nonlocal pos
            pos += 1
            v2 = parse_and()
            v = v or v2
        return v

    def parse_and():
        v = parse_not()
        while peek() == "&":
            nonlocal pos
            pos += 1
            v2 = parse_not()
            v = v and v2
        return v

    def parse_not():
        nonlocal pos
        c = peek()
        if c == "!":
            pos += 1
            return not parse_not()
        if c == "(":
            pos += 1
            v = parse_or()
            if peek() == ")":
                pos += 1
            return v
        start = pos
        while pos < len(expr) and (expr[pos].isalnum() or expr[pos] == "_"):
            pos += 1
        return expr[start:pos] in names

    return parse_or()


# --------------------------------------------------------------- registry

_MODE_NAMES = {
    "ExtinctionOnly": ("ExtinctionOnly", "NoMedium?"),
    "DustEmission": ("Emission", "DustEmission"),
    "ExtinctionOnly(oligochromatic)": ("Oligochromatic",),
    "LyaExtinctionOnly": ("Lya", "ExtinctionOnly"),
    "NoMedium": ("NoMedium",),
    "GasEmission": ("Emission", "GasEmission"),
    "DustAndGasEmission": ("Emission", "DustEmission", "GasEmission"),
}

REGISTRY: dict[str, ItemDef] = {
    "MonteCarloSimulation": ItemDef(
        props=(
            Prop("userLevel", "Regular"),
            Prop("simulationMode", "ExtinctionOnly"),
            Prop("numPackets", "1e6"),
            Prop("iterateSecondaryEmission", "false",
                 relevant_if="Emission"),
            Prop("iteratePrimaryEmission", "false"),
        ),
        inserts=(("simulationMode", None, _MODE_NAMES),
                 ("iterateSecondaryEmission", "true", ("IterateSecondary",)),
                 ("iteratePrimaryEmission", "true", ("IteratePrimary",))),
    ),
    "Random": ItemDef(props=(Prop("seed", "0"),)),
    "SourceSystem": ItemDef(props=(Prop("sourceBias", "0.5"),)),
    "PointSource": ItemDef(props=(
        Prop("positionX", "0 pc"), Prop("positionY", "0 pc"),
        Prop("positionZ", "0 pc"), Prop("sourceWeight", "1"),
        Prop("wavelengthBias", "0.5"),
    )),
    "GeometricSource": ItemDef(props=(
        Prop("sourceWeight", "1"), Prop("wavelengthBias", "0.5"),
    )),
    "ParticleSource": ItemDef(props=(
        Prop("importVelocity", "false"), Prop("sourceWeight", "1"),
        Prop("wavelengthBias", "0.5"),
    )),
    "GeometricMedium": ItemDef(props=(
        Prop("velocityMagnitude", "0 km/s"),
    )),
    "PhotonPacketOptions": ItemDef(props=(
        Prop("forceScattering", "true"),
        Prop("explicitAbsorption", "false"),
        Prop("minWeightReduction", "1e4"),
        Prop("minScattEvents", "0"),
        # the bias only applies to the forced-scattering cycle
        # (ref: PhotonPacketOptions.hpp:83 RELEVANT_IF ForceScattering;
        # kinematics forces it to 0 at the derived-config level)
        Prop("pathLengthBias", "0.5", relevant_if="ForceScattering"),
    ), inserts=(("forceScattering", "true", ("ForceScattering",)),)),
    "RadiationFieldOptions": ItemDef(props=(
        Prop("storeRadiationField", "true", relevant_if="Emission"),
    )),
    "DustEmissionOptions": ItemDef(props=(
        Prop("dustEmissionType", "Equilibrium", relevant_if="DustEmission"),
        Prop("includeHeatingByCMB", "false", relevant_if="DustEmission"),
        Prop("maxFractionOfPrimary", "0.01",
             relevant_if="DustEmission&IterateSecondary"),
        Prop("maxFractionOfPrevious", "0.03",
             relevant_if="DustEmission&IterateSecondary"),
        Prop("sourceWeight", "1", relevant_if="DustEmission"),
        Prop("wavelengthBias", "0.5", relevant_if="DustEmission"),
    ), inserts=(("dustEmissionType", "Stochastic", ("StochasticHeating",)),)),
    "IterationOptions": ItemDef(props=(
        Prop("minSecondaryIterations", "1", relevant_if="IterateSecondary"),
        Prop("maxSecondaryIterations", "10", relevant_if="IterateSecondary"),
        Prop("includePrimaryEmission", "false",
             relevant_if="IterateSecondary"),
        Prop("minPrimaryIterations", "1", relevant_if="IteratePrimary"),
        Prop("maxPrimaryIterations", "10", relevant_if="IteratePrimary"),
    )),
    "SecondaryEmissionOptions": ItemDef(props=(
        Prop("spatialBias", "0.5", relevant_if="Emission"),
        Prop("sourceBias", "0.5", relevant_if="Emission"),
        Prop("secondaryPacketsMultiplier", "1", relevant_if="Emission"),
    )),
    "ElectronMix": ItemDef(
        props=(Prop("includePolarization", "false"),),
        inserts=(("includePolarization", "true", ("Polarization",)),)),
    "XRayAtomicGasMix": ItemDef(props=(
        Prop("scatterBoundElectrons", "Good"),
    )),
    "LinMesh": ItemDef(props=(Prop("numBins", "32"),)),
    "LogMesh": ItemDef(props=(Prop("numBins", "32"),)),
    "PowMesh": ItemDef(props=(Prop("numBins", "32"),)),
    "FullInstrument": ItemDef(props=(
        Prop("recordComponents", "false"),
        Prop("recordPolarization", "false", relevant_if="Polarization"),
        Prop("recordStatistics", "false"),
        Prop("numScatteringLevels", "0"),
        Prop("centerX", "0 pc"), Prop("centerY", "0 pc"),
        Prop("inclination", "0 deg"), Prop("azimuth", "0 deg"),
        Prop("roll", "0 deg"),
    )),
    "FrameInstrument": ItemDef(props=(
        Prop("centerX", "0 pc"), Prop("centerY", "0 pc"),
        Prop("inclination", "0 deg"), Prop("azimuth", "0 deg"),
        Prop("roll", "0 deg"),
    )),
    "SEDInstrument": ItemDef(props=(
        Prop("inclination", "0 deg"), Prop("azimuth", "0 deg"),
        Prop("roll", "0 deg"),
    )),
    "RadialVectorField": ItemDef(props=(
        Prop("unityRadius", "0 pc"), Prop("exponent", "1"),
    )),
    "CylindricalVectorField": ItemDef(props=(
        Prop("unityRadius", "0 pc"), Prop("exponent", "1"),
    )),
    "DensityTreePolicy": ItemDef(props=(
        Prop("minLevel", "2"), Prop("maxLevel", "6"),
        Prop("maxDustFraction", "1e-6"),
        Prop("maxDustOpticalDepth", "0"),
        Prop("maxDustDensityDispersion", "0"),
        Prop("maxElectronFraction", "1e-6"),
        Prop("maxGasFraction", "1e-6"),
    )),
}


def collect_names(root) -> set:
    """Accumulate the name set over a parsed element tree (the walk order
    mirrors the reference's top-down NameManager accumulation)."""
    names = set()

    def visit(el):
        names.add(el.tag)
        d = REGISTRY.get(el.tag)
        if d:
            # defaulted values insert their names too: the reference's
            # NameManager evaluates the PROPERTY VALUE (which falls back to
            # the schema default when the ski omits the attribute), so e.g.
            # an omitted forceScattering="true" still inserts
            # ForceScattering and keeps pathLengthBias relevant
            # (ref: SMILE NameManager insertFromConditionalValue)
            defaults = {p.name: p.default for p in d.props}
            for attr, val, ins in d.inserts:
                got = el.attrib.get(attr, defaults.get(attr))
                if isinstance(ins, dict):
                    for n in ins.get(got or "", ()):
                        if not n.endswith("?"):
                            names.add(n)
                elif got == val or (val is None and got is not None):
                    names.update(ins)
        for c in el:
            visit(c)

    visit(root)
    return names


def materialize(root) -> None:
    """Set every RELEVANT property that is absent to its schema default,
    in place (the XmlHierarchyWriter contract: the written hierarchy holds
    every property the run actually used)."""
    names = collect_names(root)

    def visit(el):
        d = REGISTRY.get(el.tag)
        if d:
            for p in d.props:
                if p.default is None or p.name in el.attrib:
                    continue
                if p.relevant_if and not evaluate(p.relevant_if, names):
                    continue
                el.attrib[p.name] = p.default
        for c in el:
            visit(c)

    visit(root)


# ----------------------------------------------------------- schema export

def supported_type_names() -> list:
    """Item type names the ski loader accepts, extracted from the loader
    source itself (the builders are `if t == "Name"` chains, so the
    scan stays in sync with the code automatically)."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(__file__), "ski.py"),
               encoding="utf-8").read()
    names = set()
    # t == "Name" / .tag == "Name" / == "Name" comparisons
    for m in re.finditer(r'==\s*"([A-Z][A-Za-z0-9]+)"', src):
        names.add(m.group(1))
    # t in ("A", "B", ...) membership tests
    for m in re.finditer(r'in\s*\(\s*((?:"[A-Z][A-Za-z0-9]+",?\s*)+)\)',
                         src):
        names.update(re.findall(r'"([A-Z][A-Za-z0-9]+)"', m.group(1)))
    # registry/dict keys mapping type names (probe map, compositions...)
    for m in re.finditer(r'"([A-Z][A-Za-z0-9]+(?:Probe|Composition|Mix|'
                         r'Geometry|Source|SED|Grid|Mesh|Instrument|'
                         r'Decorator|Policy|Distribution|VectorField|'
                         r'Family|Normalization|Field|Recipe|Law))"\s*:',
                         src):
        names.add(m.group(1))
    drop = {"MonteCarloSimulation", "UTF",
            # enum VALUES the regex over-collects (attribute values, not
            # item types: massType / policies / table counts / schemes)
            "Mass", "MassDensity", "Number", "NumberDensity", "BinTree",
            "Constant", "Variable", "Inside", "Outside", "DustDensity",
            "DustEmission", "DustAndGasEmission", "ImportedMesh",
            "OneTable", "TwoTables", "Silicate", "Stochastic",
            "Equilibrium", "ExtinctionOnly", "OligoExtinctionOnly",
            "LyaExtinctionOnly", "NoMedium", "OligoNoMedium"}
    return sorted(n for n in names - drop
                  if not n.startswith(("Not", "No")) or n == "NoPolarization")


def export_smile(path: str) -> str:
    """Write a SMILE-style schema XML describing this framework's item
    surface: the declarative registry's typed property definitions
    (defaults + conditional relevance) plus every type name the loader
    accepts (ref: the reference's `smiletool` schema export consumed by
    MakeUp, SMILE/serialize/XmlHierarchyWriter)."""
    import xml.etree.ElementTree as ET

    root = ET.Element("smile-schema", {"producer": "skirt9_tpu",
                                       "format": "9"})
    types = ET.SubElement(root, "Types")
    reg_names = set()
    for name, d in REGISTRY.items():
        reg_names.add(name)
        te = ET.SubElement(types, "Type", {"name": name})
        for attr, val, names_i in d.inserts:
            ie = ET.SubElement(te, "Insert", {"names": ",".join(names_i)})
            if attr:
                ie.set("attribute", attr)
            if val is not None:
                ie.set("value", val)
        for p in d.props:
            pe = ET.SubElement(te, "Property", {"name": p.name})
            if p.default is not None:
                pe.set("default", p.default)
            if p.relevant_if is not None:
                pe.set("relevantIf", p.relevant_if)
    # every other accepted type: typed property lists HARVESTED from the
    # builders themselves (config/harvest.py) — name, unit quantity,
    # default, required/item kind for each attribute the loader consumes
    # (ref: SchemaDef.hpp:22 describes every property of every type; the
    # harvest keeps this export from ever drifting from the code)
    from .harvest import harvest
    hv = harvest()
    for name in supported_type_names():
        if name in reg_names:
            continue
        te = ET.SubElement(types, "Type", {"name": name})
        props = hv.get(name) or {}
        if not props:
            te.set("noProperties", "true")
        for p in props.values():
            pe = ET.SubElement(te, "Property",
                              {"name": p.name, "kind": p.kind})
            if p.quantity:
                pe.set("quantity", p.quantity)
            if p.default is not None:
                pe.set("default", p.default)
            if p.required:
                pe.set("required", "true")
    ET.indent(root)
    ET.ElementTree(root).write(path, encoding="UTF-8",
                               xml_declaration=True)
    return path
