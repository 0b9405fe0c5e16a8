"""ski-file importer: build a Simulation from a SKIRT 9 parameter file.

Batched counterpart of the SMILE config stack (ref: SMILE/serialize/
XmlHierarchyCreator, SKIRT/core/SimulationItemRegistry.cpp — 390 item
types; SkirtUnitDef for unit-aware attribute parsing). Instead of a macro
DSL + runtime schema, item types map to Python builder functions registered
in _BUILDERS; unknown types raise with the item name so coverage gaps are
explicit. The subset grows with the engine's capabilities.

Usage:
    sim = load_ski("model.ski", num_packets=..., overrides...)
    rf, accs = sim.run_primary()  (or run_with_dust_emission)
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np
import jax.numpy as jnp

from ..geometries import analytic as ga
from ..geometries import axial as gax
from ..grids.cartesian import make_cartesian
from ..grids.octree import build_octree
from ..instruments import distant as dinst
from ..media import geometric as gm
from ..media import mixes as mx
from ..sources.base import GeometricSource, PointSource, TabulatedSED
from ..spectral import seds as sedlib
from ..spectral import wavelengths as wl
from ..transport import lifecycle as lc
from ..simulation import Simulation
from ..utils import units as U


# When enabled (during load_ski), every default the loader consults is
# WRITTEN BACK into the element's attributes in ski syntax, so the
# regenerated parameters.xml holds every property the run actually used —
# the XmlHierarchyWriter contract (ref: SMILE/serialize/XmlHierarchyWriter
# walks the live items and writes resolved values) — derived from the
# builders themselves instead of a hand-maintained default table.
_MATERIALIZE = False


def _q(attrs, name, qty, default=None):
    """Parse a unit-bearing attribute into SI."""
    if name not in attrs:
        if default is None:
            raise KeyError(f"missing attribute '{name}'")
        if _MATERIALIZE and isinstance(attrs, dict):
            try:
                attrs[name] = U.format_si(qty, default)
            except Exception:
                pass
        return default
    return U.parse(qty, attrs[name])


def _f(attrs, name, default=None):
    if name not in attrs:
        if default is None:
            raise KeyError(f"missing attribute '{name}'")
        if _MATERIALIZE and isinstance(attrs, dict):
            attrs[name] = repr(float(default))
        return default
    return float(attrs[name])


def _child(el, tag):
    c = el.find(tag)
    return list(c)[0] if c is not None and len(c) else None


# ------------------------------------------------------------------ geometry

# input-file base directory of the ski being loaded (set by load_ski) so
# nested builders (geometry decorators etc.) resolve relative filenames
# against the ski file's location like the reference's FilePaths
_SKI_BASE_DIR = "."


def build_geometry(el, base_dir: str | None = None):
    t = el.tag
    a = el.attrib
    base_dir = base_dir or _SKI_BASE_DIR
    if t in ("ReadFitsGeometry", "ReadFits3DGeometry"):
        # observation-based geometries (ref: ReadFitsGeometry.hpp:14,
        # ReadFits3DGeometry.hpp:14) through our own FITS reader
        from ..geometries import fitsgeometry as fg
        fn = a["filename"]
        if not os.path.isabs(fn):
            fn = os.path.join(base_dir, fn)
        if t == "ReadFits3DGeometry":
            return fg.ReadFits3DGeometry(
                filename=fn, pixel_scale=_q(a, "pixelScale", "length"))
        return fg.ReadFitsGeometry(
            filename=fn, pixel_scale=_q(a, "pixelScale", "length"),
            scale_height=_q(a, "scaleHeight", "length"),
            position_angle=_q(a, "positionAngle", "angle", 0.0),
            inclination=_q(a, "inclination", "angle", 0.0),
            center_x=(_f(a, "centerX") if "centerX" in a else None),
            center_y=(_f(a, "centerY") if "centerY" in a else None))
    if t == "PlummerGeometry":
        return ga.PlummerGeometry(b=_q(a, "scaleLength", "length"))
    if t == "GammaGeometry":
        return ga.GammaGeometry(b=_q(a, "scaleLength", "length"),
                                gamma=_f(a, "gamma"))
    if t == "ShellGeometry":
        return ga.ShellGeometry(rmin=_q(a, "minRadius", "length"),
                                rmax=_q(a, "maxRadius", "length"),
                                p=_f(a, "exponent", 0.0))
    if t == "GaussianGeometry":
        return ga.GaussianGeometry(sigma=_q(a, "dispersion", "length"))
    if t == "ExpDiskGeometry":
        return ga.ExpDiskGeometry(h_r=_q(a, "scaleLength", "length"),
                                  h_z=_q(a, "scaleHeight", "length"))
    if t == "SersicGeometry":
        return ga.SersicGeometry(reff=_q(a, "effectiveRadius", "length"),
                                 m=_f(a, "index", 4.0))
    if t == "UniformSphereGeometry":  # convenience extension
        return ga.UniformSphereGeometry(rmax=_q(a, "maxRadius", "length"))
    if t == "EinastoGeometry":
        # the reference parameterizes by half-mass radius; solve for the
        # scale radius rs such that M(<rh) = M/2 (ref: EinastoGeometry.hpp)
        rh = _q(a, "halfMassRadius", "length")
        n = _f(a, "index")
        x = np.geomspace(1e-4, 30.0, 8192)  # matches EinastoGeometry rmax=30 rs
        w = x**2 * np.exp(-2 * n * (x ** (1.0 / n) - 1.0))
        cum = np.cumsum(w * np.gradient(x))
        xh = x[int(np.searchsorted(cum, 0.5 * cum[-1]))]  # rh/rs
        return ga.EinastoGeometry(rs=rh / xh, n=n)
    if t == "PseudoSersicGeometry":
        return ga.PseudoSersicGeometry(reff=_q(a, "effectiveRadius", "length"),
                                       m=_f(a, "index", 4.0))
    if t == "UniformBoxGeometry":
        x0, x1 = _q(a, "minX", "length"), _q(a, "maxX", "length")
        y0, y1 = _q(a, "minY", "length"), _q(a, "maxY", "length")
        z0, z1 = _q(a, "minZ", "length"), _q(a, "maxZ", "length")
        return ga.UniformBoxGeometry(lx=x1 - x0, ly=y1 - y0, lz=z1 - z0,
                                     cx=0.5 * (x0 + x1), cy=0.5 * (y0 + y1),
                                     cz=0.5 * (z0 + z1))
    if t == "TorusGeometry":
        return gax.TorusGeometry(
            p=_f(a, "exponent"), q=_f(a, "index"),
            delta=_q(a, "openingAngle", "posangle"),
            rmin=_q(a, "minRadius", "length"),
            rmax=_q(a, "maxRadius", "length"))
    if t == "ConicalShellGeometry":
        return gax.ConicalShellGeometry(
            p=_f(a, "exponent"),
            delta_in=_q(a, "minAngle", "posangle"),
            delta_out=_q(a, "maxAngle", "posangle"),
            rmin=_q(a, "minRadius", "length"),
            rmax=_q(a, "maxRadius", "length"))
    if t == "TTauriDiskGeometry":
        return gax.TTauriDiskGeometry(
            rd=_q(a, "scaleLength", "length"),
            zd=_q(a, "scaleHeight", "length"),
            rinn=_q(a, "minRadius", "length"),
            rout=_q(a, "maxRadius", "length"))
    if t == "RingGeometry":
        return gax.RingGeometry(r0=_q(a, "ringRadius", "length"),
                                width=_q(a, "width", "length"),
                                hz=_q(a, "height", "length"))
    if t == "AnnulusGeometry":
        return gax.AnnulusGeometry(rmin=_q(a, "minRadius", "length"),
                                   rmax=_q(a, "maxRadius", "length"),
                                   height=_q(a, "height", "length"))
    if t == "DonutGeometry":
        return gax.DonutGeometry(r0=_q(a, "largeRadius", "length"),
                                 rc=_q(a, "smallRadius", "length"))
    if t == "BrokenExpDiskGeometry":
        return gax.BrokenExpDiskGeometry(
            h_inn=_q(a, "scaleLengthInner", "length"),
            h_out=_q(a, "scaleLengthOuter", "length"),
            hz=_q(a, "scaleHeight", "length"),
            rb=_q(a, "breakRadius", "length"))

    # ----------------------------------------------------------- decorators
    # (ref: the GeometryDecorator family; each wraps a nested geometry item)
    from ..geometries import decorators as dec
    if t == "OffsetGeometryDecorator":
        return dec.OffsetDecorator(
            base=build_geometry(_child(el, "geometry")),
            offset=(_q(a, "offsetX", "length", 0.0),
                    _q(a, "offsetY", "length", 0.0),
                    _q(a, "offsetZ", "length", 0.0)))
    if t == "RotateGeometryDecorator":
        return dec.RotateDecorator(
            base=build_geometry(_child(el, "geometry")),
            alpha=_q(a, "eulerAlpha", "posangle", 0.0),
            beta=_q(a, "eulerBeta", "posangle", 0.0),
            gamma=_q(a, "eulerGamma", "posangle", 0.0))
    if t == "SpheroidalGeometryDecorator":
        return dec.SpheroidalDecorator(
            base=build_geometry(_child(el, "geometry")),
            q=_f(a, "flattening", 1.0))
    if t == "TriaxialGeometryDecorator":
        return dec.TriaxialDecorator(
            base=build_geometry(_child(el, "geometry")),
            p=_f(a, "flatteningY", 1.0), q=_f(a, "flatteningZ", 1.0))
    if t == "SphericalClipGeometryDecorator":
        return dec.SphereClipDecorator(
            base=build_geometry(_child(el, "geometry")),
            remove_inside=a.get("remove", "Inside") == "Inside",
            center=(_q(a, "centerX", "length", 0.0),
                    _q(a, "centerY", "length", 0.0),
                    _q(a, "centerZ", "length", 0.0)),
            radius=_q(a, "clipRadius", "length"))
    if t == "SphePowerLawRedistributeGeometryDecorator":
        return dec.SphePowerLawRedistributeDecorator(
            base=build_geometry(_child(el, "geometry")),
            exponent=_f(a, "exponent", 1.0),
            min_radius=_q(a, "minRadius", "length"))
    if t == "AxPowerLawRedistributeGeometryDecorator":
        return dec.AxPowerLawRedistributeDecorator(
            base=build_geometry(_child(el, "geometry")),
            exponent=_f(a, "exponent", 1.0),
            min_radius=_q(a, "minRadius", "length"))
    if t == "BoxClipGeometryDecorator":
        return dec.BoxClipDecorator(
            base=build_geometry(_child(el, "geometry")),
            remove_inside=a.get("remove", "Inside") == "Inside",
            lo=(_q(a, "minX", "length"), _q(a, "minY", "length"),
                _q(a, "minZ", "length")),
            hi=(_q(a, "maxX", "length"), _q(a, "maxY", "length"),
                _q(a, "maxZ", "length")))
    if t == "CylindricalClipGeometryDecorator":
        return dec.CylinderClipDecorator(
            base=build_geometry(_child(el, "geometry")),
            remove_inside=a.get("remove", "Inside") == "Inside",
            radius=_q(a, "clipRadius", "length"))
    if t == "CombineGeometryDecorator":
        return dec.CombineDecorator(
            first=build_geometry(_child(el, "firstGeometry")),
            second=build_geometry(_child(el, "secondGeometry")),
            w1=_f(a, "firstWeight", 1.0), w2=_f(a, "secondWeight", 1.0))
    if t == "ClumpyGeometryDecorator":
        return dec.ClumpyDecorator(
            base=build_geometry(_child(el, "geometry")),
            clump_fraction=_f(a, "clumpFraction", 0.3),
            num_clumps=int(_f(a, "numClumps", 100)),
            clump_radius=_q(a, "clumpRadius", "length"),
            seed=int(_f(a, "seed", 99)) or 99)
    if t == "SpiralStructureGeometryDecorator":
        return dec.SpiralStructureDecorator(
            base=build_geometry(_child(el, "geometry")),
            num_arms=int(_f(a, "numArms", 1)),
            pitch_angle=_q(a, "pitchAngle", "posangle", 0.1745),
            radius_zero_point=_q(a, "radiusZeroPoint", "length"),
            phase_zero_point=_q(a, "phaseZeroPoint", "posangle", 0.0),
            perturbation_weight=_f(a, "perturbationWeight", 0.25),
            index=int(_f(a, "index", 1)))
    if t in ("ParticleGeometry", "CellGeometry", "CylindricalCellGeometry",
             "SphericalCellGeometry", "VoronoiMeshGeometry",
             "AdaptiveMeshGeometry"):
        return build_imported_geometry(el, base_dir)
    raise NotImplementedError(f"geometry type '{t}' not supported yet")


def build_imported_geometry(el, base_dir: str):
    """Snapshot data as a normalized geometry (ref: ImportedGeometry.hpp:19
    + its concrete subclasses): usable anywhere a Geometry is — as a
    GeometricSource's shape or a GeometricMedium's density profile."""
    from ..geometries import imported as ig
    from ..imports import snapshots as snap

    t, a = el.tag, el.attrib
    fn = a["filename"]
    if not os.path.isabs(fn):
        fn = os.path.join(base_dir, fn)
    import_z = a.get("importMetallicity", "false") == "true"
    import_t = a.get("importTemperature", "false") == "true"
    max_t = _q(a, "maxTemperature", "temperature", 0.0) if import_t else 0.0
    mt = a.get("massType", "MassDensity")

    def _zt_cols(cols):
        if import_z:
            cols.append(("Z", "", ""))
        if import_t:
            cols.append(("T", "temperature", "K"))
        return cols

    def _mass_post(mass, d):
        # metallicity scales the included mass; a positive maxTemperature
        # excludes hot entities (ref: ImportedGeometry.hpp
        # importMetallicity/maxTemperature semantics via Snapshot policy)
        mass = np.asarray(mass, np.float64)
        if import_z:
            mass = mass * d["Z"]
        if import_t and max_t > 0:
            mass = np.where(d["T"] <= max_t, mass, 0.0)
        return mass

    if t == "ParticleGeometry":
        kern_el = _child(el, "smoothingKernel")
        cols = _zt_cols([("x", "length", "pc"), ("y", "length", "pc"),
                         ("z", "length", "pc"), ("h", "length", "pc"),
                         ("M", "mass", "Msun")])
        d = snap.read_column_file(fn, cols)
        ss = snap.ParticleSnapshot(
            positions=np.stack([d["x"], d["y"], d["z"]], axis=-1),
            h=d["h"], mass=_mass_post(d["M"], d))
        return ig.ParticleGeometry(
            snapshot=ss,
            kernel_kind=(kern_el.tag if kern_el is not None
                         else "CubicSplineSmoothingKernel"))
    if t == "CellGeometry":
        cols = [("xmin", "length", "pc"), ("ymin", "length", "pc"),
                ("zmin", "length", "pc"), ("xmax", "length", "pc"),
                ("ymax", "length", "pc"), ("zmax", "length", "pc")]
        cols.append(("rho", "massvolumedensity", "Msun/pc3")
                    if mt == "MassDensity" else ("M", "mass", "Msun"))
        d = snap.read_column_file(fn, _zt_cols(cols))
        lo = np.stack([d["xmin"], d["ymin"], d["zmin"]], axis=-1)
        hi = np.stack([d["xmax"], d["ymax"], d["zmax"]], axis=-1)
        mass = (d["rho"] * np.prod(hi - lo, axis=-1)
                if mt == "MassDensity" else d["M"])
        return ig.CellGeometry(snapshot=snap.CellSnapshot(
            lo=lo, hi=hi, mass=_mass_post(mass, d)))
    if t == "CylindricalCellGeometry":
        cols = _zt_cols([("Rmin", "length", "pc"),
                         ("phimin", "posangle", "deg"),
                         ("zmin", "length", "pc"),
                         ("Rmax", "length", "pc"),
                         ("phimax", "posangle", "deg"),
                         ("zmax", "length", "pc"),
                         ("M", "mass", "Msun")])
        d = snap.read_column_file(fn, cols)
        lo = np.stack([d["Rmin"], d["phimin"], d["zmin"]], axis=-1)
        hi = np.stack([d["Rmax"], d["phimax"], d["zmax"]], axis=-1)
        return ig.CylindricalCellGeometry(
            snapshot=snap.CylindricalCellSnapshot(
                lo=lo, hi=hi, mass=_mass_post(d["M"], d)))
    if t == "SphericalCellGeometry":
        cols = _zt_cols([("rmin", "length", "pc"),
                         ("thetamin", "posangle", "deg"),
                         ("phimin", "posangle", "deg"),
                         ("rmax", "length", "pc"),
                         ("thetamax", "posangle", "deg"),
                         ("phimax", "posangle", "deg"),
                         ("M", "mass", "Msun")])
        d = snap.read_column_file(fn, cols)
        lo = np.stack([d["rmin"], d["thetamin"], d["phimin"]], axis=-1)
        hi = np.stack([d["rmax"], d["thetamax"], d["phimax"]], axis=-1)
        return ig.SphericalCellGeometry(
            snapshot=snap.SphericalCellSnapshot(
                lo=lo, hi=hi, mass=_mass_post(d["M"], d)))

    # mesh-based variants need the domain box (ref: MeshGeometry.hpp:31)
    ext_box = ((_q(a, "minX", "length"), _q(a, "maxX", "length")),
               (_q(a, "minY", "length"), _q(a, "maxY", "length")),
               (_q(a, "minZ", "length"), _q(a, "maxZ", "length")))
    if t == "VoronoiMeshGeometry":
        cols = [("x", "length", "pc"), ("y", "length", "pc"),
                ("z", "length", "pc")]
        cols.append(("rho", "massvolumedensity", "Msun/pc3")
                    if mt == "MassDensity" else ("M", "mass", "Msun"))
        d = snap.read_column_file(fn, _zt_cols(cols))
        sites = np.stack([d["x"], d["y"], d["z"]], axis=-1)
        if mt == "MassDensity":
            # metallicity/temperature filters scale the density directly
            # (per-cell mass = rho * volume after the tessellation build)
            return ig.VoronoiMeshGeometry(
                sites=sites, mass_density=_mass_post(d["rho"], d),
                extent=ext_box)
        return ig.VoronoiMeshGeometry(sites=sites,
                                      mass=_mass_post(d["M"], d),
                                      extent=ext_box)
    if t == "AdaptiveMeshGeometry":
        from ..grids.amr import build_amr
        grid, leaf = build_amr(fn, ext_box)
        MSUN = 1.98892e30
        q = leaf[:, 0]
        vol = grid.volumes()
        if mt == "MassDensity":
            mass = q * (MSUN / 3.0857e16 ** 3) * vol
        elif mt == "Mass":
            mass = q * MSUN
        else:
            raise NotImplementedError(f"massType '{mt}'")
        c_ = 1
        d = {}
        if import_z:
            d["Z"] = leaf[:, c_]
            c_ += 1
        if import_t:
            d["T"] = leaf[:, c_]
            c_ += 1
        return ig.AdaptiveMeshGeometry(grid=grid,
                                       mass=_mass_post(mass, d))
    raise NotImplementedError(f"imported geometry '{t}'")


# ---------------------------------------------------------------------- SEDs

def build_sed(el, base_dir: str = ".") -> TabulatedSED:
    t = el.tag
    a = el.attrib
    if t == "BlackBodySED":
        return sedlib.blackbody(_q(a, "temperature", "temperature"))
    if t == "QuasarSED":
        return sedlib.quasar()
    if t == "SunSED":
        return sedlib.sun_approx()
    if t == "FileSED":
        # SKIRT text columns default to wavelength in micron; input files
        # resolve relative to the ski file's directory
        # (ref: TextInFile default units for FileSED; FilePaths input)
        fn = a["filename"]
        if not os.path.isabs(fn):
            fn = os.path.join(base_dir, fn)
        return sedlib.from_file(fn, lam_unit=1e-6)
    if t == "LyaGaussianSED":
        return sedlib.lya_gaussian(_q(a, "dispersion", "velocity", 50e3))
    if t == "LyaDoublePeakedSED":
        return sedlib.lya_double_peaked(_q(a, "scale", "velocity", 50e3))
    if t == "ListLineSED":
        lams = U.parse_list("wavelength", a["wavelengths"])
        lums = U.parse_list("bolluminosity", a["luminosities"])
        return sedlib.lines(lams, lums)
    if t == "FileLineSED":
        # two columns: wavelength [micron], luminosity [W]
        d = np.loadtxt(a["filename"], ndmin=2)
        return sedlib.lines(d[:, 0] * 1e-6, d[:, 1])
    from ..spectral import named as _named
    if t in _named.NAMED_SEDS:
        # resource-backed stellar population SEDs (ref: SED.hpp:49 family;
        # requires the SKIRT9 resource pack on SKIRT9_TPU_RESOURCES)
        def _qq(attrs, name, quantity, default):
            return _q(attrs, name, quantity, default)
        return _named.named_sed(t, a, _qq)
    raise NotImplementedError(f"SED type '{t}' not supported yet")


def source_luminosity(el, lrange=None, base_dir: str = ".") -> float:
    """LuminosityNormalization family: the scalar luminosity the normalized
    SED is multiplied by (ref: LuminosityNormalization subclasses)."""
    norm = _child(el, "normalization")
    if norm is None:
        return 1.0
    a = norm.attrib
    if norm.tag == "IntegratedLuminosityNormalization":
        return _q(a, "integratedLuminosity", "bolluminosity")
    if norm.tag == "SpecificLuminosityNormalization":
        # L_lambda at one wavelength, converted per unitStyle
        lam0 = _q(a, "wavelength", "wavelength", 0.55e-6)
        style = a.get("unitStyle", "wavelengthmonluminosity")
        if "specificLuminosity" in a:
            Lspec = U.parse({"wavelengthmonluminosity": "monluminosity",
                             "frequencymonluminosity": "monluminosityHz",
                             "neutralmonluminosity": "bolluminosity"}
                            .get(style, "monluminosity"),
                            a["specificLuminosity"])
        else:
            return _q(a, "specificLuminosity", "monluminosity")
        Llam = _style_to_per_wavelength(Lspec, lam0, style)
        sed_el = _child(el, "sed")
        if sed_el is None:
            return Llam
        sed = build_sed(sed_el, base_dir=base_dir)
        if lrange is not None:
            sed = sedlib.clipped(sed, *lrange)
        lam = np.asarray(sed.lam, np.float64)
        p = np.asarray(sed.s, np.float64)
        p = p / np.trapezoid(p, lam)
        p0 = float(np.interp(lam0, lam, p, left=0.0, right=0.0))
        if p0 <= 0:
            raise ValueError("normalization wavelength outside the SED")
        return Llam / p0
    if norm.tag == "BandLuminosityNormalization":
        # mean specific luminosity over a band (ref:
        # BandLuminosityNormalization.cpp luminosityForSED: user L_lambda
        # at the pivot divided by the SED's band-convolved mean)
        band = _build_single_band(_child(norm, "band"), base_dir)
        sed_el = _child(el, "sed")
        if sed_el is None:
            raise NotImplementedError(
                "BandLuminosityNormalization needs a continuum SED")
        sed = build_sed(sed_el, base_dir=base_dir)
        if lrange is not None:
            sed = sedlib.clipped(sed, *lrange)
        lam = np.asarray(sed.lam, np.float64)
        p = np.asarray(sed.s, np.float64)
        p = p / np.trapezoid(p, lam)          # normalized L_lambda density
        lg = np.asarray(band.lam, np.float64)
        T = np.asarray(band.transmission, np.float64)
        pv = np.interp(lg, lam, p, left=0.0, right=0.0)
        mean = np.trapezoid(T * pv, lg) / np.trapezoid(T, lg)
        if mean <= 0:
            raise ValueError("normalization band outside the SED range")
        style = a.get("unitStyle", "wavelengthmonluminosity")
        Lspec = U.parse({"wavelengthmonluminosity": "monluminosity",
                         "frequencymonluminosity": "monluminosityHz",
                         "neutralmonluminosity": "bolluminosity"}
                        .get(style, "monluminosity"),
                        a["specificLuminosity"])
        Llam = _style_to_per_wavelength(Lspec, band.pivot_wavelength(),
                                        style)
        return Llam / mean
    if norm.tag == "LineLuminosityNormalization":
        # luminosity in one emission line of a line SED (ref:
        # LineLuminosityNormalization.cpp: L_total = L_line / sum of the
        # SED's relative line luminosities within the line's neighborhood)
        lam0 = _q(a, "wavelength", "wavelength")
        L_line = _q(a, "luminosity", "bolluminosity")
        sed_el = _child(el, "sed")
        sed = build_sed(sed_el, base_dir=base_dir) \
            if sed_el is not None else None
        lines = getattr(sed, "_lines", None)
        if lines is None:
            raise NotImplementedError(
                "LineLuminosityNormalization needs a line SED "
                "(ListLineSED/FileLineSED)")
        lams, lums = lines
        i = int(np.argmin(np.abs(np.asarray(lams) - lam0)))
        if abs(lams[i] / lam0 - 1) > 1e-3:
            raise ValueError(
                f"no emission line at {lam0 * 1e6:.4f} micron")
        frac = lums[i] / np.sum(lums)
        return L_line / frac
    raise NotImplementedError(f"normalization '{norm.tag}' not supported yet")


def _style_to_per_wavelength(L: float, lam: float, style: str) -> float:
    """Convert a specific luminosity in the given unit style to
    per-wavelength units (ref: Units::fromFluxStyle)."""
    C = 2.99792458e8
    if style == "frequencymonluminosity":
        return L * C / lam ** 2
    if style == "neutralmonluminosity":
        return L / lam
    return L


def _build_single_band(b_el, base_dir: str):
    """One Band item (ref: Band.hpp subclasses)."""
    from ..spectral import bands as bnd
    from ..spectral import named as _named
    ba = b_el.attrib
    if b_el.tag == "BroadBand":
        return _named.broad_band(ba["bandName"])
    if b_el.tag == "FileBand":
        fn = ba["filename"]
        if not os.path.isabs(fn):
            fn = os.path.join(base_dir, fn)
        return bnd.file_band(ba.get("bandName", fn), fn)
    if b_el.tag == "ListBand":
        lams = U.parse_list("wavelength", ba["wavelengths"])
        trans = [float(x) for x in ba["transmissionValues"].split(",")]
        return bnd.list_band("list", lams, trans)
    raise NotImplementedError(f"band '{b_el.tag}'")


# ------------------------------------------------------------------- sources

def build_source(el, lrange=None, base_dir: str = "."):
    t = el.tag
    a = el.attrib

    def _bias_kw():
        """wavelengthBias + wavelengthBiasDistribution of NormalizedSource
        (ref: NormalizedSource.hpp wavelengthBias properties)."""
        kw = {}
        if "wavelengthBias" in a:
            kw["wavelength_bias"] = _f(a, "wavelengthBias", 0.5)
        wb_el = _child(el, "wavelengthBiasDistribution")
        if wb_el is not None:
            # A LogWavelengthDistribution without an explicit range equals
            # the built-in log-uniform fallback — skip the build. With an
            # explicit range it must be honored (the reference intersects
            # it with the source range, RangeWavelengthDistribution).
            if (wb_el.tag not in ("LogWavelengthDistribution",
                                  "DefaultWavelengthDistribution")
                    or "minWavelength" in wb_el.attrib):
                from ..spectral import wdists
                kw["bias_dist"] = wdists.from_ski(wb_el, lrange, base_dir)
        return kw

    if t == "PointSource":
        pos = (_q(a, "positionX", "length", 0.0),
               _q(a, "positionY", "length", 0.0),
               _q(a, "positionZ", "length", 0.0))
        sed_el = _child(el, "sed")
        sed = build_sed(sed_el, base_dir=base_dir) \
            if sed_el is not None else None
        # polarized emission (ref: PointSource.hpp:44 polarizationProfile)
        pol = None
        pol_el = _child(el, "polarizationProfile")
        if pol_el is not None and pol_el.tag != "NoPolarizationProfile":
            if pol_el.tag != "SineSquarePolarizationProfile":
                raise NotImplementedError(
                    f"polarization profile '{pol_el.tag}'")
            from ..sources.base import SineSquarePolarizationProfile
            pa2 = pol_el.attrib
            pol = SineSquarePolarizationProfile(
                symmetry=(_f(pa2, "symmetryX", 0.0),
                          _f(pa2, "symmetryY", 0.0),
                          _f(pa2, "symmetryZ", 1.0)),
                max_polarization=_f(pa2, "maxPolarizationDegree", 1.0),
                angle=_q(pa2, "polarizationAngle", "posangle", 0.0))
        return PointSource(position=pos,
                           luminosity=source_luminosity(el, lrange,
                                                        base_dir),
                           sed=sed, polarization=pol, **_bias_kw())
    if t == "GeometricSource":
        geom = build_geometry(_child(el, "geometry"))
        sed_el = _child(el, "sed")
        sed = build_sed(sed_el, base_dir=base_dir) \
            if sed_el is not None else None
        return GeometricSource(geometry=geom,
                               luminosity=source_luminosity(el, lrange, base_dir),
                               sed=sed,
                               **_bias_kw())
    if t == "FilePolarizedPointSource":
        # (ref: FilePolarizedPointSource.hpp: tabulated Stokes components
        # vs (wavelength, inclination cosine) about a symmetry axis)
        from ..sources.filepolarized import FilePolarizedPointSource
        fn = a["filename"]
        if not os.path.isabs(fn):
            fn = os.path.join(base_dir, fn)
        pos = (_q(a, "positionX", "length", 0.0),
               _q(a, "positionY", "length", 0.0),
               _q(a, "positionZ", "length", 0.0))
        axis = (_f(a, "symmetryX", 0.0), _f(a, "symmetryY", 0.0),
                _f(a, "symmetryZ", 1.0))
        return FilePolarizedPointSource(
            filename=fn, luminosity=source_luminosity(el, lrange, base_dir),
            position=pos,
            symmetry_axis=axis)
    if t == "ParticleSource":
        return ("particle_source", el)  # resolved in load_ski (needs paths
        #                                 and the source wavelength range)
    if t == "CellSource":
        return ("cell_source", el)      # same deferral
    if t in ("VoronoiMeshSource", "AdaptiveMeshSource"):
        return ("mesh_source", el)      # same deferral
    raise NotImplementedError(f"source type '{t}' not supported yet")


def _family_from_columns(ft, fam_el, base_dir, lam_range, d):
    """Shared SED-family resolution for imported sources: returns
    (FamilyTables-ready family, scales, params) from imported columns
    (ref: ImportedSource.hpp:104 sedFamily + SEDFamily parameterInfo)."""
    from ..spectral import named as _named
    from ..spectral import sedfamily as sf
    from ..utils import constants as _c

    _SSP_LIKE = ("BruzualCharlotSEDFamily", "MarastonSEDFamily",
                 "Starburst99SEDFamily", "FSPSSEDFamily", "BpassSEDFamily")
    if ft == "BlackBodySEDFamily":
        lam_grid = np.geomspace(max(lam_range[0] * 0.5, 1e-9),
                                lam_range[1] * 2.0, 600)
        Tgrid = np.geomspace(max(d["T"].min() * 0.9, 1.0),
                             d["T"].max() * 1.1, 48)
        fam = sf.blackbody_family(Tgrid, lam_grid)
        return fam, 4.0 * np.pi * d["R"] ** 2, d["T"][:, None]
    if ft == "FileIndexedSEDFamily":
        sfn = fam_el.attrib["filename"]
        if not os.path.isabs(sfn):
            sfn = os.path.join(base_dir, sfn)
        return sf.load_indexed_family(sfn), d["L"], d["index"][:, None]
    if ft == "FileSSPSEDFamily" or ft in _SSP_LIKE:
        if ft == "FileSSPSEDFamily":
            sfn = fam_el.attrib["filename"]
            if not os.path.isabs(sfn):
                sfn = os.path.join(base_dir, sfn)
            fam = sf.load_ssp_family(sfn)
        else:
            fam = _named.load_named_family(ft, fam_el.attrib)
        return fam, d["Minit"] / sf.M_SUN, \
            np.stack([d["Z"], d["t"] / _c.YEAR], axis=-1)
    raise NotImplementedError(f"SED family '{ft}' for mesh sources")


def _family_cols(ft):
    """Import-column descriptors for a family's parameters (shared with
    _family_from_columns; ref: SEDFamily::parameterInfo column lists)."""
    _SSP_LIKE = ("BruzualCharlotSEDFamily", "MarastonSEDFamily",
                 "Starburst99SEDFamily", "FSPSSEDFamily", "BpassSEDFamily")
    if ft == "BlackBodySEDFamily":
        return [("R", "length", "km"), ("T", "temperature", "K")]
    if ft == "FileIndexedSEDFamily":
        return [("L", "", ""), ("index", "", "")]
    if ft == "FileSSPSEDFamily" or ft in _SSP_LIKE:
        return [("Minit", "mass", "Msun"), ("Z", "", ""),
                ("t", "time", "yr")]
    raise NotImplementedError(f"SED family '{ft}' for mesh sources")


def build_mesh_source(el, base_dir: str, lam_range):
    """VoronoiMeshSource / AdaptiveMeshSource: mesh-snapshot imported
    sources — every mesh cell is an emitting entity with SED-family
    parameters; launch positions are uniform within the (Voronoi / AMR
    leaf) cell via the imported-geometry samplers
    (ref: VoronoiMeshSource.hpp:47, AdaptiveMeshSource.hpp:46)."""
    from ..geometries import imported as ig
    from ..imports import snapshots as snap
    from ..spectral import sedfamily as sf

    t, a = el.tag, el.attrib
    fn = a["filename"]
    if not os.path.isabs(fn):
        fn = os.path.join(base_dir, fn)
    import_v = a.get("importVelocity", "false") == "true"
    fam_el = _child(el, "sedFamily")
    ft = fam_el.tag if fam_el is not None else "BlackBodySEDFamily"
    ext_box = ((_q(a, "minX", "length"), _q(a, "maxX", "length")),
               (_q(a, "minY", "length"), _q(a, "maxY", "length")),
               (_q(a, "minZ", "length"), _q(a, "maxZ", "length")))

    if t == "VoronoiMeshSource":
        cols = [("x", "length", "pc"), ("y", "length", "pc"),
                ("z", "length", "pc")]
        if import_v:
            cols += [("vx", "velocity", "km/s"),
                     ("vy", "velocity", "km/s"),
                     ("vz", "velocity", "km/s")]
        cols += _family_cols(ft)
        d = snap.read_column_file(fn, cols)
        sites = np.stack([d["x"], d["y"], d["z"]], axis=-1)
        sampler = ig.VoronoiMeshGeometry(sites=sites,
                                         mass=np.ones(len(sites)),
                                         extent=ext_box)
    else:  # AdaptiveMeshSource: Morton-order '!' tree file
        from ..grids.amr import build_amr
        grid, leaf = build_amr(fn, ext_box)
        c_ = 0
        d = {}
        if import_v:
            d["vx"], d["vy"], d["vz"] = (leaf[:, c_] * 1e3,
                                         leaf[:, c_ + 1] * 1e3,
                                         leaf[:, c_ + 2] * 1e3)
            c_ += 3
        from ..utils import units as U
        for name, qty, unit in _family_cols(ft):
            factor = U.to_si(qty, 1.0, unit) if unit else 1.0
            d[name] = leaf[:, c_] * factor
            c_ += 1
        sampler = ig.AdaptiveMeshGeometry(grid=grid,
                                          mass=np.ones(grid.ncells))
    fam, scales, params = _family_from_columns(ft, fam_el, base_dir,
                                               lam_range, d)
    vel = (np.stack([d["vx"], d["vy"], d["vz"]], axis=-1)
           if import_v else None)
    tabs = sf.FamilyTables(fam, lam_range=lam_range)
    return snap.EntityFamilySource(sampler=sampler, family_tables=tabs,
                                   scales=scales, params=params,
                                   velocity=vel)


def build_particle_source(el, base_dir: str, lam_range):
    """ParticleSource with an SEDFamily: text columns x y z h [vx vy vz]
    + family parameters (ref: ParticleSource.hpp, ImportedSource.hpp:75-105;
    column order/units per SnapshotParameter defaults — Minit in Msun,
    Z dimensionless, age in yr, BlackBody radius in km, T in K)."""
    from ..imports import snapshots as snap
    from ..spectral import sedfamily as sf

    fn = el.attrib["filename"]
    if not os.path.isabs(fn):
        fn = os.path.join(base_dir, fn)
    import_v = el.attrib.get("importVelocity", "false") == "true"
    fam_el = _child(el, "sedFamily")
    ft = fam_el.tag if fam_el is not None else "BlackBodySEDFamily"
    kern_el = _child(el, "smoothingKernel")
    kernel_kind = (kern_el.tag if kern_el is not None
                   else "CubicSplineSmoothingKernel")

    cols = [("x", "length", "pc"), ("y", "length", "pc"),
            ("z", "length", "pc"), ("h", "length", "pc")]
    if import_v:
        cols += [("vx", "velocity", "km/s"), ("vy", "velocity", "km/s"),
                 ("vz", "velocity", "km/s")]
    from ..spectral import named as _named
    _SSP_LIKE = ("BruzualCharlotSEDFamily", "MarastonSEDFamily",
                 "Starburst99SEDFamily", "FSPSSEDFamily", "BpassSEDFamily")
    if ft == "BlackBodySEDFamily":
        cols += [("R", "length", "km"), ("T", "temperature", "K")]
    elif ft == "FileSSPSEDFamily" or ft in _SSP_LIKE:
        cols += [("Minit", "mass", "Msun"), ("Z", "", ""),
                 ("t", "time", "yr")]
    elif ft == "FileIndexedSEDFamily":
        cols += [("L", "", ""), ("index", "", "")]
    elif ft == "MappingsSEDFamily":
        # SFR scale + (Z, logC, P, fPDR) (ref: MappingsSEDFamily
        # parameterInfo: SFR in Msun/yr, pressure in Pa)
        cols += [("SFR", "mass", "Msun"), ("Z", "", ""), ("logC", "", ""),
                 ("P", "pressure", "Pa"), ("fPDR", "", "")]
    elif ft == "CastelliKuruczSEDFamily":
        cols += [("R", "length", "km"), ("Z", "", ""),
                 ("Teff", "temperature", "K"), ("g", "", "")]
    elif ft == "ToddlersSEDFamily":
        cols += [("SFR", "mass", "Msun"), ("t", "time", "yr")]
    else:
        raise NotImplementedError(f"SED family '{ft}' not supported yet")
    d = snap.read_column_file(fn, cols)

    n = len(d["x"])
    pos = np.stack([d["x"], d["y"], d["z"]], axis=-1)
    vel = (np.stack([d["vx"], d["vy"], d["vz"]], axis=-1)
           if import_v else None)
    ps = snap.ParticleSnapshot(positions=pos, h=d["h"],
                               mass=np.ones(n), velocity=vel)

    if ft == "BlackBodySEDFamily":
        lam_grid = np.geomspace(max(lam_range[0] * 0.5, 1e-9),
                                lam_range[1] * 2.0, 600)
        Tgrid = np.geomspace(max(d["T"].min() * 0.9, 1.0),
                             d["T"].max() * 1.1, 48)
        fam = sf.blackbody_family(Tgrid, lam_grid)
        scales = 4.0 * np.pi * d["R"] ** 2  # area scale: L = 4 pi^2 R^2 B
        params = d["T"][:, None]
    elif ft == "FileSSPSEDFamily":
        sfn = fam_el.attrib["filename"]
        if not os.path.isabs(sfn):
            sfn = os.path.join(base_dir, sfn)
        fam = sf.load_ssp_family(sfn)
        # the stored table is per Msun of initial mass with the age axis in
        # years; the column import converts to SI, so scale back exactly
        # like the reference does (ref: FileSSPSEDFamily.cpp:44-47
        # parameters[0]/Msun, parameters[2]/year)
        from ..utils import constants as _c
        scales = d["Minit"] / sf.M_SUN
        params = np.stack([d["Z"], d["t"] / _c.YEAR], axis=-1)
    elif ft == "FileIndexedSEDFamily":
        sfn = fam_el.attrib["filename"]
        if not os.path.isabs(sfn):
            sfn = os.path.join(base_dir, sfn)
        fam = sf.load_indexed_family(sfn)
        scales = d["L"]
        params = d["index"][:, None]
    elif ft in _SSP_LIKE:
        from ..utils import constants as _c
        fam = _named.load_named_family(ft, fam_el.attrib)
        scales = d["Minit"] / sf.M_SUN
        params = np.stack([d["Z"], d["t"] / _c.YEAR], axis=-1)
    elif ft == "MappingsSEDFamily":
        fam = _named.load_named_family(ft, fam_el.attrib)
        # the SFR column imports through the mass converter (kg); dividing
        # by Msun restores the raw Msun/yr value the table is scaled by
        scales = d["SFR"] / sf.M_SUN
        params = np.stack([d["Z"], d["logC"], d["P"], d["fPDR"]], axis=-1)
    elif ft == "CastelliKuruczSEDFamily":
        fam = _named.load_named_family(ft, fam_el.attrib)
        scales = 4.0 * np.pi * d["R"] ** 2
        TT, gg_ = d["Teff"].copy(), d["g"].copy()
        for i in range(len(TT)):
            TT[i], gg_[i] = _named._ck_clamp(TT[i], gg_[i])
        params = np.stack([d["Z"], TT, gg_], axis=-1)
    else:  # ToddlersSEDFamily
        from ..utils import constants as _c
        fam = _named.load_named_family(ft, fam_el.attrib)
        scales = d["SFR"] / sf.M_SUN
        params = (d["t"] / _c.YEAR)[:, None]

    tabs = sf.FamilyTables(fam, lam_range=lam_range)
    return snap.FamilyParticleSource(snapshot=ps, family_tables=tabs,
                                     scales=scales, params=params,
                                     kernel_kind=kernel_kind)


def build_cell_source(el, base_dir: str, lam_range):
    """CellSource: axis-aligned box cells carrying an SEDFamily — uniform
    in-cell launch positions (ref: CellSource + ImportedSource.hpp:70).
    Columns: xmin ymin zmin xmax ymax zmax [vx vy vz] + family params."""
    from ..imports import snapshots as snap
    from ..spectral import named as _named
    from ..spectral import sedfamily as sf
    from ..utils import constants as _c

    fn = el.attrib["filename"]
    if not os.path.isabs(fn):
        fn = os.path.join(base_dir, fn)
    import_v = el.attrib.get("importVelocity", "false") == "true"
    fam_el = _child(el, "sedFamily")
    ft = fam_el.tag if fam_el is not None else "BlackBodySEDFamily"
    cols = [("xmin", "length", "pc"), ("ymin", "length", "pc"),
            ("zmin", "length", "pc"), ("xmax", "length", "pc"),
            ("ymax", "length", "pc"), ("zmax", "length", "pc")]
    if import_v:
        cols += [("vx", "velocity", "km/s"), ("vy", "velocity", "km/s"),
                 ("vz", "velocity", "km/s")]
    _SSP_LIKE = ("BruzualCharlotSEDFamily", "MarastonSEDFamily",
                 "Starburst99SEDFamily", "FSPSSEDFamily", "BpassSEDFamily")
    if ft == "BlackBodySEDFamily":
        cols += [("R", "length", "km"), ("T", "temperature", "K")]
    elif ft == "FileSSPSEDFamily" or ft in _SSP_LIKE:
        cols += [("Minit", "mass", "Msun"), ("Z", "", ""),
                 ("t", "time", "yr")]
    elif ft == "FileIndexedSEDFamily":
        cols += [("L", "", ""), ("index", "", "")]
    else:
        raise NotImplementedError(f"SED family '{ft}' for CellSource")
    d = snap.read_column_file(fn, cols)
    if ft == "BlackBodySEDFamily":
        lam_grid = np.geomspace(max(lam_range[0] * 0.5, 1e-9),
                                lam_range[1] * 2.0, 600)
        Tgrid = np.geomspace(max(d["T"].min() * 0.9, 1.0),
                             d["T"].max() * 1.1, 48)
        fam = sf.blackbody_family(Tgrid, lam_grid)
        scales = 4.0 * np.pi * d["R"] ** 2
        params = d["T"][:, None]
    elif ft == "FileIndexedSEDFamily":
        sfn = fam_el.attrib["filename"]
        if not os.path.isabs(sfn):
            sfn = os.path.join(base_dir, sfn)
        fam = sf.load_indexed_family(sfn)
        scales = d["L"]
        params = d["index"][:, None]
    else:
        if ft == "FileSSPSEDFamily":
            sfn = fam_el.attrib["filename"]
            if not os.path.isabs(sfn):
                sfn = os.path.join(base_dir, sfn)
            fam = sf.load_ssp_family(sfn)
        else:
            fam = _named.load_named_family(ft, fam_el.attrib)
        scales = d["Minit"] / sf.M_SUN
        params = np.stack([d["Z"], d["t"] / _c.YEAR], axis=-1)
    lo_b = np.stack([d["xmin"], d["ymin"], d["zmin"]], axis=-1)
    hi_b = np.stack([d["xmax"], d["ymax"], d["zmax"]], axis=-1)
    vel = (np.stack([d["vx"], d["vy"], d["vz"]], axis=-1)
           if import_v else None)
    tabs = sf.FamilyTables(fam, lam_range=lam_range)
    return snap.CellFamilySource(lo=lo_b, hi=hi_b, family_tables=tabs,
                                 scales=scales, params=params,
                                 velocity=vel)


# --------------------------------------------------------------------- mixes

def build_mix(el, base_dir: str = ".") -> mx.MixTables:
    t = el.tag
    if t == "TrivialGasMix":
        a = el.attrib
        sabs = _q(a, "absorptionCrossSection", "section")
        ssca = _q(a, "scatteringCrossSection", "section")
        g = _f(a, "asymmetryParameter", 0.0)
        sext = sabs + ssca
        lam = np.array([1e-8, 1e-3])
        return mx.tabulated(lam, [sext, sext],
                            [ssca / sext, ssca / sext], [g, g])
    if t == "MeanIvezicBenchmarkDustMix":
        return mx.mean_ivezic_benchmark()
    if t in ("MeanPascucciBenchmarkDustMix", "MeanPinteBenchmarkDustMix",
             "MeanTrustBenchmarkDustMix"):
        # resource-backed mean benchmark mixes (ref: SingleGrainDustMix
        # stored tables lambda(m) -> sigmaabs/sigmasca/g); requires the
        # resource pack on SKIRT9_TPU_RESOURCES
        return mx.mean_from_resource(
            t.replace("DustMix", "OpticalProps"))
    if t == "MeanInterstellarDustMix":
        return mx.mean_interstellar_approx()
    if t == "ElectronMix":
        emix = mx.electron_mix()
        if el.attrib.get("includePolarization", "false") == "true":
            # Thomson scattering has an exact analytic Mueller matrix
            # (ref: ElectronMix.hpp:60 includePolarization,
            # DipolePhaseFunction.cpp applyMueller)
            from ..ops import stokes as stk
            object.__setattr__(emix, "_mueller", stk.electron_mueller())
        return emix
    if t == "LyaNeutralHydrogenGasMix":
        # Lyman-alpha resonant scattering by neutral hydrogen: the opacity
        # is computed on the fly per (wavelength, cell temperature) from
        # the Voigt profile (ops/lya), NOT from static mix tables, so this
        # returns a zero-opacity marker mix carrying the configuration
        # (ref: LyaNeutralHydrogenGasMix.hpp:16-47)
        a = el.attrib
        lam = np.array([1e-8, 1e-3])
        m_ = mx.MixTables(lam=lam, sigma_ext=np.zeros(2),
                          albedo=np.zeros(2), g=np.zeros(2),
                          mu=1.67262e-27 + 9.10938e-31)  # m_p + m_e
        object.__setattr__(m_, "_lya", {
            "T_default": _q(a, "defaultTemperature", "temperature", 1e4),
            "polarization": a.get("includePolarization",
                                  "false") == "true"})
        return m_
    if t == "XRayAtomicGasMix":
        # X-ray photo-absorption + electron scattering gas
        # (ref: XRayAtomicGasMix.hpp:288; built-in Verner H+He fits, full
        # 30-element data via user-supplied XRay_PA/FL tables)
        from ..media import xray as xr
        a = el.attrib
        ab = None
        if a.get("abundancies"):
            ab = np.array([float(v) for v in
                           a["abundancies"].replace(",", " ").split()])
        lam = np.geomspace(2e-11, 5e-7, 512)  # ~60 keV .. 2.5 eV
        scatter = {"None": "None", "Free": "Free",
                   "FreeWithPolarization": "Free",
                   "Good": "Free", "Exact": "Free"}.get(
                       a.get("scatterBoundElectrons", "Good"), "Free")
        # full-element Verner fits + fluorescence yields load from
        # XRay_PA.txt / XRay_FL.txt next to the ski when present (the
        # reference reads the same layouts from its resource packs);
        # built-ins are Verner H+He plus the approximate Fe K model
        import os as _os
        shells = list(xr.BUILTIN_SHELLS) + [xr.FE_K_SHELL]
        lines = list(xr.FE_K_LINES)
        pa = _os.path.join(base_dir, "XRay_PA.txt")
        fl = _os.path.join(base_dir, "XRay_FL.txt")
        if _os.path.exists(pa):
            shells = xr.load_pa_file(pa)
        if _os.path.exists(fl):
            lines = xr.load_fl_file(fl)
        tabs = xr.build_xray_tables(lam, abundances=ab, scatter=scatter,
                                    shells=shells, lines=lines)
        return xr.as_mix_tables(tabs)
    if t == "MeanFileDustMix":
        # input files resolve relative to the ski file's directory
        # (ref: FilePaths input path handling)
        import os as _os
        fn = el.attrib["filename"]
        if not _os.path.isabs(fn):
            fn = _os.path.join(base_dir, fn)
        return mx.from_file(fn)
    if t in ("MRNDustMix", "DraineLiDustMix", "ZubkoDustMix",
             "WeingartnerDraineDustMix", "ThemisDustMix",
             "ConfigurableDustMix"):
        # multi-grain mixes: size-distribution x composition integration
        # (ref: MultiGrainDustMix.hpp:108); the per-size-bin emission data is
        # kept on the MixTables via the `multigrain` attribute for the
        # stochastic calculator
        from ..media import grains as gr
        nb = int(_f(el.attrib, "numSilicateSizes", 6))
        if t == "MRNDustMix":
            mg = gr.mrn_mix(nb)
        elif t == "DraineLiDustMix":
            mg = gr.draine_li_mix(nb)
        elif t == "ZubkoDustMix":
            mg = gr.zubko_mix(nb)
        elif t == "WeingartnerDraineDustMix":
            mg = gr.weingartner_draine_mix(nb)
        elif t == "ThemisDustMix":
            mg = gr.themis_mix(nb)
        else:  # ConfigurableDustMix: explicit GrainPopulation children
            pops = []
            polarized = []
            spheroidal_specs = []
            for p_el in el.iter("GrainPopulation"):
                comp_el = _child(p_el, "composition")
                # exact resource tables when the named composition's
                # resources are installed; approximate Mie otherwise
                # (ref: GrainComposition resource tables)
                comp = None
                if comp_el is not None and \
                        comp_el.tag in gr.NAMED_COMPOSITIONS:
                    from ..utils.filepaths import has_resource
                    opt_name = gr.NAMED_COMPOSITIONS[comp_el.tag][0]
                    if has_resource(opt_name + ".stab"):
                        comp = gr.composition_from_resource(comp_el.tag)
                if comp is None:
                    comp = (gr.graphite_composition()
                            if comp_el is not None
                            and "Graphite" in comp_el.tag
                            else gr.silicate_composition())
                if comp_el is not None and ("Polarized" in comp_el.tag
                                            or "Spheroidal" in comp_el.tag):
                    # Polarized{Silicate,Graphite}GrainComposition select
                    # the SphericalPolarization scattering mode; the
                    # Mueller tables come from our Mie pipeline instead of
                    # resource packs (ref: DustMix.hpp:319). Spheroidal
                    # compositions derive from the polarized ones
                    # (scattering stays spherical,
                    # SpheroidalSilicateGrainComposition.hpp)
                    polarized.append(gr.nk_graphite_approx
                                     if "Graphite" in comp_el.tag
                                     else gr.nk_silicate_approx)
                spec = None
                if comp_el is not None and "Spheroidal" in comp_el.tag:
                    # aligned-grain polarized EMISSION tables
                    # (ref: GrainComposition::resourcesForSpheroidalEmission)
                    spec = _spheroidal_spec(comp_el, base_dir)
                spheroidal_specs.append(spec)
                sd_el = _child(p_el, "sizeDistribution")
                a = sd_el.attrib if sd_el is not None else {}
                amin = _q(a, "minSize", "grainsize") if "minSize" in a else 5e-9
                amax = _q(a, "maxSize", "grainsize") if "maxSize" in a else 250e-9
                if sd_el is not None and "ZubkoSilicate" in sd_el.tag:
                    sd = gr.zubko_silicate_sizes()
                elif sd_el is not None and "ZubkoGraphite" in sd_el.tag:
                    sd = gr.zubko_graphite_sizes()
                elif sd_el is not None and "ZubkoPAH" in sd_el.tag:
                    sd = gr.zubko_pah_sizes()
                elif sd_el is not None and "SingleGrainSize" in sd_el.tag:
                    sd = gr.single_size(_q(a, "size", "grainsize")
                                        if "size" in a else 100e-9)
                elif sd_el is not None and "Hirashita" in sd_el.tag:
                    sd = gr.hirashita_log_normal_sizes()
                elif sd_el is not None and "ModifiedLogNormal" in sd_el.tag:
                    sd = gr.modified_log_normal_sizes(
                        amin, amax,
                        _q(a, "centroid", "grainsize")
                        if "centroid" in a else 100e-9,
                        _f(a, "width", 0.4))
                elif sd_el is not None and "LogNormal" in sd_el.tag:
                    sd = gr.log_normal_sizes(amin, amax,
                                             _q(a, "centroid", "grainsize")
                                             if "centroid" in a else 100e-9,
                                             _f(a, "width", 0.4))
                elif sd_el is not None and "ModifiedPowerLaw" in sd_el.tag:
                    sd = gr.modified_power_law_sizes(amin, amax)
                else:
                    # ref stores a positive exponent: dn/da ~ a^-exponent
                    # (PowerLawGrainSizeDistribution, default 3.5)
                    sd = gr.power_law_sizes(amin, amax,
                                            _f(a, "exponent", 3.5))
                nbins = int(_f(p_el.attrib, "numSizes", 6))
                mass = _q(p_el.attrib, "dustMassPerHydrogenAtom", "mass") \
                    if "dustMassPerHydrogenAtom" in p_el.attrib else 1e-29
                pops.append(gr.GrainPopulation(comp, sd, nbins, mass))
                if (comp_el is not None and ("Polarized" in comp_el.tag
                                             or "Spheroidal" in comp_el.tag)):
                    polarized[-1] = (polarized[-1], sd)
            mg = gr.build_multi_grain(pops)
            if polarized:
                lam0 = 0.55e-6
                mt = gr.mie_mueller([p for p in polarized
                                     if isinstance(p, tuple)], lam0)
                object.__setattr__(mg.mix, "_mueller", mt)
            if any(s is not None for s in spheroidal_specs):
                se = gr.build_spheroidal_emission(pops, spheroidal_specs)
                object.__setattr__(mg.mix, "_spheroidal", se)
        # MixTables is a frozen (but slot-less) dataclass; carry the
        # size-bin payload for the stochastic calculator on the object
        # itself so its lifetime is tied to the mix (no global cache)
        object.__setattr__(mg.mix, "_multigrain", mg)
        return mg.mix
    if t == "DiffuseIonizedGasMix":
        # photoionized-gas mechanism mix (ref: DiffuseIonizedGasMix.hpp:153):
        # temperature/opacity come from stab lookups + an inline ionization
        # balance driven by the stored radiation field (media/dig.py). The
        # Cloudy stab packs are resource-blocked; temperatureTableFilename
        # stands in with a (logU, T) text table. The mix itself carries no
        # static opacity — the recipe updates the effective density.
        a = el.attrib
        lam = np.array([1e-8, 1e-3])
        m_ = mx.MixTables(lam=lam, sigma_ext=np.zeros(2),
                          albedo=np.zeros(2), g=np.zeros(2),
                          mu=1.67262192e-27)
        tfn = a.get("temperatureTableFilename", "")
        if tfn and not os.path.isabs(tfn):
            tfn = os.path.join(base_dir, tfn)
        object.__setattr__(m_, "_dig", {
            "Z": _f(a, "defaultMetallicity", 0.02),
            "T_default": _q(a, "defaultTemperature", "temperature", 1e4),
            "use_cloudy_T": a.get("useCloudyTemperature", "true") == "true",
            "max_change": _f(a, "maxChangeInIonization", 0.01),
            "max_frac": _f(a, "maxFractionNotConvergedCells", 0.1),
            "max_nH": _f(a, "maxHydrogenDensity", 1e5) * 1e6,  # cm^-3->m^-3
            "T_table": tfn,
        })
        return m_
    raise NotImplementedError(f"material mix '{t}' not supported yet")


def _spheroidal_spec(comp_el, base_dir):
    """SpheroidalEmissionSpec from a Spheroidal*GrainComposition element
    (ref: SpheroidalSilicateGrainComposition.hpp tableType enum:
    Builtin resource tables / OneTable / TwoTables with alignment
    interpolation)."""
    import os as _os

    from ..media import grains as gr

    a = comp_el.attrib
    tt = a.get("tableType", "Builtin")
    frac = float(a.get("alignmentFraction", "1."))

    def _resolve(fn):
        if not _os.path.isabs(fn):
            fn = _os.path.join(base_dir, fn)
        return fn

    if tt == "OneTable":
        return gr.SpheroidalEmissionSpec(
            table1=_resolve(a["emissionTable"]), fraction=0.0)
    if tt == "TwoTables":
        return gr.SpheroidalEmissionSpec(
            table1=_resolve(a["nonAlignedEmissionTable"]),
            table2=_resolve(a["alignedEmissionTable"]),
            fraction=frac)
    # Builtin: reference resource tables (require an installed resource
    # pack, utils/filepaths); graphite ships only the non-aligned table
    # (ref: SpheroidalGraphiteGrainComposition.cpp:26)
    from ..utils.filepaths import find_resource
    kind = "Graphite" if "Graphite" in comp_el.tag else "Silicate"
    t1 = find_resource(f"Spheroidal{kind}NonAlignedEmissionOpticalProps.stab")
    if kind == "Silicate":
        t2 = find_resource("SpheroidalSilicateAlignedEmissionOpticalProps"
                           ".stab")
        return gr.SpheroidalEmissionSpec(table1=t1, table2=t2, fraction=frac)
    return gr.SpheroidalEmissionSpec(table1=t1, fraction=0.0)


def multigrain_for(mix) -> "object | None":
    return getattr(mix, "_multigrain", None)


def build_vector_field(el):
    """Build a VectorField item (ref: VectorField.hpp:25 and concrete
    classes); evaluated host-side at cell centers during setup."""
    from ..geometries import vectorfield as vf
    t = el.tag
    a = el.attrib
    if t == "RadialVectorField":
        return vf.RadialVectorField(
            unity_radius=_q(a, "unityRadius", "length", 0.0),
            exponent=_f(a, "exponent", 1.0))
    if t == "CylindricalVectorField":
        return vf.CylindricalVectorField(
            unity_radius=_q(a, "unityRadius", "length", 0.0),
            exponent=_f(a, "exponent", 1.0))
    if t == "HollowRadialVectorField":
        return vf.HollowRadialVectorField(
            zero_radius=_q(a, "zeroRadius", "length", 0.0),
            exponent=_f(a, "exponent", 0.0))
    if t == "HubbleRadialVectorField":
        return vf.HubbleRadialVectorField(
            turnover_radius=_q(a, "turnoverRadius", "length"),
            max_radius=_q(a, "maxRadius", "length"))
    if t == "UnidirectionalVectorField":
        return vf.UnidirectionalVectorField(
            direction=(_f(a, "fieldX", 0.0), _f(a, "fieldY", 0.0),
                       _f(a, "fieldZ", 1.0)))
    if t == "RotateVectorFieldDecorator":
        return vf.RotateVectorFieldDecorator(
            child=build_vector_field(_child(el, "vectorField")),
            alpha=_q(a, "eulerAlpha", "angle", 0.0),
            beta=_q(a, "eulerBeta", "angle", 0.0),
            gamma=_q(a, "eulerGamma", "angle", 0.0))
    if t == "OffsetVectorFieldDecorator":
        return vf.OffsetVectorFieldDecorator(
            child=build_vector_field(_child(el, "vectorField")),
            offset=(_q(a, "offsetX", "length", 0.0),
                    _q(a, "offsetY", "length", 0.0),
                    _q(a, "offsetZ", "length", 0.0)))
    raise NotImplementedError(f"vector field '{t}' not supported yet")


def build_medium_normalization(el, geom, mix):
    norm = _child(el, "normalization")
    if norm is None:
        raise ValueError("medium needs a normalization")
    a = norm.attrib
    if norm.tag == "OpticalDepthMaterialNormalization":
        return gm.OpticalDepthNormalization(
            tau=_f(a, "opticalDepth"),
            lam=_q(a, "wavelength", "wavelength"),
            axis={"X": "x", "Y": "y", "Z": "z"}.get(a.get("axis", "Z"), "z"))
    if norm.tag == "MassMaterialNormalization":
        return gm.MassNormalization(mass=_q(a, "mass", "mass"))
    if norm.tag == "NumberMaterialNormalization":
        return gm.NumberNormalization(number=_f(a, "number"))
    ax = {"X": "x", "Y": "y", "Z": "z"}.get(a.get("axis", "Z"), "z")
    if norm.tag == "NumberColumnMaterialNormalization":
        return gm.NumberColumnNormalization(
            column=U.parse("numbersurfacedensity",
                           a["numberColumnDensity"]),
            axis=ax)
    if norm.tag == "MassColumnMaterialNormalization":
        return gm.MassColumnNormalization(
            column=U.parse("masssurfacedensity", a["massColumnDensity"]),
            axis=ax)
    raise NotImplementedError(f"normalization '{norm.tag}' not supported yet")


# --------------------------------------------------------------------- grids

def build_grid(el, base_dir: str = "."):
    from ..grids import meshes as msh
    t = el.tag
    a = el.attrib

    def _mesh(name, default=16):
        """(numBins, normalized borders or None-if-linear) for a mesh
        child (ref: Mesh family, NR.hpp:221-320 grid builders)."""
        m = _child(el, name)
        if m is None:
            return default, None
        n = int(m.attrib.get("numBins", default))
        if m.tag == "LinMesh":
            return n, None
        return n, msh.from_ski(m, base_dir, default_bins=default)

    if t == "CartesianSpatialGrid":
        ext = ((_q(a, "minX", "length"), _q(a, "maxX", "length")),
               (_q(a, "minY", "length"), _q(a, "maxY", "length")),
               (_q(a, "minZ", "length"), _q(a, "maxZ", "length")))
        ns, borders = [], []
        for ax, mesh_name in enumerate(("meshX", "meshY", "meshZ")):
            n, b = _mesh(mesh_name, 32)
            ns.append(n)
            borders.append(msh.scale(b, *ext[ax]) if b is not None else None)
        if any(b is not None for b in borders):
            return make_cartesian(ext, tuple(ns), meshes=borders)
        return make_cartesian(ext, tuple(ns))
    if t == "PolicyTreeSpatialGrid":
        ext = ((_q(a, "minX", "length"), _q(a, "maxX", "length")),
               (_q(a, "minY", "length"), _q(a, "maxY", "length")),
               (_q(a, "minZ", "length"), _q(a, "maxZ", "length")))
        pol = _child(el, "policy")
        pa = pol.attrib if pol is not None else {}
        tree_type = a.get("treeType", "OctTree")
        # level numbers in the ski count OCTREE levels; bintree levels
        # count single-axis splits (ref: BinTreeNode.hpp — 3 bintree
        # levels == 1 octree level)
        mul = 3 if tree_type == "BinTree" else 1
        spec = {"kind": tree_type, "ext": ext,
                "min_level": int(pa.get("minLevel", 2)) * mul,
                "max_level": int(pa.get("maxLevel", 6)) * mul,
                "policy": (pol.tag if pol is not None
                           else "DensityTreePolicy"),
                "max_fraction": float(pa.get("maxDustFraction", 1e-6))}
        if pol is not None and pol.tag == "NestedDensityTreePolicy":
            # an inner box refined by a second, typically stricter policy
            # (ref: NestedDensityTreePolicy.hpp)
            inner = _child(pol, "innerPolicy")
            ia_ = inner.attrib if inner is not None else {}
            spec["inner"] = {
                "lo": (_q(pa, "minXInner", "length"),
                       _q(pa, "minYInner", "length"),
                       _q(pa, "minZInner", "length")),
                "hi": (_q(pa, "maxXInner", "length"),
                       _q(pa, "maxYInner", "length"),
                       _q(pa, "maxZInner", "length")),
                "max_level": int(ia_.get("maxLevel", 8)) * mul,
                "max_fraction": float(ia_.get("maxDustFraction", 1e-6)),
            }
        if pol is not None and pol.tag == "SiteListTreePolicy":
            spec["max_fraction"] = None  # sites drive refinement
        return ("tree", spec)

    def _scaled(name, default, lo, hi):
        n, b = _mesh(name, default)
        return n, (msh.scale(b, lo, hi) if b is not None else None)

    if t == "Sphere1DSpatialGrid":
        from ..grids.sphere import make_sphere1d
        r_min = _q(a, "minRadius", "length") if "minRadius" in a else 0.0
        r_max = _q(a, "maxRadius", "length")
        nr, rb = _scaled("meshRadial", 32, r_min, r_max)
        return make_sphere1d(r_max, nr, r_min=r_min, rb=rb)
    if t == "Sphere2DSpatialGrid":
        from ..grids.polar import make_sphere2d
        r_max = _q(a, "maxRadius", "length")
        nr, rb = _scaled("meshRadial", 32, 0.0, r_max)
        nt, tb = _scaled("meshPolar", 16, 0.0, np.pi)
        return make_sphere2d(r_max, nr, nt, rb=rb, tb=tb)
    if t == "Sphere3DSpatialGrid":
        from ..grids.polar import make_sphere3d
        r_max = _q(a, "maxRadius", "length")
        nr, rb = _scaled("meshRadial", 32, 0.0, r_max)
        nt, tb = _scaled("meshPolar", 16, 0.0, np.pi)
        return make_sphere3d(r_max, nr, nt,
                             _mesh("meshAzimuthal", 16)[0], rb=rb, tb=tb)
    if t == "ClumpySphericalSpatialGrid":
        # specialty grid: structured sphere + imported clump spheres
        # (ref: ClumpySphericalSpatialGrid.hpp:67; clump file columns
        # x y z radius in pc, extra columns ignored)
        from ..grids.clumpy import make_clumpy_spherical
        r_min = _q(a, "minRadius", "length") if "minRadius" in a else 0.0
        r_max = _q(a, "maxRadius", "length")
        nr, rb = _scaled("meshRadial", 32, r_min, r_max)
        nt, tb = _scaled("meshPolar", 16, 0.0, np.pi)
        nphi = _mesh("meshAzimuthal", 16)[0]
        fn = a["filename"]
        if not os.path.isabs(fn):
            fn = os.path.join(base_dir, fn)
        PC = 3.0857e16
        d = np.loadtxt(fn, ndmin=2)
        return make_clumpy_spherical(
            r_max, nr, nt, nphi, d[:, :3] * PC, d[:, 3] * PC,
            r_min=r_min, rb=rb, tb=tb)
    if t == "Cylinder2DSpatialGrid":
        from ..grids.cylinder import make_cylinder2d
        r_max = _q(a, "maxRadius", "length")
        z_min, z_max = _q(a, "minZ", "length"), _q(a, "maxZ", "length")
        nr, rb = _scaled("meshRadial", 32, 0.0, r_max)
        nz, zb = _scaled("meshZ", 32, z_min, z_max)
        return make_cylinder2d(r_max, z_min, z_max, nr, nz, rb=rb, zb=zb)
    if t == "Cylinder3DSpatialGrid":
        from ..grids.polar import make_cylinder3d
        r_max = _q(a, "maxRadius", "length")
        z_min, z_max = _q(a, "minZ", "length"), _q(a, "maxZ", "length")
        nr, rb = _scaled("meshRadial", 32, 0.0, r_max)
        nz, zb = _scaled("meshZ", 32, z_min, z_max)
        return make_cylinder3d(r_max, z_min, z_max, nr,
                               _mesh("meshAzimuthal", 16)[0], nz,
                               rb=rb, zb=zb)
    if t in ("VoronoiMeshSpatialGrid", "TetraMeshSpatialGrid"):
        # standalone unstructured grids: site policy + optional Lloyd
        # relaxation resolve in load_ski (they need the medium geometry
        # for density-sampled sites); ImportedMesh resolves through the
        # VoronoiMeshMedium path (ref: VoronoiMeshSpatialGrid.hpp:26)
        ext = ((_q(a, "minX", "length"), _q(a, "maxX", "length")),
               (_q(a, "minY", "length"), _q(a, "maxY", "length")),
               (_q(a, "minZ", "length"), _q(a, "maxZ", "length")))
        return ("voronoi", dict(
            ext=ext, n=int(_f(a, "numSites", 500)),
            policy=a.get("policy", "DustDensity"),
            relax=a.get("relaxSites", "false") == "true",
            kind="tetra" if t.startswith("Tetra") else "voronoi"))
    raise NotImplementedError(f"spatial grid '{t}' not supported yet")


# --------------------------------------------------------------- instruments

def build_wavelength_grid(el) -> np.ndarray:
    t = el.tag
    a = el.attrib
    if t == "LogWavelengthGrid":
        return wl.log_borders_skirt(_q(a, "minWavelength", "wavelength"),
                                    _q(a, "maxWavelength", "wavelength"),
                                    int(a["numWavelengths"]))
    if t == "LinWavelengthGrid":
        return wl.lin_borders_skirt(_q(a, "minWavelength", "wavelength"),
                                    _q(a, "maxWavelength", "wavelength"),
                                    int(a["numWavelengths"]))
    if t == "ListWavelengthGrid":
        lams = U.parse_list("wavelength", a["wavelengths"])
        return wl.oligo_borders(lams)
    if t == "LogBorderWavelengthGrid":
        # borders themselves log-spaced (ref: LogBorderWavelengthGrid)
        return np.geomspace(_q(a, "minWavelength", "wavelength"),
                            _q(a, "maxWavelength", "wavelength"),
                            int(_f(a, "numWavelengthBins", 25)) + 1)
    if t == "ResolutionBorderWavelengthGrid":
        # constant spectral resolution R = lam/dlam
        # (ref: ResolutionBorderWavelengthGrid)
        lo = _q(a, "minWavelength", "wavelength")
        hi = _q(a, "maxWavelength", "wavelength")
        R = _f(a, "resolution", 10.0)
        borders = [lo]
        while borders[-1] < hi:
            borders.append(borders[-1] * (1.0 + 1.0 / R))
        return np.asarray(borders)
    if t == "CompositeWavelengthGrid":
        # reference compositing semantics (ref: CompositeWavelengthGrid.cpp
        # SegmentedGrid::add): children composite IN ORDER, later children's
        # bins REPLACING any earlier bins they overlap; earlier bins only
        # partially overlapped are truncated at the newcomer's range edges.
        # Our wavelength grids are live-border lists (no dead segments), so
        # disjoint children that would leave a zero-transmission gap between
        # bins are rejected instead of silently bridged.
        kids = _child_list(el, "wavelengthGrids")
        segs: list[tuple[float, float]] = []    # disjoint live bins, sorted
        for k in kids:
            b = np.asarray(build_wavelength_grid(k), np.float64)
            lo, hi = float(b[0]), float(b[-1])
            kept = []
            for (l, r) in segs:
                if r <= lo * (1 + 1e-9) and l < lo:
                    kept.append((l, min(r, lo)))
                elif l >= hi * (1 - 1e-9) and r > hi:
                    kept.append((max(l, hi), r))
                else:
                    if l < lo * (1 - 1e-9):
                        kept.append((l, lo))
                    if r > hi * (1 + 1e-9):
                        kept.append((hi, r))
            kept.extend(zip(b[:-1], b[1:]))
            segs = sorted(kept)
        borders = [segs[0][0]]
        for (l, r) in segs:
            if l > borders[-1] * (1 + 1e-9):
                raise NotImplementedError(
                    "CompositeWavelengthGrid: child grids leave a dead "
                    f"(zero-transmission) gap [{borders[-1]:.6g}, {l:.6g}] m; "
                    "gapped composite grids are not supported — add a child "
                    "covering the gap")
            borders.append(float(r))
        return np.asarray(borders)
    raise NotImplementedError(f"wavelength grid '{t}' not supported yet")


def _child_list(el, tag):
    c = el.find(tag)
    return list(c) if c is not None else []


def build_band_grid(el, base_dir: str = "."):
    """Band wavelength grids -> tuple of Bands, or None when `el` is not a
    band grid (ref: PredefinedBandWavelengthGrid.cpp:15-50 band sets,
    ConfigurableBandWavelengthGrid with BroadBand/FileBand/ListBand
    children; BroadBand curves come from the *_BroadBand.stab resources)."""
    from ..spectral import bands as bnd
    from ..spectral import named as _named

    t = el.tag
    a = el.attrib
    if t == "PredefinedBandWavelengthGrid":
        names = []
        if a.get("includeGALEX", "true") == "true":
            names += ["GALEX FUV", "GALEX NUV"]
        if a.get("includeSDSS", "true") == "true":
            names += [f"SDSS {b}" for b in "ugriz"]
        if a.get("include2MASS", "true") == "true":
            names += ["2MASS J", "2MASS H", "2MASS Ks"]
        if a.get("includeWISE", "true") == "true":
            names += [f"WISE W{i}" for i in (1, 2, 3, 4)]
        if a.get("includeHERSCHEL", "true") == "true":
            names += ["PACS 70", "PACS 100", "PACS 160",
                      "SPIRE 250", "SPIRE 350", "SPIRE 500"]
        return tuple(_named.broad_band(n) for n in names)
    if t == "ConfigurableBandWavelengthGrid":
        bands = []
        blist = _child(el, "bands")
        for b_el in (list(blist) if blist is not None else []):
            ba = b_el.attrib
            if b_el.tag == "BroadBand":
                bands.append(_named.broad_band(ba["bandName"]))
            elif b_el.tag == "FileBand":
                fn = ba["filename"]
                if not os.path.isabs(fn):
                    fn = os.path.join(base_dir, fn)
                bands.append(bnd.file_band(ba.get("bandName", fn), fn))
            elif b_el.tag == "ListBand":
                lams = U.parse_list("wavelength", ba["wavelengths"])
                trans = [float(x) for x in
                         ba["transmissionValues"].split(",")]
                bands.append(bnd.list_band("list", lams, trans))
            else:
                raise NotImplementedError(f"band '{b_el.tag}'")
        return tuple(bands)
    return None


def build_instrument(el, default_wlg, base_dir: str = "."):
    t = el.tag
    a = el.attrib
    wlg_el = _child(el, "wavelengthGrid")
    bands = (build_band_grid(wlg_el, base_dir)
             if wlg_el is not None else None)
    if bands:
        # band mode: detection convolves packets into every band; the
        # border array spans the bands for bookkeeping
        lo = min(float(b.lam[0]) for b in bands)
        hi = max(float(b.lam[-1]) for b in bands)
        borders = np.array([lo, hi])
    else:
        borders = (build_wavelength_grid(wlg_el) if wlg_el is not None
                   else default_wlg)
    common = dict(
        name=a.get("instrumentName", t),
        wave_borders=tuple(borders),
        inclination=_q(a, "inclination", "angle", 0.0),
        azimuth=_q(a, "azimuth", "angle", 0.0),
        roll=_q(a, "roll", "angle", 0.0),
        distance=_q(a, "distance", "distance", 10 * 3.0857e16),
        record_polarization=a.get("recordPolarization", "false") == "true",
        aperture=_q(a, "radius", "length", 0.0),
    )
    if bands:
        common["bands"] = bands
    if t == "SEDInstrument":
        return dinst.DistantInstrumentCfg(**common)
    if t in ("LightCurveInstrument", "SpectralTimeMapInstrument"):
        # time-lag instruments (ref: TimeInstrument + TimeGrid; lag origin
        # = a direct photon from the spatial origin)
        tg = _child(el, "timeGrid")
        ta = tg.attrib if tg is not None else {}
        nt = int(ta.get("numTimes", 10))
        t0 = _q(ta, "minTime", "time", 0.0)
        t1 = _q(ta, "maxTime", "time", 1.0)
        if tg is not None and tg.tag == "LogTimeGrid":
            off = _q(ta, "offset", "time", 0.0)
            tb = off + np.geomspace(max(t0 - off, 1e-30), t1 - off, nt + 1)
        elif tg is not None and tg.tag == "FileTimeGrid":
            # explicit time borders from a text file [s]
            # (ref: FileTimeGrid)
            import os as _os
            fn = tg.attrib["filename"]
            if not _os.path.isabs(fn):
                fn = _os.path.join(base_dir, fn)
            tb = np.sort(np.loadtxt(fn).reshape(-1))
        else:
            tb = np.linspace(t0, t1, nt + 1)
        return dinst.DistantInstrumentCfg(**common,
                                          time_borders=tuple(tb))
    if t in ("FrameInstrument", "FullInstrument"):
        if a.get("recordComponents", "false") == "true":
            common["num_scattering_levels"] = int(
                a.get("numScatteringLevels", 0))
        return dinst.DistantInstrumentCfg(
            **common,
            npx=int(a.get("numPixelsX", 250)),
            npy=int(a.get("numPixelsY", 250)),
            fovx=_q(a, "fieldOfViewX", "length"),
            fovy=_q(a, "fieldOfViewY", "length"),
            centerx=_q(a, "centerX", "length", 0.0),
            centery=_q(a, "centerY", "length", 0.0),
        )
    if t == "PerspectiveInstrument":
        from ..instruments import perspective as persp
        return persp.PerspectiveInstrumentCfg(
            name=a.get("instrumentName", t), wave_borders=tuple(borders),
            npx=int(a.get("numPixelsX", 250)),
            npy=int(a.get("numPixelsY", 250)),
            width=_q(a, "width", "length"),
            view=(_q(a, "viewX", "length"), _q(a, "viewY", "length"),
                  _q(a, "viewZ", "length")),
            cross=(_q(a, "crossX", "length", 0.0),
                   _q(a, "crossY", "length", 0.0),
                   _q(a, "crossZ", "length", 0.0)),
            up=(_f(a, "upX", 0.0), _f(a, "upY", 0.0), _f(a, "upZ", 1.0)),
            focal=_q(a, "focal", "length"))
    if t in ("AllSkyInstrument", "HEALPixSkyInstrument"):
        from ..instruments import allsky as asky
        obs = (_q(a, "observerX", "length", 0.0),
               _q(a, "observerY", "length", 0.0),
               _q(a, "observerZ", "length", 0.0))
        cross = (_q(a, "crossX", "length", 0.0),
                 _q(a, "crossY", "length", 0.0),
                 _q(a, "crossZ", "length", 0.0))
        up = (_f(a, "upX", 0.0), _f(a, "upY", 0.0), _f(a, "upZ", 1.0))
        if t == "HEALPixSkyInstrument":
            return asky.AllSkyInstrumentCfg(
                name=a.get("instrumentName", t), wave_borders=tuple(borders),
                position=obs, projection="healpix",
                order=int(a.get("order", 5)), crosshair=cross, up=up)
        proj_el = _child(el, "projection")
        proj = ("hammer" if proj_el is not None
                and "Hammer" in proj_el.tag else "mollweide")
        return asky.AllSkyInstrumentCfg(
            name=a.get("instrumentName", t), wave_borders=tuple(borders),
            position=obs, projection=proj,
            npx=2 * int(a.get("numPixelsY", 125)), crosshair=cross, up=up)
    raise NotImplementedError(f"instrument '{t}' not supported yet")


# ----------------------------------------------------------------- top level

def load_ski(path: str, num_packets: int | None = None,
             batch_size: int = 16384, seed: int = 0,
             max_events: int = 64) -> Simulation:
    """Parse a .ski file into a runnable Simulation.

    (ref: SkirtCommandLineHandler::doSimulation, SkirtCommandLineHandler.cpp:295
    — parse, build item tree, setup; here: parse, build tables.)

    While building, every default the builders consult is materialized
    back into the element tree, so the regenerated parameters.xml records
    every property the run used (XmlHierarchyWriter contract)."""
    global _MATERIALIZE
    prev, _MATERIALIZE = _MATERIALIZE, True
    try:
        return _load_ski(path, num_packets=num_packets,
                         batch_size=batch_size, seed=seed,
                         max_events=max_events)
    finally:
        _MATERIALIZE = prev


def _load_ski(path: str, num_packets: int | None = None,
              batch_size: int = 16384, seed: int = 0,
              max_events: int = 64) -> Simulation:
    global _SKI_BASE_DIR
    _SKI_BASE_DIR = os.path.dirname(os.path.abspath(path))
    tree = ET.parse(path)
    with open(path, "r", encoding="utf-8") as f:
        ski_text = f.read()
    root = tree.getroot()
    mcs = root.find("MonteCarloSimulation")
    if mcs is None:
        raise ValueError("not a SKIRT 9 ski file (no MonteCarloSimulation)")
    mode = mcs.attrib.get("simulationMode", "ExtinctionOnly")
    iterate_secondary = mcs.attrib.get("iterateSecondaryEmission",
                                       "false") == "true"
    oligo = mode.startswith("Oligo")
    n_pk = num_packets or int(float(mcs.attrib.get("numPackets", 1e6)))

    # sources
    src_sys = mcs.find("sourceSystem/SourceSystem")
    _base_dir0 = os.path.dirname(os.path.abspath(path))
    _sr = None
    if src_sys is not None and "minWavelength" in src_sys.attrib:
        _sr = (U.parse("wavelength", src_sys.attrib["minWavelength"]),
               U.parse("wavelength", src_sys.attrib["maxWavelength"]))
    sources = [build_source(e, lrange=_sr, base_dir=_base_dir0)
               for e in src_sys.find("sources")] \
        if src_sys is not None else []
    if oligo and src_sys is not None:
        # oligochromatic regime: discrete wavelengths, sources emit at the
        # (first) discrete wavelength with their SED-weighted luminosity
        # (ref: Configuration.cpp:58 oligochromatic setup)
        import dataclasses as _dc
        lams = U.parse_list("wavelength", src_sys.attrib["wavelengths"])
        if any(isinstance(s, tuple) for s in sources):
            raise NotImplementedError(
                "imported sources in oligochromatic mode")
        sources = [_dc.replace(s, sed=None, lam0=lams[0]) for s in sources]
    src_range = None
    if src_sys is not None:
        a = src_sys.attrib
        if "minWavelength" in a:
            src_range = (U.parse("wavelength", a["minWavelength"]),
                         U.parse("wavelength", a["maxWavelength"]))
    # resolve deferred imported sources (need the source range + base dir)
    _base_dir = os.path.dirname(os.path.abspath(path))
    sources = [build_particle_source(s[1], _base_dir,
                                     src_range or (1e-8, 1e-3))
               if isinstance(s, tuple) and s[0] == "particle_source" else s
               for s in sources]
    sources = [build_cell_source(s[1], _base_dir, src_range or (1e-8, 1e-3))
               if isinstance(s, tuple) and s[0] == "cell_source" else s
               for s in sources]
    sources = [build_mesh_source(s[1], _base_dir, src_range or (1e-8, 1e-3))
               if isinstance(s, tuple) and s[0] == "mesh_source" else s
               for s in sources]
    if src_range is not None and not oligo:
        # the reference normalizes SEDs and samples wavelengths over the
        # source range (ref: SourceSystem min/maxWavelength +
        # IntegratedLuminosityNormalization wavelengthRange="Source")
        import dataclasses as _dc
        sources = [
            _dc.replace(s, sed=sedlib.clipped(s.sed, *src_range))
            if getattr(s, "sed", None) is not None else s
            for s in sources]

    # media + grid
    med_sys = mcs.find("mediumSystem/MediumSystem")
    grid = None
    medium = None
    components = []
    velocity_fields = []  # (component index, field, magnitude [m/s])
    magnetic_fields = []  # (field, strength [T]) — medium-state B
    voronoi_import = None  # (sites (N,3), density (N,) [kg/m^3], mix, v)
    amr_import = None      # (file path, massType, importVelocity, mix, box)
    snapshot_import = None  # (snapshot, mix, temperature) particle/cell
    if med_sys is not None:
        for m_el in med_sys.find("media"):
            if m_el.tag == "AdaptiveMeshMedium":
                # imported adaptive-mesh medium: Morton-order '!' tree file,
                # leaf rows = [rho|M|n|N, (vx vy vz)] (ref:
                # AdaptiveMeshMedium.hpp:65, MeshMedium.hpp:39-57,
                # AdaptiveMeshSnapshot.hpp:121)
                if components or voronoi_import or amr_import:
                    raise NotImplementedError(
                        "mixing AdaptiveMeshMedium with other media is not "
                        "supported yet")
                a = m_el.attrib
                fn = a["filename"]
                base = os.path.dirname(os.path.abspath(path))
                if not os.path.isabs(fn):
                    fn = os.path.join(base, fn)
                mix = build_mix(_child(m_el, "materialMix"), base_dir=base)
                ext_box = ((_q(a, "minX", "length"), _q(a, "maxX", "length")),
                           (_q(a, "minY", "length"), _q(a, "maxY", "length")),
                           (_q(a, "minZ", "length"), _q(a, "maxZ", "length")))
                flags = tuple(a.get(k, "false") == "true"
                              for k in ("importMetallicity",
                                        "importTemperature",
                                        "importVelocity",
                                        "importMagneticField"))
                amr_import = (fn, a.get("massType", "MassDensity"),
                              flags, mix, ext_box)
                continue
            if m_el.tag == "VoronoiMeshMedium":
                # imported Voronoi-mesh medium: one density value per site
                # (ref: VoronoiMeshMedium + VoronoiMeshSnapshot; columns
                # x,y,z in pc + mass density in Msun/pc3 by default)
                if components or voronoi_import is not None:
                    raise NotImplementedError(
                        "mixing VoronoiMeshMedium with other media is not "
                        "supported yet")
                from ..imports.snapshots import read_column_file
                a = m_el.attrib
                fn = a["filename"]
                base = os.path.dirname(os.path.abspath(path))
                if not os.path.isabs(fn):
                    fn = os.path.join(base, fn)
                # reference column order: position, density, [Z], [T],
                # [velocity], [B] (ref: ImportedMedium.cpp:18-24 import
                # call order + Snapshot column registration)
                cols = [("x", "length", "pc"), ("y", "length", "pc"),
                        ("z", "length", "pc")]
                mt = a.get("massType", "MassDensity")
                if mt == "MassDensity":
                    cols.append(("rho", "massvolumedensity", "Msun/pc3"))
                elif mt == "NumberDensity":
                    cols.append(("n", "numbervolumedensity", "1/cm3"))
                else:
                    raise NotImplementedError(f"massType '{mt}'")
                import_z = a.get("importMetallicity", "false") == "true"
                import_t = a.get("importTemperature", "false") == "true"
                import_v = a.get("importVelocity", "false") == "true"
                import_b = a.get("importMagneticField", "false") == "true"
                if import_z:
                    cols.append(("Z", "dimensionless", "1"))
                if import_t:
                    cols.append(("T", "temperature", "K"))
                if import_v:
                    cols += [("vx", "velocity", "km/s"),
                             ("vy", "velocity", "km/s"),
                             ("vz", "velocity", "km/s")]
                if import_b:
                    cols += [("Bx", "magneticfield", "uG"),
                             ("By", "magneticfield", "uG"),
                             ("Bz", "magneticfield", "uG")]
                d = read_column_file(fn, cols)
                mix = build_mix(_child(m_el, "materialMix"), base_dir=base)
                sites = np.stack([d["x"], d["y"], d["z"]], axis=-1)
                nd_sites = (d["rho"] / mix.mu if mt == "MassDensity"
                            else d["n"])
                if import_z:
                    # metallicity scales the medium density
                    # (ref: Snapshot mass-density policy useMetallicity)
                    nd_sites = nd_sites * d["Z"]
                vel = (np.stack([d["vx"], d["vy"], d["vz"]], axis=-1)
                       if import_v else None)
                ext_box = ((_q(a, "minX", "length"), _q(a, "maxX", "length")),
                           (_q(a, "minY", "length"), _q(a, "maxY", "length")),
                           (_q(a, "minZ", "length"), _q(a, "maxZ", "length")))
                extra = {
                    "temperature": d["T"] if import_t else None,
                    "magnetic_field": np.stack(
                        [d["Bx"], d["By"], d["Bz"]], axis=-1)
                    if import_b else None,
                    "metallicity": d["Z"] if import_z else None,
                }
                voronoi_import = (sites, nd_sites, mix, vel, ext_box, extra)
                continue
            if m_el.tag in ("ParticleMedium", "CellMedium"):
                # imported particle (SPH) / box-cell media: snapshot file
                # resampled onto the spatial grid at setup (ref:
                # ParticleMedium.hpp + CellMedium.hpp; column conventions
                # per ImportedMedium/Snapshot defaults)
                from ..imports import snapshots as snap
                a = m_el.attrib
                base = _base_dir0
                fn = a["filename"]
                if not os.path.isabs(fn):
                    fn = os.path.join(base, fn)
                import_z = a.get("importMetallicity", "false") == "true"
                import_t = a.get("importTemperature", "false") == "true"
                import_v = a.get("importVelocity", "false") == "true"
                mt = a.get("massType", "MassDensity")
                if m_el.tag == "ParticleMedium":
                    cols = [("x", "length", "pc"), ("y", "length", "pc"),
                            ("z", "length", "pc"), ("h", "length", "pc"),
                            ("M", "mass", "Msun")]
                else:
                    cols = [("xmin", "length", "pc"),
                            ("ymin", "length", "pc"),
                            ("zmin", "length", "pc"),
                            ("xmax", "length", "pc"),
                            ("ymax", "length", "pc"),
                            ("zmax", "length", "pc")]
                    if mt == "MassDensity":
                        cols.append(("rho", "massvolumedensity",
                                     "Msun/pc3"))
                    else:
                        cols.append(("M", "mass", "Msun"))
                if import_z:
                    cols.append(("Z", "", ""))
                if import_t:
                    cols.append(("T", "temperature", "K"))
                if import_v:
                    cols += [("vx", "velocity", "km/s"),
                             ("vy", "velocity", "km/s"),
                             ("vz", "velocity", "km/s")]
                d = snap.read_column_file(fn, cols)
                mix = build_mix(_child(m_el, "materialMix"), base_dir=base)
                zfac = d["Z"] if import_z else 1.0
                if m_el.tag == "ParticleMedium":
                    pos_i = np.stack([d["x"], d["y"], d["z"]], axis=-1)
                    vel_i = (np.stack([d["vx"], d["vy"], d["vz"]], axis=-1)
                             if import_v else None)
                    ss = snap.ParticleSnapshot(
                        positions=pos_i, h=d["h"], mass=d["M"] * zfac,
                        velocity=vel_i)
                else:
                    lo_i = np.stack([d["xmin"], d["ymin"], d["zmin"]],
                                    axis=-1)
                    hi_i = np.stack([d["xmax"], d["ymax"], d["zmax"]],
                                    axis=-1)
                    vols_i = np.prod(hi_i - lo_i, axis=-1)
                    mass_i = (d["rho"] * vols_i if mt == "MassDensity"
                              else d["M"]) * zfac
                    vel_i = (np.stack([d["vx"], d["vy"], d["vz"]], axis=-1)
                             if import_v else None)
                    ss = snap.CellSnapshot(lo=lo_i, hi=hi_i, mass=mass_i,
                                           velocity=vel_i)
                snapshot_import = (ss, mix,
                                   d["T"] if import_t else None)
                # density adapter for tree-refinement policies
                class _SnapGeom:
                    def density_np(self, pts, _ss=ss):
                        if hasattr(_ss, "density_at"):
                            return _ss.density_at(pts)
                        # cell snapshot: box membership density
                        pts = np.atleast_2d(pts)
                        rho = np.zeros(len(pts))
                        dens = _ss.mass / np.prod(
                            np.asarray(_ss.hi) - np.asarray(_ss.lo),
                            axis=-1)
                        for j in range(len(_ss.mass)):
                            sel = np.all((pts >= _ss.lo[j])
                                         & (pts < _ss.hi[j]), axis=-1)
                            rho = np.where(sel, dens[j], rho)
                        return rho
                components = [(_SnapGeom(), mix, None)]
                continue
            if m_el.tag != "GeometricMedium":
                raise NotImplementedError(f"medium '{m_el.tag}' not supported yet")
            geom = build_geometry(_child(m_el, "geometry"))
            mix = build_mix(_child(m_el, "materialMix"),
                            base_dir=os.path.dirname(os.path.abspath(path)))
            norm = build_medium_normalization(m_el, geom, mix)
            vd_el = _child(m_el, "velocityDistribution")
            if vd_el is not None:
                vmag = _q(m_el.attrib, "velocityMagnitude", "velocity", 0.0)
                if vmag != 0.0:
                    velocity_fields.append((len(components),
                                            build_vector_field(vd_el), vmag))
            bd_el = _child(m_el, "magneticFieldDistribution")
            if bd_el is not None:
                # (ref: GeometricMedium.hpp:47-52 magneticFieldDistribution
                # VectorField x magneticFieldStrength multiplier; the
                # reference allows one field-defining component)
                bmag = _q(m_el.attrib, "magneticFieldStrength",
                          "magneticfield", 0.0)
                if bmag != 0.0:
                    magnetic_fields.append((build_vector_field(bd_el), bmag))
            components.append((geom, mix, norm))
        grid_el = list(med_sys.find("grid"))[0]
        if amr_import is not None:
            # grid IS the imported adaptive mesh (ref:
            # AdaptiveMeshSpatialGrid.hpp:24)
            if grid_el.tag != "AdaptiveMeshSpatialGrid":
                raise NotImplementedError(
                    "AdaptiveMeshMedium requires AdaptiveMeshSpatialGrid")
            from ..grids.amr import build_amr
            fn, mtype, flags, mix, ext_box = amr_import
            import_z, import_t, import_v, import_b = flags
            grid, leaf = build_amr(fn, ext_box)
            vol = grid.volumes()
            # column units follow the reference's mesh-medium defaults;
            # leaf column order: density, [Z], [T], [v], [B] (ref:
            # ImportedMedium.cpp:18-24 import call order)
            MSUN, PC = 1.98892e30, 3.0857e16
            q = leaf[:, 0]
            if mtype == "MassDensity":
                nd_cells = q * (MSUN / PC**3) / mix.mu
            elif mtype == "Mass":
                nd_cells = q * MSUN / (mix.mu * vol)
            elif mtype == "NumberDensity":
                nd_cells = q * 1e6
            elif mtype == "Number":
                nd_cells = q / vol
            else:
                raise NotImplementedError(f"massType '{mtype}'")
            c = 1
            metallicity = temperature = vel = bfield = None
            if import_z:
                metallicity = leaf[:, c]
                nd_cells = nd_cells * metallicity
                c += 1
            if import_t:
                temperature = leaf[:, c]
                c += 1
            if import_v:
                vel = leaf[:, c:c + 3] * 1e3
                c += 3
            if import_b:
                bfield = leaf[:, c:c + 3] * 1e-10  # uG -> T
                c += 3
            from ..media import mixes as _mx
            lam, se, al, gg = _mx.stack([mix])
            from ..media import system as _msys
            medium = _msys.make_medium(
                grid, nd_cells.astype(np.float32), lam, se, al, gg,
                bulk_v=vel.astype(np.float32) if vel is not None else None,
                temperature=temperature, magnetic_field=bfield,
                metallicity=metallicity)
            components = [(None, mix, None)]
        elif voronoi_import is not None:
            # grid from the imported mesh (ref: VoronoiMeshSpatialGrid
            # policy ImportedMesh — the grid cells ARE the medium's sites)
            from ..grids.voronoi import build_voronoi
            if grid_el.tag != "VoronoiMeshSpatialGrid" or \
                    grid_el.attrib.get("policy", "DustDensity") \
                    != "ImportedMesh":
                raise NotImplementedError(
                    "VoronoiMeshMedium requires VoronoiMeshSpatialGrid "
                    "with policy='ImportedMesh'")
            sites, nd_sites, mix, vel, ext_box, extra = voronoi_import
            grid = build_voronoi(sites, ext_box)
            from ..media import mixes as _mx
            lam, se, al, gg = _mx.stack([mix])
            from ..media import system as _msys
            medium = _msys.make_medium(
                grid, nd_sites.astype(np.float32), lam, se, al, gg,
                bulk_v=vel.astype(np.float32) if vel is not None else None,
                temperature=extra["temperature"],
                magnetic_field=extra["magnetic_field"],
                metallicity=extra["metallicity"])
            components = [(None, mix, None)]
        else:
            grid = build_grid(grid_el, base_dir=_base_dir)
            if isinstance(grid, tuple) and grid[0] == "tree":
                spec = grid[1]
                geom0 = components[0][0]
                builder = build_octree
                if spec["kind"] == "BinTree":
                    from ..grids.bintree import build_bintree
                    builder = build_bintree
                refine_fn = None
                if spec.get("inner"):
                    # nested policy: the inner box refines further
                    # (ref: NestedDensityTreePolicy.hpp)
                    inn = spec["inner"]
                    outer_frac = max(spec["max_fraction"], 1e-4)
                    inner_frac = max(inn["max_fraction"], 1e-5)
                    import numpy as _np
                    rs_n = _np.random.default_rng(7)

                    def refine_fn(lo, hi, level, geom=geom0, inn=inn,
                                  of=outer_frac, inf_=inner_frac):
                        u = rs_n.uniform(size=(64, lo.shape[0], 3))
                        pts = lo[None] + u * (hi - lo)[None]
                        dens = geom.density_np(pts.reshape(-1, 3)) \
                            .reshape(64, -1)
                        vol = _np.prod(hi - lo, axis=-1)
                        frac = dens.mean(axis=0) * vol
                        c = 0.5 * (lo + hi)
                        inside = _np.all(
                            (c >= _np.asarray(inn["lo"]))
                            & (c <= _np.asarray(inn["hi"])), axis=-1)
                        out = (frac > of) & (level < spec["max_level"])
                        deep = inside & (frac > inf_) \
                            & (level < inn["max_level"])
                        return out | deep
                    grid = builder(spec["ext"], geom0.density_np,
                                   max_level=max(spec["max_level"],
                                                 inn["max_level"]),
                                   min_level=spec["min_level"],
                                   refine_fn=refine_fn)
                else:
                    grid = builder(spec["ext"], geom0.density_np,
                                   max_level=spec["max_level"],
                                   min_level=spec["min_level"],
                                   max_fraction=max(
                                       spec["max_fraction"] or 1e-4, 1e-4))
            elif isinstance(grid, tuple) and grid[0] == "voronoi":
                # standalone Voronoi/tetra grids with density-sampled or
                # uniform sites + optional Lloyd relaxation (ref:
                # VoronoiMeshSpatialGrid.hpp:26 policies,
                # VoronoiMeshSnapshot.cpp:609 relax)
                from ..grids.voronoi import (build_voronoi, density_sites,
                                             lloyd_relax)
                spec = grid[1]
                geom0 = components[0][0]
                if spec["policy"] == "DustDensity" and geom0 is not None:
                    sites = density_sites(geom0.density_np, spec["ext"],
                                          spec["n"], seed=3)
                else:   # Uniform / fallback
                    rs_v = np.random.default_rng(3)
                    lo_ = np.array([e[0] for e in spec["ext"]])
                    hi_ = np.array([e[1] for e in spec["ext"]])
                    sites = lo_ + rs_v.uniform(size=(spec["n"], 3)) \
                        * (hi_ - lo_)
                if spec["relax"]:
                    sites = lloyd_relax(sites, spec["ext"])
                if spec["kind"] == "tetra":
                    from ..grids.tetra import build_tetra
                    grid = build_tetra(sites, spec["ext"])
                else:
                    grid = build_voronoi(sites, spec["ext"])
            if snapshot_import is not None:
                # resample the imported snapshot onto the resolved grid
                ss, mix, temp_i = snapshot_import
                from ..media import mixes as _mx
                from ..media import system as _msys
                lam_m, se_m, al_m, gg_m = _mx.stack([mix])
                rho_cells = ss.density_on_cells(grid)          # kg/m^3
                nd_cells = rho_cells / mix.mu
                vel_c = ss.velocity_on_cells(grid) \
                    if ss.velocity is not None else None
                medium = _msys.make_medium(
                    grid, nd_cells.astype(np.float32), lam_m, se_m, al_m,
                    gg_m,
                    bulk_v=(vel_c.astype(np.float32)
                            if vel_c is not None else None),
                    temperature=temp_i)
            else:
                medium = gm.build_medium(grid, components)
        if velocity_fields:
            # per-cell aggregate bulk velocity: number-density-weighted
            # average over moving components, evaluated at cell centers
            # (ref: MediumSystem.cpp:109-119 PropertyInCellSampler
            # bulkVelocity with numPropertySamples=1, and :339 the
            # density-weighted aggregate over components)
            centers = np.asarray(grid.cell_centers(), np.float64)
            nd_np = np.asarray(medium.nd, np.float64)  # (ncells, H)
            vsum = np.zeros((len(centers), 3))
            nsum = np.zeros(len(centers))
            for h, fld, vmag in velocity_fields:
                vsum += nd_np[:, h:h + 1] * (vmag * fld.field(centers))
                nsum += nd_np[:, h]
            bulk_v = np.where(nsum[:, None] > 0, vsum
                              / np.maximum(nsum, 1e-300)[:, None], 0.0)
            medium = medium._replace(
                bulk_v=jnp.asarray(bulk_v, jnp.float32))
        if magnetic_fields:
            centers = np.asarray(grid.cell_centers(), np.float64)
            fld, bmag = magnetic_fields[0]
            medium = medium._replace(magnetic_field=jnp.asarray(
                bmag * fld.field(centers), jnp.float32))

    if grid is None:
        # no medium: trivial one-cell empty grid spanning the sources
        R = 3.0857e17
        grid = make_cartesian(((-R, R), (-R, R), (-R, R)), (1, 1, 1))
        from ..media import system as msys
        medium = msys.make_medium(grid, np.zeros(1), np.array([1e-8, 1e-3]),
                                  np.zeros((1, 2)), np.zeros((1, 2)),
                                  np.zeros((1, 2)))

    # instruments
    if oligo:
        lams = U.parse_list("wavelength", src_sys.attrib["wavelengths"])
        default_wlg = wl.oligo_borders(lams)
    elif src_range is None:
        default_wlg = wl.log_borders_skirt(0.1e-6, 10e-6, 25)
    else:
        default_wlg = wl.log_borders_skirt(src_range[0], src_range[1], 25)
    inst_sys = mcs.find("instrumentSystem/InstrumentSystem")
    instruments = []
    if inst_sys is not None:
        dwlg_el = inst_sys.find("defaultWavelengthGrid")
        if dwlg_el is not None and len(dwlg_el):
            default_wlg = build_wavelength_grid(list(dwlg_el)[0])
        inst_list = inst_sys.find("instruments")
        for i_el in (list(inst_list) if inst_list is not None else []):
            instruments.append(build_instrument(i_el, default_wlg, base_dir=_base_dir))

    with_emission = mode in ("DustEmission", "DustAndGasEmission")
    # radiation-field / dust-emission wavelength grids: explicit items in
    # the ski override the defaults (ref: RadiationFieldOptions.hpp:30,
    # DustEmissionOptions dustEmissionWLG)
    rf_borders = None
    ems_borders = None
    rf_el = mcs.find(".//radiationFieldOptions/RadiationFieldOptions/"
                     "radiationFieldWLG")
    if rf_el is not None and len(rf_el):
        rf_borders = build_wavelength_grid(list(rf_el)[0])
    de_wlg_el = mcs.find(".//dustEmissionOptions/DustEmissionOptions/"
                         "dustEmissionWLG")
    if de_wlg_el is not None and len(de_wlg_el):
        ems_borders = build_wavelength_grid(list(de_wlg_el)[0])
    if rf_borders is None and (with_emission or mode.startswith("Iterate")):
        rf_borders = wl.log_borders_skirt(*(src_range or (0.05e-6, 10e-6)), 25)
    if ems_borders is None and with_emission:
        ems_borders = wl.log_borders_skirt(1e-6, 2000e-6, 40)

    # dust emission type (ref: DustEmissionOptions dustEmissionType); the
    # stochastic calculator needs the multi-grain size-bin tables of the
    # (first multi-grain) dust component
    ems_type = "Equilibrium"
    grain_tables = None
    cell_library = None
    de_opts = mcs.find(".//dustEmissionOptions/DustEmissionOptions")
    if de_opts is not None and \
            de_opts.attrib.get("dustEmissionType") == "Stochastic":
        ems_type = "Stochastic"
    # spatial cell library (ref: DustEmissionOptions cellLibrary)
    cl_el = _child(de_opts, "cellLibrary") if de_opts is not None else None
    if cl_el is not None and cl_el.tag != "AllCellsLibrary":
        from ..emission import library as _clib
        ca = cl_el.attrib
        if cl_el.tag == "FieldStrengthCellLibrary":
            cell_library = _clib.FieldStrengthCellLibrary(
                num_field_strengths=int(_f(ca, "numFieldStrengths", 1000)))
        elif cl_el.tag == "TemperatureWavelengthCellLibrary":
            cell_library = _clib.TemperatureWavelengthCellLibrary(
                num_temperatures=int(_f(ca, "numTemperatures", 40)),
                num_wavelengths=int(_f(ca, "numWavelengths", 25)))
        else:
            raise NotImplementedError(f"cell library '{cl_el.tag}'")
    grain_component = 0
    for h, (_, mix_i, _) in enumerate(components):
        mg_i = multigrain_for(mix_i)
        if mg_i is not None:
            grain_tables = mg_i
            grain_component = h
            break

    # polarization: any material mix carrying Mueller tables switches the
    # photon cycle to Stokes-tracking scattering (ref: Configuration.cpp
    # hasPolarization derived from MaterialMix::ScatteringMode)
    mueller = None
    for _, mix_i, _ in components:
        mt = getattr(mix_i, "_mueller", None)
        if mt is not None:
            mueller = mt
            break

    # aligned-spheroidal-grain polarized dust emission (requires a
    # magnetic field in the medium state; the reference likewise derives
    # hasSpheroidalPolarization from the mixes, Configuration.cpp)
    spheroidal = None
    for _, mix_i, _ in components:
        se = getattr(mix_i, "_spheroidal", None)
        if se is not None:
            if spheroidal is not None:
                raise NotImplementedError(
                    "multiple media with spheroidal emission tables are "
                    "not supported (one combined mix is)")
            spheroidal = se

    # X-ray gas: fluorescence + Compton channel tables switch the photon
    # cycle to the wavelength-changing X-ray branch (ref: XRayAtomicGasMix
    # performScattering; Configuration derived flags)
    xray_dev_tabs = None
    for _, mix_i, _ in components:
        xt = getattr(mix_i, "_xray", None)
        if xt is not None:
            from ..media import xray as _xr
            xray_dev_tabs = _xr.device_tables(xt)
            break

    # Lyman-alpha line transfer (ref: Configuration.cpp:116-135): the
    # LyaNeutralHydrogenGasMix marker switches the photon cycle to the
    # resonant branch; acceleration scheme from MediumSystem lyaOptions
    lya_cfg = None
    for _, mix_i, _ in components:
        lv = getattr(mix_i, "_lya", None)
        if lv is not None:
            lya_cfg = lv
            break
    lya_xcrit = 0.0
    lya_variable = False
    lya_strength = 1.0
    if lya_cfg is not None:
        if mode != "LyaExtinctionOnly":
            raise ValueError("LyaNeutralHydrogenGasMix requires "
                             "simulationMode='LyaExtinctionOnly' "
                             "(ref: Configuration.cpp:298-301)")
        lo_el = mcs.find(".//lyaOptions/LyaOptions")
        la = lo_el.attrib if lo_el is not None else {}
        scheme = la.get("lyaAccelerationScheme", "Variable")
        lya_strength = _f(la, "lyaAccelerationStrength", 1.0)
        if scheme == "Constant":
            lya_xcrit = 3.0 * lya_strength     # ref: LyaUtils.cpp:55
        elif scheme == "Variable":
            lya_variable = True                # per-cell (nH/T)^(1/6)
        # per-cell gas temperature defaults to the mix's defaultTemperature
        # wherever the import didn't provide one (make_medium zero-fills)
        if medium is not None:
            T0 = float(lya_cfg["T_default"])
            tarr = np.asarray(medium.temperature)
            tarr = np.where(tarr > 0, tarr, T0).astype(np.float32)
            medium = medium._replace(temperature=jnp.asarray(tarr))

    # photon-cycle knobs (ref: PhotonPacketOptions.hpp defaults)
    pp_el = mcs.find(".//photonPacketOptions/PhotonPacketOptions")
    pa = pp_el.attrib if pp_el is not None else {}
    force_scattering = pa.get("forceScattering", "true") == "true"
    path_length_bias = _f(pa, "pathLengthBias", 0.5)
    kinematics = bool(velocity_fields) and not oligo
    if (kinematics or lya_cfg is not None) and force_scattering \
            and path_length_bias > 0.0:
        # moving media and resonant Lya invalidate path-length stretching
        # (the stretched path samples Doppler-shifted opacities
        # incorrectly); the reference forces the bias off
        # (ref: Configuration.cpp:493-497, condition includes
        # _hasLymanAlpha)
        path_length_bias = 0.0

    # the grid's own bound on cells crossed by one straight path: a smaller
    # march length would silently truncate long paths on large grids
    max_steps = grid.max_steps() if hasattr(grid, "max_steps") else 128
    opts = lc.TransportOptions(max_steps=max_steps,
                               max_events=max_events,
                               store_rf=rf_borders is not None,
                               force_scattering=force_scattering,
                               path_length_bias=path_length_bias,
                               min_weight_reduction=_f(
                                   pa, "minWeightReduction", 1e4),
                               min_scatt_events=int(
                                   _f(pa, "minScattEvents", 0)),
                               explicit_absorption=pa.get(
                                   "explicitAbsorption", "false") == "true",
                               kinematics=kinematics,
                               polarization=mueller is not None,
                               lya=lya_cfg is not None,
                               lya_xcrit=lya_xcrit,
                               lya_variable=lya_variable,
                               lya_strength=lya_strength,
                               xray=xray_dev_tabs is not None)
    # dynamic medium state recipes + primary-emission iterations
    # (ref: DynamicStateOptions.hpp:20, IterationOptions.hpp:21-66,
    # MonteCarloSimulation iteratePrimaryEmission mode attribute)
    iterate_primary = mcs.attrib.get("iteratePrimaryEmission",
                                     "false") == "true"
    recipes = []
    ds_el = mcs.find(".//dynamicStateOptions/DynamicStateOptions/recipes")
    for r_el in (list(ds_el) if ds_el is not None else []):
        from ..media import dynamic as dyn
        ra = r_el.attrib
        if r_el.tag == "ClearDensityRecipe":
            recipes.append(dyn.ClearDensityRecipe(
                field_strength_threshold=_f(ra, "fieldStrengthThreshold",
                                            1.0)))
        elif r_el.tag == "LinearDustDestructionRecipe":
            if grain_tables is None:
                raise ValueError("LinearDustDestructionRecipe requires a "
                                 "multi-grain dust component")
            recipes.append(dyn.LinearDustDestructionRecipe(
                grain_tables=grain_tables, rf_borders=rf_borders,
                component=grain_component,
                min_silicate_temperature=_q(ra, "minSilicateTemperature",
                                            "temperature", 1200.0),
                max_silicate_temperature=_q(ra, "maxSilicateTemperature",
                                            "temperature", 1400.0),
                min_graphite_temperature=_q(ra, "minGraphiteTemperature",
                                            "temperature", 2000.0),
                max_graphite_temperature=_q(ra, "maxGraphiteTemperature",
                                            "temperature", 2200.0),
                density_fraction_tolerance=_f(
                    ra, "densityFractionTolerance", 0.05)))
        else:
            raise NotImplementedError(f"dynamic state recipe '{r_el.tag}'")
    it_el = mcs.find(".//iterationOptions/IterationOptions")
    ia = it_el.attrib if it_el is not None else {}

    sim = Simulation(
        grid=grid, medium=medium, sources=sources, instruments=instruments,
        options=opts, rf_borders=rf_borders, ems_borders=ems_borders,
        num_packets=n_pk, batch_size=batch_size, seed=seed,
        dust_emission_type=ems_type, grain_tables=grain_tables,
        cell_library=cell_library,
        grain_component=grain_component, iterate_secondary=iterate_secondary,
        min_iterations=int(_f(ia, "minSecondaryIterations", 1)),
        max_iterations=int(_f(ia, "maxSecondaryIterations", 10)),
        include_primary=ia.get("includePrimaryEmission", "false") == "true",
        iterate_primary=iterate_primary and bool(recipes),
        dynamic_recipes=recipes,
        min_primary_iterations=int(_f(ia, "minPrimaryIterations", 1)),
        max_primary_iterations=int(_f(ia, "maxPrimaryIterations", 10)),
        primary_iteration_packets_multiplier=_f(
            ia, "primaryIterationPacketsMultiplier", 1.0),
        mueller=mueller, spheroidal=spheroidal, xray_tabs=xray_dev_tabs)
    # diffuse-ionized-gas components: per-iteration state recipe + nebular
    # gas emitter (ref: DiffuseIonizedGasMix.hpp:153; media/dig.py)
    for h, (_, mix_i, _) in enumerate(components):
        dg = getattr(mix_i, "_dig", None)
        if dg is None or medium is None or rf_borders is None:
            continue
        from ..media import dig as _dig
        nH = np.asarray(medium.nd)[:, h].astype(np.float64)
        T_tab = None
        if dg["T_table"]:
            d2 = np.loadtxt(dg["T_table"], ndmin=2)
            T_tab = (d2[:, 0], d2[:, 1])
        recipe = _dig.DIGRecipe(
            nH=nH, Z=np.full(len(nH), dg["Z"]),
            rf_borders=np.asarray(rf_borders),
            default_T=dg["T_default"],
            use_cloudy_temperature=dg["use_cloudy_T"],
            T_logU=T_tab, max_change=dg["max_change"],
            max_frac_not_converged=dg["max_frac"], max_nH=dg["max_nH"])
        sim.dynamic_recipes = list(sim.dynamic_recipes) + [recipe]
        if ems_borders is not None:
            sim.gas_emitters.append(recipe.make_emitter(
                grid, np.asarray(ems_borders)))
    # keep the configuration WITH the materialized defaults for the
    # parameters.xml round-trip: the build wrote every consulted default
    # back into the tree (ref: SkirtCommandLineHandler.cpp:342-347)
    sim.ski_text = ET.tostring(root, encoding="unicode")
    sim.ski_input_text = ski_text
    # medium build recipe, kept for convergence/grain probes
    sim.medium_components = components
    # output unit system (ref: Units.hpp:29)
    from ..utils.unitsystem import from_ski as _units_from_ski
    sim.units = _units_from_ski(_child(mcs, "units"))
    # cosmology: models at redshift override instrument distances with the
    # luminosity distance and stretch detected wavelengths
    # (ref: Cosmology.hpp:16; DistantInstrument.cpp:28-35)
    from ..utils.cosmology import from_ski as _cos_from_ski
    cos = _cos_from_ski(_child(mcs, "cosmology"))
    sim.cosmology = cos
    # CMB dust heating (ref: DustEmissionOptions includeHeatingByCMB:
    # equilibrium balance gains the CMB field at T = 2.725 (1+z) K)
    if de_opts is not None and \
            de_opts.attrib.get("includeHeatingByCMB", "false") == "true":
        sim.cmb_temperature = 2.725 * (1.0 + cos.redshift)
    if cos.redshift > 0.0:
        import dataclasses as _dc2
        sim.instruments = [
            _dc2.replace(ic, distance=cos.luminosity_distance(),
                         angular_distance=cos.angular_diameter_distance(),
                         redshift=cos.redshift)
            if isinstance(ic, dinst.DistantInstrumentCfg) else ic
            for ic in sim.instruments]
        sim._inst_tabs = [None] * len(sim.instruments)
        from ..simulation import _inst_tables as _it
        sim._inst_tabs = [_it(ic) for ic in sim.instruments]

    # probe system with When hooks (ref: ProbeSystem.hpp:54-57 +
    # Probe.hpp:40 probeAfter)
    from ..probes.probes import ProbeSpec
    probe_map = {
        "SpatialCellPropertiesProbe": ("cellprops", "Setup"),
        "DensityProbe": ("density", "Setup"),
        "OpacityProbe": ("opacity", "Setup"),
        "VelocityProbe": ("velocity", "Setup"),
        "TemperatureProbe": ("temperature", "Run"),
        "RadiationFieldProbe": ("radiationfield", "Run"),
        "LuminosityProbe": ("luminosity", "Setup"),
        "LaunchedPacketsProbe": ("luminosity", "Run"),
        "InstrumentWavelengthGridProbe": ("wavelengths", "Setup"),
        "RadiationFieldWavelengthGridProbe": ("wavelengths", "Setup"),
        "SpatialGridPlotProbe": ("grid", "Setup"),
        "OpticalDepthMapProbe": ("taumap", "Setup"),
        "SpatialGridSourceDensityProbe": ("sourcedensity", "Setup"),
        "DustGrainPopulationsProbe": ("grainpops", "Setup"),
        "DustGrainSizeDistributionProbe": ("grainsizes", "Setup"),
        "OpticalMaterialPropertiesProbe": ("materialprops", "Setup"),
        "SecondaryDustLuminosityProbe": ("secondaryluminosity", "Run"),
        "DustAbsorptionPerCellProbe": ("absorption", "Run"),
        "TreeSpatialGridTopologyProbe": ("treetopology", "Setup"),
        "MagneticFieldProbe": ("magneticfield", "Setup"),
        "MetallicityProbe": ("metallicity", "Setup"),
        "ImportedMediumDensityProbe": ("density", "Setup"),
        "ImportedMediumVelocityProbe": ("velocity", "Setup"),
        "ImportedMediumTemperatureProbe": ("gastemperature", "Setup"),
        "ImportedMediumMetallicityProbe": ("metallicity", "Setup"),
        "DustEmissionWavelengthGridProbe": ("wavelengths", "Setup"),
        "ConvergenceInfoProbe": ("convergence", "Setup"),
        "InputModelFormProbe": ("inputmodel", "Setup"),
        "ConvergenceCutsProbe": ("convergencecuts", "Setup"),
        "DustEmissivityProbe": ("dustemissivity", "Setup"),
        "CustomStateProbe": ("customstate", "Setup"),
        "SpatialCellPropertiesProbe": ("cellprops", "Setup"),
        "ImportedSourceDensityProbe": ("importedsource", "Setup"),
        "ImportedSourceLuminosityProbe": ("importedsource", "Setup"),
        "ImportedSourceAgeProbe": ("importedsource", "Setup"),
        "ImportedSourceMetallicityProbe": ("importedsource", "Setup"),
        "ImportedSourceVelocityProbe": ("importedsource", "Setup"),
        "IntegratedSecondaryLineLuminosityProbe": ("linelums", "Run"),
        "SecondaryLineLuminosityProbe": ("linelums", "Run"),
        "InstrumentTimeGridProbe": ("instrtimegrid", "Setup"),
    }
    _IMPORTED_WHICH = {
        "ImportedSourceDensityProbe": "density",
        "ImportedSourceLuminosityProbe": "luminosity",
        "ImportedSourceAgeProbe": "age",
        "ImportedSourceMetallicityProbe": "metallicity",
        "ImportedSourceVelocityProbe": "velocity",
    }
    probes = []
    plist = mcs.find("probeSystem/ProbeSystem/probes")
    for p_el in (list(plist) if plist is not None else []):
        if p_el.tag not in probe_map:
            raise NotImplementedError(f"probe '{p_el.tag}' not supported yet")
        kind, default_when = probe_map[p_el.tag]
        when = p_el.attrib.get("probeAfter", default_when)
        kw = {}
        if "wavelength" in p_el.attrib:
            kw["lam"] = _q(p_el.attrib, "wavelength", "wavelength")
        if p_el.tag in _IMPORTED_WHICH:
            kw["which"] = _IMPORTED_WHICH[p_el.tag]
        probes.append(ProbeSpec(kind, p_el.attrib.get("probeName", kind),
                                when=when, **kw))
    sim.probes = probes
    return sim
