"""Probes: outputs of internal simulation state.

Batched counterpart of the reference's ProbeSystem + Probe + Form stack
(ref: SKIRT/core/ProbeSystem.hpp:60, Probe.hpp:29, ProbeFormBridge.hpp:23,
the ~55 probe classes of SURVEY.md §2.9): a probe is a function of the
simulation state producing text/FITS artifacts through a "form" — per-cell
dump, planar cut, or parallel projection — mirroring the reference's
orthogonal probe x form design without the class lattice.

Probes implemented here cover the most-used reference set: density,
opacity, temperature, radiation field, convergence (gridded vs input-model
column density), spatial grid properties, luminosity per source.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils import fits as fitsio


# -------------------------------------------------------------------- forms

def per_cell_form(path: str, grid, quantities: dict[str, np.ndarray],
                  unit_note: str = "") -> str:
    """Text dump of per-cell values with cell centers
    (ref: PerCellForm / SpatialCellPropertiesProbe)."""
    centers = np.asarray(grid.cell_centers(), np.float64)
    cols = [centers[:, 0], centers[:, 1], centers[:, 2]]
    names = ["x", "y", "z"]
    for k, v in quantities.items():
        cols.append(np.asarray(v, np.float64))
        names.append(k)
    header = ("# skirt9_tpu per-cell probe\n# columns: " + " ".join(names)
              + ("\n# " + unit_note if unit_note else ""))
    arr = np.column_stack(cols)
    with open(path, "w") as f:
        f.write(header + "\n")
        np.savetxt(f, arr)
    return path


def planar_cut_form(path: str, grid, values_fn, axis: str = "z",
                    offset: float = 0.0, npix: int = 256,
                    extent=None) -> str:
    """FITS image of a scalar field on a planar cut through the domain
    (ref: DefaultCutsForm / PlanarCutsForm): values_fn(pos (N,3)) -> (N,)."""
    import jax.numpy as jnp
    if extent is None:
        lo = [float(grid.xb[0]), float(grid.yb[0]), float(grid.zb[0])] \
            if hasattr(grid, "xb") else np.asarray(grid.box_lo, float)
        hi = [float(grid.xb[-1]), float(grid.yb[-1]), float(grid.zb[-1])] \
            if hasattr(grid, "xb") else np.asarray(grid.box_hi, float)
    else:
        lo, hi = extent
    ax = {"x": 0, "y": 1, "z": 2}[axis]
    a1, a2 = [i for i in range(3) if i != ax]
    u = np.linspace(lo[a1], hi[a1], npix)
    v = np.linspace(lo[a2], hi[a2], npix)
    U, V = np.meshgrid(u, v)
    pos = np.zeros((npix * npix, 3))
    pos[:, a1] = U.ravel()
    pos[:, a2] = V.ravel()
    pos[:, ax] = offset
    vals = np.asarray(values_fn(jnp.asarray(pos, jnp.float32)), np.float64)
    fitsio.write_fits(path, vals.reshape(npix, npix).astype(np.float32),
                      {"CUTAXIS": axis, "CUTOFFS": offset})
    return path


def cell_scalar_fn(grid, per_cell: np.ndarray):
    """Lift a per-cell array to a position-valued function for cuts."""
    import jax.numpy as jnp
    vals = jnp.asarray(np.asarray(per_cell, np.float32))

    def fn(pos):
        c = grid.locate(pos)
        return jnp.where(c >= 0, vals[jnp.maximum(c, 0)], 0.0)
    return fn


# ------------------------------------------------------------------- probes

def density_probe(sim, prefix: str, outdir: str = ".", cuts: bool = True):
    """Per-cell number density + midplane cuts per component
    (ref: DensityProbe)."""
    nd = np.asarray(sim.medium.nd, np.float64)
    paths = []
    q = {f"nd_{h}": nd[:, h] for h in range(nd.shape[1])}
    paths.append(per_cell_form(os.path.join(outdir, f"{prefix}_density.dat"),
                               sim.grid, q, "number density [1/m3]"))
    if cuts:
        for h in range(nd.shape[1]):
            fn = cell_scalar_fn(sim.grid, nd[:, h])
            for axis in "xyz":
                paths.append(planar_cut_form(
                    os.path.join(outdir, f"{prefix}_density_{h}_{axis}.fits"),
                    sim.grid, fn, axis=axis))
    return paths


def opacity_probe(sim, lam: float, prefix: str, outdir: str = "."):
    """Per-cell extinction opacity k [1/m] at a wavelength
    (ref: OpacityProbe)."""
    import jax.numpy as jnp
    from ..media import system as msys
    med = sim.medium
    opt = msys.optics_at(med, jnp.full((1,), lam, jnp.float32))
    se = np.asarray(opt.sigma_ext, np.float64)[0]  # (H,)
    nd = np.asarray(med.nd, np.float64)
    k = (nd * se).sum(axis=1)
    return [per_cell_form(os.path.join(outdir, f"{prefix}_opacity.dat"),
                          sim.grid, {"k_ext": k}, f"opacity [1/m] at {lam} m")]


def temperature_probe(sim, rf, prefix: str, outdir: str = "."):
    """Indicative equilibrium dust temperature per cell + cuts
    (ref: TemperatureProbe)."""
    T = np.asarray(sim.dust_temperature(rf), np.float64)
    paths = [per_cell_form(os.path.join(outdir, f"{prefix}_temperature.dat"),
                           sim.grid, {f"T_{h}": T[:, h]
                                      for h in range(T.shape[1])},
                           "equilibrium dust temperature [K]")]
    fn = cell_scalar_fn(sim.grid, T[:, 0])
    paths.append(planar_cut_form(
        os.path.join(outdir, f"{prefix}_temperature_z.fits"), sim.grid, fn))
    return paths


def radiation_field_probe(sim, rf, prefix: str, outdir: str = "."):
    """Mean intensity J_lambda per cell per RF bin [W/m2/m/sr]
    (ref: RadiationFieldProbe)."""
    rf64 = np.asarray(rf, np.float64) * sim.rf_scale
    vols = np.asarray(sim.grid.volumes(), np.float64)
    dlam = np.diff(np.asarray(sim.rf_borders, np.float64))
    J = rf64 / (4 * np.pi * vols[:, None] * dlam[None, :])
    q = {f"J_{i}": J[:, i] for i in range(J.shape[1])}
    return [per_cell_form(os.path.join(outdir, f"{prefix}_radiationfield.dat"),
                          sim.grid, q, "mean intensity [W/m2/m/sr]")]


def convergence_probe(sim, components, prefix: str, outdir: str = "."):
    """Gridded vs input-model column density along the axes + total mass
    (ref: ConvergenceInfoProbe): quantifies grid discretization quality.

    components: the (geometry, mix, normalization) list used to build the
    medium (for the input-model side).
    """
    import jax.numpy as jnp
    from ..media import geometric as gm
    lines = ["# skirt9_tpu convergence info",
             "# columns: quantity gridded input_model rel_error"]
    nd = np.asarray(sim.medium.nd, np.float64)
    vols = np.asarray(sim.grid.volumes(), np.float64)

    for h, (geom, mix, norm) in enumerate(components):
        factor = norm.number_factor(geom, mix)
        # total number of entities
        n_grid = float((nd[:, h] * vols).sum())
        n_model = factor  # density profiles integrate to 1
        lines.append(f"total_number_{h} {n_grid:.6e} {n_model:.6e} "
                     f"{abs(n_grid - n_model) / max(n_model, 1e-300):.4e}")
        # column along +z
        rmax = getattr(geom, "rmax", None)
        if rmax:
            zs = np.linspace(1e-6 * rmax, rmax, 10001)
            pos = np.stack([np.zeros_like(zs), np.zeros_like(zs), zs], -1)
            cells = np.asarray(sim.grid.locate(jnp.asarray(pos, jnp.float32)))
            col_grid = float(np.trapezoid(
                np.where(cells >= 0, nd[np.maximum(cells, 0), h], 0.0), zs))
            col_model = factor * float(np.trapezoid(geom.density_np(pos), zs))
            lines.append(f"column_z_{h} {col_grid:.6e} {col_model:.6e} "
                         f"{abs(col_grid - col_model) / max(col_model, 1e-300):.4e}")
    path = os.path.join(outdir, f"{prefix}_convergence.dat")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return [path]


def grid_probe(sim, prefix: str, outdir: str = "."):
    """Spatial grid statistics (ref: SpatialCellPropertiesProbe /
    TreeSpatialGridTopologyProbe companion info)."""
    vols = np.asarray(sim.grid.volumes(), np.float64)
    lines = [
        "# skirt9_tpu spatial grid properties",
        f"ncells {sim.grid.ncells}",
        f"min_cell_volume_m3 {vols.min():.6e}",
        f"max_cell_volume_m3 {vols.max():.6e}",
        f"total_volume_m3 {vols.sum():.6e}",
    ]
    path = os.path.join(outdir, f"{prefix}_grid.dat")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return [path]


def luminosity_probe(sim, prefix: str, outdir: str = "."):
    """Per-source luminosities and packet allocation
    (ref: LuminosityProbe / LaunchedPacketsProbe)."""
    counts, weights = sim._source_allocation(sim.num_packets)
    lines = ["# skirt9_tpu source luminosities",
             "# columns: source luminosity_W packets lum_weight"]
    for i, s in enumerate(sim.sources):
        lines.append(f"{i} {float(getattr(s, 'luminosity', 1.0)):.6e} "
                     f"{int(counts[i])} {float(weights[i]):.6e}")
    path = os.path.join(outdir, f"{prefix}_luminosities.dat")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return [path]


# ------------------------------------------------------------ more forms

def parallel_projection_form(path: str, grid, per_cell: np.ndarray,
                             inclination: float = 0.0, azimuth: float = 0.0,
                             npix: int = 128, samples: int = 192) -> str:
    """FITS map of a per-cell field integrated along parallel lines of
    sight (ref: ParallelProjectionForm): the projection of field f is
    integral f ds through the domain for each image pixel."""
    import jax.numpy as jnp
    lo = np.asarray(getattr(grid, "box_lo", None) if hasattr(grid, "box_lo")
                    else [grid.xb[0], grid.yb[0], grid.zb[0]], np.float64)
    hi = np.asarray(getattr(grid, "box_hi", None) if hasattr(grid, "box_hi")
                    else [grid.xb[-1], grid.yb[-1], grid.zb[-1]], np.float64)
    center = 0.5 * (lo + hi)
    radius = 0.5 * float(np.linalg.norm(hi - lo))
    ct, st = np.cos(inclination), np.sin(inclination)
    cp, sp = np.cos(azimuth), np.sin(azimuth)
    k = np.array([st * cp, st * sp, ct])
    ex = np.array([-sp, cp, 0.0])
    ey = np.cross(k, ex)
    u = np.linspace(-radius, radius, npix)
    U, V = np.meshgrid(u, u)
    s = np.linspace(-radius, radius, samples)
    ds = s[1] - s[0]
    vals = jnp.asarray(np.asarray(per_cell, np.float32))
    img = np.zeros(npix * npix)
    base = (center[None, :] + U.ravel()[:, None] * ex[None, :]
            + V.ravel()[:, None] * ey[None, :])
    for si in s:  # chunk over depth to bound memory
        pos = base + si * k[None, :]
        c = np.asarray(grid.locate(jnp.asarray(pos, jnp.float32)))
        img += np.where(c >= 0, np.asarray(vals)[np.maximum(c, 0)], 0.0) * ds
    fitsio.write_fits(path, img.reshape(npix, npix).astype(np.float32),
                      {"PROJ": "parallel", "INCL": inclination,
                       "AZIM": azimuth})
    return path


def allsky_projection_form(path: str, grid, per_cell: np.ndarray,
                           position=(0.0, 0.0, 0.0), npix: int = 128,
                           samples: int = 192) -> str:
    """Mollweide FITS map of a per-cell field integrated along rays from
    an interior position (ref: AllSkyProjectionForm; e.g. all-sky optical
    depth when fed an opacity field)."""
    import jax.numpy as jnp
    lo = np.asarray(getattr(grid, "box_lo", None) if hasattr(grid, "box_lo")
                    else [grid.xb[0], grid.yb[0], grid.zb[0]], np.float64)
    hi = np.asarray(getattr(grid, "box_hi", None) if hasattr(grid, "box_hi")
                    else [grid.xb[-1], grid.yb[-1], grid.zb[-1]], np.float64)
    radius = float(np.linalg.norm(hi - lo))
    npy = npix // 2
    # pixel-center directions via the inverse Mollweide mapping
    xs = (np.arange(npix) + 0.5) / npix * 4.0 - 2.0
    ys = (np.arange(npy) + 0.5) / npy * 2.0 - 1.0
    X, Y = np.meshgrid(xs, ys)
    t = np.arcsin(np.clip(Y, -1, 1))
    lat = np.arcsin(np.clip((2 * t + np.sin(2 * t)) / np.pi, -1, 1))
    with np.errstate(invalid="ignore", divide="ignore"):
        lon = np.pi * X / (2 * np.cos(t))
    ok = np.abs(lon) <= np.pi
    lon = np.where(ok, lon, 0.0)
    k = np.stack([np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon),
                  np.sin(lat)], axis=-1).reshape(-1, 3)
    s = np.linspace(0.0, radius, samples)
    ds = s[1] - s[0]
    vals = np.asarray(per_cell, np.float64)
    img = np.zeros(npix * npy)
    p0 = np.asarray(position, np.float64)
    for si in s:
        pos = p0[None, :] + si * k
        c = np.asarray(grid.locate(jnp.asarray(pos, jnp.float32)))
        img += np.where(c >= 0, vals[np.maximum(c, 0)], 0.0) * ds
    img = np.where(ok.ravel(), img, 0.0)
    fitsio.write_fits(path, img.reshape(npy, npix).astype(np.float32),
                      {"PROJ": "mollweide-integral"})
    return path


def at_positions_form(path: str, grid, per_cell: np.ndarray,
                      positions: np.ndarray, unit_note: str = "") -> str:
    """Sample a per-cell field at imported positions (ref: AtPositionsForm,
    positions from a text column file)."""
    import jax.numpy as jnp
    pos = np.asarray(positions, np.float64)
    c = np.asarray(grid.locate(jnp.asarray(pos, jnp.float32)))
    vals = np.where(c >= 0, np.asarray(per_cell, np.float64)[
        np.maximum(c, 0)], 0.0)
    header = ("# skirt9_tpu at-positions probe\n# columns: x y z value"
              + ("\n# " + unit_note if unit_note else ""))
    with open(path, "w") as f:
        f.write(header + "\n")
        np.savetxt(f, np.column_stack([pos, vals]))
    return path


def linear_cut_form(path: str, grid, per_cell: np.ndarray, p0, p1,
                    npts: int = 512, unit_note: str = "") -> str:
    """Field values along the line p0 -> p1 (ref: LinearCutForm)."""
    import jax.numpy as jnp
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    f = np.linspace(0.0, 1.0, npts)
    pos = p0[None, :] + f[:, None] * (p1 - p0)[None, :]
    c = np.asarray(grid.locate(jnp.asarray(pos, jnp.float32)))
    vals = np.where(c >= 0, np.asarray(per_cell, np.float64)[
        np.maximum(c, 0)], 0.0)
    d = f * np.linalg.norm(p1 - p0)
    with open(path, "w") as fh:
        fh.write("# skirt9_tpu linear cut\n# columns: distance value"
                 + ("\n# " + unit_note if unit_note else "") + "\n")
        np.savetxt(fh, np.column_stack([d, vals]))
    return path


def meridional_cut_form(path: str, grid, per_cell: np.ndarray,
                        radius: float, azimuth: float = 0.0,
                        npts: int = 512, unit_note: str = "") -> str:
    """Field values along a meridian half-circle of given radius at fixed
    azimuth: inclination runs 0..pi (ref: MeridionalCutForm.hpp — the form
    samples the quantity at positions on a meridian through the poles)."""
    import jax.numpy as jnp
    theta = np.linspace(0.0, np.pi, npts)
    ca, sa = np.cos(azimuth), np.sin(azimuth)
    pos = np.stack([radius * np.sin(theta) * ca,
                    radius * np.sin(theta) * sa,
                    radius * np.cos(theta)], axis=-1)
    c = np.asarray(grid.locate(jnp.asarray(pos, jnp.float32)))
    vals = np.where(c >= 0, np.asarray(per_cell, np.float64)[
        np.maximum(c, 0)], 0.0)
    with open(path, "w") as fh:
        fh.write("# skirt9_tpu meridional cut\n"
                 "# columns: inclination [deg] value"
                 + ("\n# " + unit_note if unit_note else "") + "\n")
        np.savetxt(fh, np.column_stack([np.degrees(theta), vals]))
    return path


# ----------------------------------------------------------- more probes

def velocity_probe(sim, prefix: str, outdir: str = "."):
    """Per-cell bulk velocity components + magnitude
    (ref: VelocityProbe)."""
    v = np.asarray(sim.medium.bulk_v, np.float64)
    q = {"vx": v[:, 0], "vy": v[:, 1], "vz": v[:, 2],
         "v": np.linalg.norm(v, axis=1)}
    return [per_cell_form(os.path.join(outdir, f"{prefix}_velocity.dat"),
                          sim.grid, q, "bulk velocity [m/s]")]


def opticaldepth_map_probe(sim, lam: float, prefix: str, outdir: str = ".",
                           position=(0.0, 0.0, 0.0), npix: int = 128):
    """All-sky optical depth map from an interior position
    (ref: OpticalDepthMapProbe)."""
    import jax.numpy as jnp
    from ..media import system as msys
    med = sim.medium
    opt = msys.optics_at(med, jnp.full((1,), lam, jnp.float32))
    se = np.asarray(opt.sigma_ext, np.float64)[0]
    k = (np.asarray(med.nd, np.float64) * se).sum(axis=1)
    return [allsky_projection_form(
        os.path.join(outdir, f"{prefix}_taumap.fits"), sim.grid, k,
        position=position, npix=npix)]


def absorption_probe(sim, rf, prefix: str, outdir: str = "."):
    """Absorbed bolometric power per cell from the recorded radiation
    field (ref: DustAbsorptionPerCellProbe)."""
    from ..emission import equilibrium as eq
    if sim.rf_borders is None:
        return []
    etabs = eq.build_emission_tables(
        sim.medium, np.asarray(sim.rf_borders),
        np.asarray(sim.ems_borders if sim.ems_borders is not None
                   else sim.rf_borders))
    p_abs = np.asarray(eq.absorbed_power(
        sim.medium, etabs, rf, sim.grid.volumes(), sim.rf_scale), np.float64)
    return [per_cell_form(os.path.join(outdir, f"{prefix}_absorbed.dat"),
                          sim.grid, {"P_abs": p_abs},
                          "absorbed power [W]")]


def wavelength_grid_probe(sim, prefix: str, outdir: str = "."):
    """Instrument + radiation-field wavelength grids (ref:
    InstrumentWavelengthGridProbe, RadiationFieldWavelengthGridProbe)."""
    paths = []
    for cfg in sim.instruments:
        wb = np.asarray(getattr(cfg, "wave_borders", ()), np.float64)
        if len(wb) < 2:
            continue
        mid = np.sqrt(wb[1:] * wb[:-1])
        p = os.path.join(outdir, f"{prefix}_{cfg.name}_wavelengths.dat")
        with open(p, "w") as f:
            f.write("# instrument wavelength grid: center border_left "
                    "border_right [m]\n")
            np.savetxt(f, np.column_stack([mid, wb[:-1], wb[1:]]))
        paths.append(p)
    if sim.rf_borders is not None:
        rb = np.asarray(sim.rf_borders, np.float64)
        p = os.path.join(outdir, f"{prefix}_rf_wavelengths.dat")
        with open(p, "w") as f:
            f.write("# radiation-field wavelength grid borders [m]\n")
            np.savetxt(f, rb)
        paths.append(p)
    return paths


def source_density_probe(sim, prefix: str, outdir: str = "."):
    """Source geometry density resampled on the spatial grid
    (ref: SpatialGridSourceDensityProbe)."""
    paths = []
    centers = np.asarray(sim.grid.cell_centers(), np.float64)
    for i, s in enumerate(sim.sources):
        geom = getattr(s, "geometry", None)
        if geom is None or not hasattr(geom, "density_np"):
            continue
        rho = geom.density_np(centers)
        paths.append(per_cell_form(
            os.path.join(outdir, f"{prefix}_source_{i}_density.dat"),
            sim.grid, {"rho_norm": rho}, "normalized source density"))
    return paths


# ----------------------------------------------- probe system + When hooks

def grain_populations_probe(sim, prefix: str, outdir: str = "."):
    """Grain population summary: per size bin the composition, size range,
    grains/H and mass/H (ref: DustGrainPopulationsProbe)."""
    mg = getattr(sim, "grain_tables", None)
    if mg is None:
        return []
    p = os.path.join(outdir, f"{prefix}_grainpops.dat")
    with open(p, "w") as f:
        f.write("# grain populations: bin, composition, population, "
                "grains/H, mean grain mass [kg], mass/H [kg]\n")
        for b, lbl in enumerate(mg.labels):
            nb = float(mg.number_bin[b])
            mb = float(mg.mass_bin[b])
            f.write(f"{b} {lbl[0]} {lbl[1]} {nb:.6e} {mb:.6e} "
                    f"{nb * mb:.6e}\n")
    return [p]


def grain_size_distribution_probe(sim, prefix: str, outdir: str = ".",
                                  n_samples: int = 64):
    """Size-bin table: per bin the grains/H and mass/H (the discretized
    dn/da; ref: DustGrainSizeDistributionProbe)."""
    mg = getattr(sim, "grain_tables", None)
    if mg is None:
        return []
    p = os.path.join(outdir, f"{prefix}_grainsizes.dat")
    arr = np.column_stack([np.arange(len(mg.labels)),
                           np.asarray(mg.number_bin, np.float64),
                           np.asarray(mg.mass_bin, np.float64)])
    with open(p, "w") as f:
        f.write("# bin index, grains per H, mean grain mass [kg]\n")
        np.savetxt(f, arr)
    return [p]


def optical_material_properties_probe(sim, prefix: str, outdir: str = "."):
    """Per-component optical properties vs wavelength: sigma_ext, albedo,
    asymmetry g (ref: OpticalMaterialPropertiesProbe)."""
    med = sim.medium
    lam = np.asarray(med.lam_t, np.float64)
    se = np.asarray(med.sigma_ext, np.float64)
    ss = np.asarray(med.sigma_sca, np.float64)
    g = np.asarray(med.g, np.float64)
    paths = []
    for h in range(se.shape[0]):
        p = os.path.join(outdir, f"{prefix}_optprops_{h}.dat")
        alb = np.where(se[h] > 0, ss[h] / np.maximum(se[h], 1e-300), 0.0)
        with open(p, "w") as f:
            f.write("# wavelength [m], sigma_ext [m2/entity], albedo, g\n")
            np.savetxt(f, np.column_stack([lam, se[h], alb, g[h]]))
        paths.append(p)
    return paths


def secondary_luminosity_probe(sim, rf, prefix: str, outdir: str = "."):
    """Per-cell secondary (dust) bolometric luminosity
    (ref: SecondaryDustLuminosityProbe)."""
    from ..emission import equilibrium as eq
    etabs = eq.build_emission_tables(
        sim.medium, np.asarray(sim.rf_borders),
        np.asarray(sim.ems_borders if sim.ems_borders is not None
                   else sim.rf_borders))
    L = eq.dust_luminosities(sim.medium, etabs, rf, sim.rf_scale)
    return [per_cell_form(
        os.path.join(outdir, f"{prefix}_Lsec.dat"), sim.grid,
        {"L_dust": np.asarray(L, np.float64)},
        "secondary dust luminosity per cell [W]")]


def magnetic_field_probe(sim, prefix: str, outdir: str = "."):
    """Per-cell magnetic field vector (ref: MagneticFieldProbe)."""
    B = np.asarray(sim.medium.magnetic_field, np.float64)
    if not np.any(B):
        return []
    return [per_cell_form(
        os.path.join(outdir, f"{prefix}_B.dat"), sim.grid,
        {"Bx": B[:, 0], "By": B[:, 1], "Bz": B[:, 2]},
        "magnetic field [T]")]


def metallicity_probe(sim, prefix: str, outdir: str = "."):
    """Per-cell metallicity (ref: MetallicityProbe)."""
    Z = np.asarray(sim.medium.metallicity, np.float64)
    if not np.any(Z):
        return []
    return [per_cell_form(
        os.path.join(outdir, f"{prefix}_Z.dat"), sim.grid,
        {"Z": Z}, "metallicity (1)")]


def tree_topology_probe(sim, prefix: str, outdir: str = "."):
    """Persist tree-grid topology (ref: TreeSpatialGridTopologyProbe)."""
    from ..grids import octree as oct
    if not isinstance(sim.grid, getattr(oct, "OctreeGrid", ())):
        return []
    p = os.path.join(outdir, f"{prefix}_treetop.dat")
    oct.save_topology(sim.grid, p)
    return [p]


def imported_source_probe(sim, which: str, prefix: str, outdir: str = "."):
    """Imported-source entity properties, per entity and gridded per cell
    (ref: ImportedSourceAgeProbe / ...MetallicityProbe / ...VelocityProbe /
    ...DensityProbe / ...LuminosityProbe, SKIRT/core/ImportedSourceAgeProbe.hpp
    et al.: probe the entities of every ImportedSource, luminosity-weighted
    when averaging onto the spatial grid)."""
    out = []
    for si, src in enumerate(getattr(sim, "sources", [])):
        snap = getattr(src, "snapshot", None)
        if snap is None:
            continue
        pos = np.asarray(snap.positions, np.float64)
        n = len(pos)
        if which == "age" or which == "metallicity":
            params = getattr(src, "params", None)
            ft = getattr(src, "family_tables", None)
            if params is None or ft is None:
                continue
            names = [a[0].lower() for a in ft.family.param_axes]
            want = "t" if which == "age" else "z"
            if want not in names:
                continue
            q = np.asarray(params, np.float64)[:, names.index(want)]
            unit = "yr" if which == "age" else "1"
        elif which == "velocity":
            if snap.velocity is None:
                continue
            q = np.asarray(snap.velocity, np.float64)
            unit = "m/s"
        elif which == "luminosity":
            if hasattr(src, "family_tables"):
                q = np.asarray(src.family_tables.entity_luminosities(
                    src.scales, src.params), np.float64)
            elif hasattr(src, "luminosities"):
                q = np.asarray(src.luminosities, np.float64)
            else:
                continue
            unit = "W"
        elif which == "density":
            scales = getattr(src, "scales", None)
            if scales is None:
                scales = np.ones(n)
            q = np.asarray(scales, np.float64)
            unit = "scale"
        else:
            continue
        # per-entity table
        path = os.path.join(outdir, f"{prefix}_src{si}_{which}.dat")
        cols = [pos[:, 0], pos[:, 1], pos[:, 2]]
        hdr = f"imported source {si} {which} [{unit}]\n# x y z [m] value"
        if q.ndim == 2:
            cols += [q[:, k] for k in range(q.shape[1])]
        else:
            cols.append(q)
        with open(path, "w") as f:
            f.write(f"# {hdr}\n")
            np.savetxt(f, np.column_stack(cols))
        out.append(path)
        # gridded luminosity-weighted average (density: sum/volume)
        import jax.numpy as jnp
        cell = np.asarray(sim.grid.locate(jnp.asarray(pos, jnp.float32)))
        ok = cell >= 0
        nc = sim.grid.ncells
        if which == "density":
            tot = np.bincount(cell[ok], weights=q[ok], minlength=nc)
            gridded = {which: tot / np.asarray(sim.grid.volumes())}
        else:
            if hasattr(src, "family_tables"):
                w = np.asarray(src.family_tables.entity_luminosities(
                    src.scales, src.params), np.float64)
            elif hasattr(src, "luminosities"):
                w = np.asarray(src.luminosities, np.float64)
            else:
                w = np.ones(n)
            qs = q if q.ndim == 2 else q[:, None]
            wsum = np.bincount(cell[ok], weights=w[ok], minlength=nc)
            gridded = {}
            for k in range(qs.shape[1]):
                s = np.bincount(cell[ok], weights=(w * qs[:, k])[ok],
                                minlength=nc)
                key = which if qs.shape[1] == 1 else f"{which}_{'xyz'[k]}"
                gridded[key] = np.where(wsum > 0, s / np.maximum(wsum, 1e-300),
                                        0.0)
        out.append(per_cell_form(
            os.path.join(outdir, f"{prefix}_src{si}_{which}_cells.dat"),
            sim.grid, gridded,
            f"imported source {which} [{unit}], luminosity-weighted"))
    return out


def custom_state_probe(sim, prefix: str, outdir: str = "."):
    """Per-cell custom medium-state variables
    (ref: CustomStateProbe, SKIRT/core/CustomStateProbe.hpp: the values of
    custom state variables for each spatial cell). Sources: the
    Simulation.custom_state dict (imported variable-mix parameters, NonLTE
    level populations, recipe scratch state)."""
    cs = getattr(sim, "custom_state", None) or {}
    if not cs:
        return []
    q = {}
    for name, arr in cs.items():
        a = np.asarray(arr, np.float64)
        if a.ndim == 1:
            q[name] = a
        else:
            for k in range(a.shape[1]):
                q[f"{name}_{k}"] = a[:, k]
    return [per_cell_form(
        os.path.join(outdir, f"{prefix}_customstate.dat"), sim.grid, q,
        "custom medium state variables per cell")]


def line_luminosity_probe(sim, prefix: str, outdir: str = "."):
    """Integrated luminosity of every secondary line source
    (ref: IntegratedSecondaryLineLuminosityProbe: one row per line with
    its wavelength and the spatially integrated luminosity)."""
    lines = []
    pools = list(getattr(sim, "line_sources", []) or [])
    pools += [s for s in getattr(sim, "sources", [])
              if hasattr(s, "lam0") and hasattr(s, "luminosity")
              and hasattr(s, "spatial_bias")]
    for src in pools:
        lines.append((float(src.lam0), float(src.luminosity)))
    if not lines:
        return []
    path = os.path.join(outdir, f"{prefix}_linelums.dat")
    with open(path, "w") as f:
        f.write("# integrated secondary line luminosities\n"
                "# col 1: line wavelength [m]; col 2: luminosity [W]\n")
        np.savetxt(f, np.asarray(sorted(lines)))
    return [path]


def instrument_timegrid_probe(sim, prefix: str, outdir: str = "."):
    """Time-bin borders of instruments with a time axis
    (ref: InstrumentTimeGridProbe analog of the wavelength-grid probes)."""
    out = []
    for cfg in sim.instruments:
        tg = getattr(cfg, "time_borders", None)
        if tg is None or len(tg) == 0:
            continue
        path = os.path.join(outdir, f"{prefix}_{cfg.name}_timegrid.dat")
        tb = np.asarray(tg, np.float64)
        centers = 0.5 * (tb[1:] + tb[:-1])
        with open(path, "w") as f:
            f.write("# instrument time grid\n# col 1: bin center [s]; "
                    "col 2: left border [s]; col 3: right border [s]\n")
            np.savetxt(f, np.column_stack([centers, tb[:-1], tb[1:]]))
        out.append(path)
    return out


class ProbeSpec:
    """One configured probe: fires at a phase boundary (ref: Probe.hpp:40
    probeAfter Setup/Run + ProbeSystem hooks)."""

    def __init__(self, kind: str, name: str, when: str = "Setup", **kw):
        # (kinds map 1:1 onto reference probe classes; see ski.py _PROBES)
        self.kind = kind
        self.name = name
        self.when = when  # "Setup" | "Run" | "Primary" | "Secondary"
        self.kw = kw

    def run(self, sim, prefix: str, outdir: str, rf=None, it=None):
        tag = f"{prefix}_{self.name}"
        if it is not None:
            # per-iteration hook firings tag the output files with the
            # iteration index (ref: Probe::probePrimary/probeSecondary(it))
            tag = f"{tag}_it{it}"
        k = self.kind
        if k == "importedsource":
            return imported_source_probe(sim, self.kw.get("which", "age"),
                                         tag, outdir)
        if k == "customstate":
            return custom_state_probe(sim, tag, outdir)
        if k == "linelums":
            return line_luminosity_probe(sim, tag, outdir)
        if k == "instrtimegrid":
            return instrument_timegrid_probe(sim, tag, outdir)
        if k == "density":
            return density_probe(sim, tag, outdir, cuts=self.kw.get(
                "cuts", False))
        if k == "opacity":
            return opacity_probe(sim, self.kw.get("lam", 0.55e-6), tag,
                                 outdir)
        if k == "temperature":
            return [] if rf is None else temperature_probe(sim, rf, tag,
                                                           outdir)
        if k == "radiationfield":
            return [] if rf is None else radiation_field_probe(sim, rf,
                                                               tag, outdir)
        if k == "velocity":
            return velocity_probe(sim, tag, outdir)
        if k == "grid":
            return grid_probe(sim, tag, outdir)
        if k == "luminosity":
            return luminosity_probe(sim, tag, outdir)
        if k == "wavelengths":
            return wavelength_grid_probe(sim, tag, outdir)
        if k == "sourcedensity":
            return source_density_probe(sim, tag, outdir)
        if k == "taumap":
            return opticaldepth_map_probe(sim, self.kw.get("lam", 0.55e-6),
                                          tag, outdir,
                                          npix=self.kw.get("npix", 128))
        if k == "convergence":
            comps = [c for c in getattr(sim, "medium_components", [])
                     if c[0] is not None and c[2] is not None]
            return convergence_probe(sim, comps, tag, outdir) \
                if comps else []
        if k == "grainpops":
            return grain_populations_probe(sim, tag, outdir)
        if k == "grainsizes":
            return grain_size_distribution_probe(sim, tag, outdir)
        if k == "materialprops":
            return optical_material_properties_probe(sim, tag, outdir)
        if k == "secondaryluminosity":
            return [] if rf is None else secondary_luminosity_probe(
                sim, rf, tag, outdir)
        if k == "treetopology":
            return tree_topology_probe(sim, tag, outdir)
        if k == "magneticfield":
            return magnetic_field_probe(sim, tag, outdir)
        if k == "gastemperature":
            T = np.asarray(sim.medium.temperature, np.float64)
            if not np.any(T):
                return []
            return [per_cell_form(
                os.path.join(outdir, f"{tag}_gasT.dat"), sim.grid,
                {"T": T}, "imported gas temperature [K]")]
        if k == "metallicity":
            return metallicity_probe(sim, tag, outdir)
        if k == "absorption":
            return [] if rf is None else absorption_probe(sim, rf, tag,
                                                          outdir)
        if k == "inputmodel":
            import jax.numpy as jnp
            # probe the INPUT geometries (pre-gridding) on planar cuts
            # (ref: InputModelFormProbe — quantities from the input model
            # rather than the gridded medium state)
            comps = [c for c in getattr(sim, "medium_components", [])
                     if c[0] is not None]
            out = []
            for i, (geom, _, _) in enumerate(comps):
                out.append(planar_cut_form(
                    os.path.join(outdir, f"{tag}_input_{i}_xy.fits"),
                    sim.grid,
                    lambda pos, g=geom: jnp.asarray(
                        g.density_np(np.asarray(pos, np.float64))),
                    axis="z"))
            return out
        if k == "convergencecuts":
            import jax.numpy as jnp
            # gridded vs input density on midplane cuts
            # (ref: ConvergenceCutsProbe)
            comps = [c for c in getattr(sim, "medium_components", [])
                     if c[0] is not None]
            if not comps:
                return []
            nd = np.asarray(sim.medium.nd, np.float64)
            out = [planar_cut_form(
                os.path.join(outdir, f"{tag}_gridded_xy.fits"), sim.grid,
                cell_scalar_fn(sim.grid, nd.sum(axis=1)), axis="z")]
            geom = comps[0][0]
            out.append(planar_cut_form(
                os.path.join(outdir, f"{tag}_input_xy.fits"), sim.grid,
                lambda pos: jnp.asarray(
                    geom.density_np(np.asarray(pos, np.float64))),
                axis="z"))
            return out
        if k == "dustemissivity":
            # emissivity spectrum of the dust mix in scaled Mathis fields
            # (ref: DustEmissivityProbe — emissivity for a range of input
            # field strengths)
            from ..emission import equilibrium as eq
            if sim.rf_borders is None or sim.ems_borders is None:
                return []
            etabs = sim._emission_tables()
            rb = np.asarray(sim.rf_borders, np.float64)
            lam_c = np.sqrt(rb[1:] * rb[:-1])
            # Mathis-like U=1 field shape: lam J_lam ~ const in the optical
            J1 = 1e-6 / (lam_c * np.log(rb[-1] / rb[0]))
            rows = []
            sab = np.asarray(etabs.sigma_abs_rf, np.float64)
            for U in (0.1, 1.0, 10.0, 100.0):
                p_abs = (4 * np.pi * U * J1[None, :] * np.diff(rb)[None, :]
                         * sab).sum(axis=1)[None, :]
                T = eq.equilibrium_temperature(etabs, p_abs)
                ems = np.asarray(eq.cell_emission_spectra(
                    sim.medium, etabs,
                    np.tile(T, (sim.grid.ncells, 1))))[0]
                rows.append(ems)
            path = os.path.join(outdir, f"{tag}_emissivity.dat")
            lam_e = np.asarray(etabs.lam_ems, np.float64)
            with open(path, "w") as f:
                f.write("# dust emissivity for U = 0.1, 1, 10, 100 x "
                        "reference field\n# col 1: wavelength [m]; "
                        "cols 2-5: emissivity [W/m per H]\n")
                np.savetxt(f, np.column_stack([lam_e] + rows))
            return [path]
        if k == "cellprops":
            vols = np.asarray(sim.grid.volumes(), np.float64)
            nd = np.asarray(sim.medium.nd, np.float64)
            q = {"volume": vols}
            for h in range(nd.shape[1]):
                q[f"nd_{h}"] = nd[:, h]
            return [per_cell_form(
                os.path.join(outdir, f"{tag}_cellprops.dat"), sim.grid, q,
                "cell volume [m3], number densities [1/m3]")]
        return []


def run_probe_system(sim, when: str, prefix: str, outdir: str = ".",
                     rf=None, it=None) -> list:
    """Fire every configured probe whose hook matches `when`
    (ref: ProbeSystem::probeSetup/probeRun/probePrimary/probeSecondary,
    ProbeSystem.hpp:54-57). `it` is the 1-based iteration index for the
    Primary/Secondary hooks fired from the iteration flows."""
    paths = []
    for spec in getattr(sim, "probes", []) or []:
        if spec.when == when:
            paths.extend(spec.run(sim, prefix, outdir, rf=rf, it=it))
    return paths
