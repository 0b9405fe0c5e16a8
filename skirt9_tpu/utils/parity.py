"""Parity of this engine's outputs with the SKIRT 9 reference goldens.

The goldens in tests/golden/ are outputs of the reference binary on the
same ski files (BASELINE.md configs 1-7). This module holds every
comparison and tolerance against them in one place: the reference-parity
tests and chip_smoke.py both call it, so a tolerance changes in one spot.

Each comparison returns `Check`s: a named measured quantity beside the
limit it must meet. SED columns are read by name from the
`# column k: ...` headers, so this engine's layout and the reference's
(which adds transparent-secondary and transparent-Stokes columns) compare
directly; both are in the ski file's output units (ExtragalacticUnits for
every golden: micron and W/m2/micron).
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import re

import numpy as np

GOLDEN_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "tests", "golden")

BENCHES = ("bench1", "bench1h", "bench2", "bench3", "bench4", "bench5",
           "bench6", "bench7")

_PC = 3.0857e16

# header description -> column key (both layouts)
_COLUMN_KEYS = {
    "wavelength": "wavelength",
    "total flux": "total",
    "transparent flux": "transparent",
    "direct primary flux": "primarydirect",
    "scattered primary flux": "primaryscattered",
    "direct secondary flux": "secondarydirect",
    "scattered secondary flux": "secondaryscattered",
    "total Stokes Q": "Q",
    "total Stokes U": "U",
    "total Stokes V": "V",
}


@dataclasses.dataclass(frozen=True)
class Check:
    """One comparison: `value` measured, `limit` the bound it must meet
    (`ok` says whether it did)."""

    name: str
    value: float
    limit: float
    ok: bool

    def __str__(self) -> str:
        return (f"{self.name}={self.value:.4g} (limit {self.limit:.4g}) "
                f"{'ok' if self.ok else 'FAIL'}")


def below(name: str, value, limit: float) -> Check:
    value = float(value)
    return Check(name, value, limit, bool(value < limit))


def above(name: str, value, limit: float) -> Check:
    value = float(value)
    return Check(name, value, limit, bool(value > limit))


def rel_dev(name: str, ours, ref, limit: float) -> Check:
    """|ours/ref - 1| below limit."""
    return below(name, abs(float(ours) / float(ref) - 1.0), limit)


def read_sed(path: str) -> dict:
    """SED text file -> {column key: (nlam,) array}, keyed from its
    `# column k: <description>; ...` header lines."""
    keys = {}
    with open(path) as f:
        for line in f:
            m = re.match(r"#\s*column\s+(\d+):\s*([^;]+);", line)
            if m and m.group(2).strip() in _COLUMN_KEYS:
                keys[_COLUMN_KEYS[m.group(2).strip()]] = int(m.group(1)) - 1
    data = np.loadtxt(path, ndmin=2)
    return {k: data[:, i] for k, i in keys.items()}


def golden_sed(bench: str) -> dict:
    return read_sed(os.path.join(GOLDEN_DIR, f"{bench}_i0_sed.dat"))


def _median_ratio(ours, ref, frac: float, absolute: bool = False):
    r = np.abs(ref) if absolute else ref
    hi = r > frac * r.max()
    return float(np.median(ours[hi] / ref[hi]))


def _panchromatic(ours, ref, tols, total_tol):
    """Dust-emission SEDs: median ratio of each component over the bins
    above 5% of its peak, plus the integrated total flux."""
    lam_dev = float(np.max(np.abs(ours["wavelength"] / ref["wavelength"]
                                  - 1.0)))
    checks = [below("wavelength_grid", lam_dev, 1e-3)]
    for key, tol in tols:
        checks.append(below(f"{key}_median_ratio_dev",
                            abs(_median_ratio(ours[key], ref[key], 0.05)
                                - 1.0), tol))
    lam = ref["wavelength"]
    checks.append(rel_dev("total_integral",
                          np.trapezoid(ours["total"], lam),
                          np.trapezoid(ref["total"], lam), total_tol))
    return checks


def sed_checks(bench: str, ours: dict, ref: dict | None = None) -> list:
    """Compare this engine's SED columns with the reference golden."""
    ref = golden_sed(bench) if ref is None else ref
    if bench == "bench1":
        return [rel_dev("transparent", ours["transparent"][0],
                        ref["transparent"][0], 2e-3),
                # deterministic extinction along the observer axis; small
                # discretization differences between the grid builders
                rel_dev("primarydirect", ours["primarydirect"][0],
                        ref["primarydirect"][0], 0.02),
                # Monte Carlo noise of both runs
                rel_dev("primaryscattered", ours["primaryscattered"][0],
                        ref["primaryscattered"][0], 0.05)]
    if bench == "bench1h":
        t, d = ours["transparent"][0], ours["primarydirect"][0]
        gt, gd = ref["transparent"][0], ref["primarydirect"][0]
        return [rel_dev("transparent", t, gt, 2e-3),
                # direct = transparent * exp(-tau_obs), tau_obs ~ 10: a ~1%
                # grid tau difference moves the flux by ~10%
                rel_dev("primarydirect", d, gd, 0.3),
                rel_dev("log_direct_over_transparent", np.log(d / t),
                        np.log(gd / gt), 0.02),
                rel_dev("primaryscattered", ours["primaryscattered"][0],
                        ref["primaryscattered"][0], 0.1)]
    if bench == "bench2":
        return _panchromatic(ours, ref, (("transparent", 0.05),
                                         ("primarydirect", 0.1),
                                         ("primaryscattered", 0.25),
                                         ("secondarydirect", 0.25)), 0.1)
    if bench == "bench3":
        return _panchromatic(ours, ref, (("transparent", 0.05),
                                         ("primarydirect", 0.2),
                                         ("primaryscattered", 0.25),
                                         ("secondarydirect", 0.25)), 0.15)
    if bench == "bench4":
        return _panchromatic(ours, ref, (("transparent", 0.05),
                                         ("primarydirect", 0.1),
                                         ("primaryscattered", 0.15),
                                         ("secondarydirect", 0.15)), 0.1)
    if bench == "bench5":
        mr = lambda k: _median_ratio(ours[k], ref[k], 0.1, absolute=True)
        p_ours = np.median(ours["Q"] / np.maximum(ours["primaryscattered"],
                                                  1e-300))
        p_ref = np.median(ref["Q"] / np.maximum(ref["primaryscattered"],
                                                1e-300))
        max_v = float(np.max(np.abs(ours["V"])))
        return [below("transparent_median_ratio_dev",
                      abs(mr("transparent") - 1), 0.02),
                below("primarydirect_median_ratio_dev",
                      abs(mr("primarydirect") - 1), 0.02),
                below("total_median_ratio_dev", abs(mr("total") - 1), 0.02),
                below("primaryscattered_median_ratio_dev",
                      abs(mr("primaryscattered") - 1), 0.05),
                below("stokesQ_median_ratio_dev", abs(mr("Q") - 1), 0.15),
                rel_dev("polarization_degree", p_ours, p_ref, 0.15),
                # U consistent with zero: well below Q
                below("U_over_Q", np.median(np.abs(ours["U"]))
                      / np.median(np.abs(ours["Q"])), 0.1),
                # Thomson scattering cannot produce V
                Check("max_abs_V", max_v, 0.0, max_v == 0.0)]
    if bench == "bench6":
        lam, tot = ours["wavelength"], ours["total"]
        rtot = ref["total"]
        i0 = int(np.argmin(np.abs(lam - 0.1215670)))
        m = rtot > 1e-2 * rtot.max()
        rel = np.abs(tot[m] - rtot[m]) / rtot.max()
        # each peak's position; the golden's two peaks differ by 0.5% in
        # height (noise at 1e6 packets), so which one is higher is not a
        # property to compare
        blue = abs(int(np.argmax(tot[:i0])) - int(np.argmax(rtot[:i0])))
        red = abs(int(np.argmax(tot[i0:])) - int(np.argmax(rtot[i0:])))
        return [below("core_over_peak", tot[i0] / tot.max(), 1e-4),
                Check("blue_peak_bin_offset", blue, 1, blue <= 1),
                Check("red_peak_bin_offset", red, 1, red <= 1),
                rel_dev("escaped_energy", np.trapezoid(tot, lam),
                        np.trapezoid(rtot, ref["wavelength"]), 0.05),
                below("profile_median_dev", np.median(rel), 0.02),
                below("profile_max_dev", rel.max(), 0.15),
                below("direct_core_over_peak",
                      ours["primarydirect"][i0] / tot.max(), 1e-6)]
    if bench == "bench7":
        lam = ref["wavelength"]
        transp, direct = ours["transparent"], ours["primarydirect"]
        scat = ours["primaryscattered"]
        r_transp, r_direct = ref["transparent"], ref["primarydirect"]
        # the reference tags fluorescence as SECONDARY components; this
        # engine records it as primary scattered
        r_scat = (ref["primaryscattered"] + ref["secondarydirect"]
                  + ref["secondaryscattered"])
        e_kev = 1.23984193e-3 / lam
        i1 = int(np.argmin(np.abs(e_kev - 1.0)))
        ika = int(np.argmin(np.abs(e_kev - 6.4)))
        cont_o = 0.5 * (scat[ika - 2] + scat[ika + 2])
        cont_r = 0.5 * (r_scat[ika - 2] + r_scat[ika + 2])
        return [below("transparent_median_ratio_dev",
                      abs(_median_ratio(transp, r_transp, 0.05) - 1), 0.02),
                below("primarydirect_median_ratio_dev",
                      abs(_median_ratio(direct, r_direct, 0.05) - 1), 0.05),
                # photo-absorption optical depth at 1 keV (tau ~ 4.9)
                rel_dev("tau_1keV", -np.log(direct[i1] / transp[i1]),
                        -np.log(r_direct[i1] / r_transp[i1]), 0.05),
                rel_dev("scattered_integral", np.trapezoid(scat, lam),
                        np.trapezoid(r_scat, lam), 0.10),
                above("FeKa_over_continuum", scat[ika] / cont_o, 1.5),
                above("reference_FeKa_over_continuum", r_scat[ika] / cont_r,
                      1.5),
                rel_dev("FeKa_line", scat[ika] - cont_o, r_scat[ika] - cont_r,
                        0.30)]
    raise KeyError(f"no golden comparison for {bench!r}")


def _loadgz(name: str) -> np.ndarray:
    with gzip.open(os.path.join(GOLDEN_DIR, name), "rt") as f:
        return np.loadtxt(f)


def rf_checks(bench: str, sim, rf) -> list:
    """Radiation-field parity (path-length sums rf in rf_scale units)."""
    if bench not in ("bench2", "bench3"):
        return []
    rb = np.asarray(sim.rf_borders, np.float64)
    dlam = np.diff(rb)
    rf64 = np.asarray(rf, np.float64)
    if bench == "bench2":
        # per-cell mean intensity vs the reference's RadiationFieldProbe
        ref_j = _loadgz("bench2_rf_J.dat.gz")[:, 1:]      # W/m2/micron/sr
        vols = np.asarray(sim.grid.volumes(), np.float64)
        ours_j = (rf64 * sim.rf_scale
                  / (4 * np.pi * vols[:, None] * dlam[None, :])) * 1e-6
        tot_r, tot_o = ref_j.sum(axis=0), ours_j.sum(axis=0)
        hi = tot_r > 0.02 * tot_r.max()
        bol_r = (ref_j * dlam[None, :] * 1e6).sum(axis=1)
        bol_o = (ours_j * dlam[None, :] * 1e6).sum(axis=1)
        sel = bol_r > np.percentile(bol_r, 50)
        cc = np.corrcoef(np.log(bol_r[sel]),
                         np.log(np.maximum(bol_o[sel], 1e-300)))[0, 1]
        return [below("rf_bin_median_ratio_dev",
                      abs(np.median(tot_o[hi] / tot_r[hi]) - 1), 0.1),
                # our own two seeds correlate at ~0.92 at the parity test's
                # packet count (the golden has 30x more packets)
                above("rf_bolometric_log_correlation", cc, 0.93)]
    # bench3, grid-independent: volume integral of J per RF bin
    ref_j = _loadgz("bench3_rf_J.dat.gz")[:, 1:]
    v_ref = _loadgz("bench3_cellprops.dat.gz")[:, 4] * _PC ** 3
    jv_ours = (rf64 * sim.rf_scale
               / (4 * np.pi * dlam[None, :])).sum(axis=0) * 1e-6
    jv_ref = (ref_j * v_ref[:, None]).sum(axis=0)
    hi = jv_ref > 0.02 * jv_ref.max()
    return [below("rf_volume_integral_median_ratio_dev",
                  abs(np.median(jv_ours[hi] / jv_ref[hi]) - 1), 0.1)]


def temperature_checks(bench: str, sim, rf) -> list:
    """Indicative dust temperature parity per cell."""
    if bench == "bench2":
        t_ref = np.loadtxt(os.path.join(GOLDEN_DIR,
                                        "bench2_T_dust_T.dat"))[:, 1]
        t_ours = np.asarray(sim.dust_temperature(rf))[:, 0]
        sel = t_ref > 1.0
        return [below("T_median_ratio_dev",
                      abs(np.median(t_ours[sel] / t_ref[sel]) - 1), 0.05)]
    if bench not in ("bench3", "bench4"):
        return []
    props = _loadgz(f"{bench}_cellprops.dat.gz")
    t_ref = np.loadtxt(os.path.join(GOLDEN_DIR,
                                    f"{bench}_T_dust_T.dat"))[:, 1]
    centers = props[:, 1:4] * _PC
    rho = props[:, 6]                     # dust mass density
    t_cells = np.asarray(sim.dust_temperature(rf))[:, 0]
    checks = []
    if bench == "bench3":
        # the two codes build different octrees: evaluate ours at the
        # reference's cell centres
        import jax.numpy as jnp
        idx = np.asarray(sim.grid.locate(jnp.asarray(centers, jnp.float32)))
        ok = (idx >= 0) & (rho > 0) & (t_ref > 1.0)
        t_at = t_cells[np.maximum(idx, 0)]
    else:
        # same Voronoi sites on both sides: nearest-site match
        from scipy.spatial import cKDTree
        _, idx = cKDTree(np.asarray(sim.grid.sites, np.float64)).query(
            centers)
        t_at = t_cells[idx]
        ok = (rho > 0) & (t_ref > 1.0) & (t_at > 1.0)
        checks.append(above("T_cells_compared", ok.sum(), 1000))
    w = (rho * props[:, 4])[ok]
    checks += [below("T_median_ratio_dev",
                     abs(np.median(t_at[ok] / t_ref[ok]) - 1), 0.08),
               rel_dev("T_mass_weighted", np.sum(t_at[ok] * w) / w.sum(),
                       np.sum(t_ref[ok] * w) / w.sum(), 0.08)]
    return checks
