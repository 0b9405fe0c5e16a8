"""X-ray atomic gas: photo-absorption, fluorescence, electron scattering.

Batched counterpart of the reference's XRayAtomicGasMix (ref:
SKIRT/core/XRayAtomicGasMix.hpp:288, .cpp:54-160 resource loading,
Verner et al. 1996 analytic photo-absorption fits). The reference reads
its atomic data from resource files (XRay_PA.txt, XRay_FL.txt, XRay_CS/
SF/CP/IB.txt) that ship with resource packs; this module

  * implements the published Verner+96 analytic cross-section fit exactly
    (verner_sigma), with verified built-in ground-state parameters for
    H and He (thresholds 6.30 and 7.40 Mb reproduced to <1%),
  * accepts the reference's XRay_PA.txt / XRay_FL.txt column formats for
    the full 30-element data when the user supplies them
    (load_pa_file/load_fl_file — same loadStruct column layout),
  * builds MixTables over a wavelength grid: photo-absorption opacity per
    hydrogen atom plus free-electron (Klein-Nishina) scattering from the
    bound electron count — the reference's scatterBoundElectrons="Free"
    implementation (ref: XRayAtomicGasMix.hpp:294),
  * provides fluorescence-line sampling tables (sample_fluorescence) used
    when yield data is available: fluorescence is modeled as
    wavelength-changing scattering like the reference does.

Energies are handled in eV internally; lam = hc/E.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils import constants as c

EV = 1.602176634e-19           # J
HC_EV = c.H_PLANCK * c.C_LIGHT / EV   # [eV m]: E_eV = HC_EV / lam
MBARN = 1e-22                  # m^2 (1 Mb = 1e-18 cm^2)
SIGMA_T = 6.6524587321e-29     # Thomson cross section [m^2]


# --------------------------------------------------------- Verner+96 fits

@dataclasses.dataclass(frozen=True)
class ShellParams:
    """One electron-shell fit record (Verner, Ferland, Korista & Yakovlev
    1996, ApJ 465, 487; same fields as the reference's CrossSectionParams,
    XRayAtomicGasMix.cpp:79-97)."""

    Z: int          # atomic number
    n: int          # principal quantum number of the shell
    l: int          # orbital quantum number of the subshell
    Eth: float      # threshold energy [eV]
    Emax: float     # validity limit [eV]
    E0: float       # fit scale energy [eV]
    sigma0: float   # fit cross section [Mb]
    ya: float
    P: float
    yw: float
    y0: float
    y1: float


# ground-state parameters verified against published threshold values
BUILTIN_SHELLS = [
    # H I 1s: sigma(13.6 eV) = 6.30 Mb
    ShellParams(1, 1, 0, 13.5984, 5e4, 0.4298, 5.475e4, 32.88, 2.963,
                0.0, 0.0, 0.0),
    # He I 1s: sigma(24.59 eV) = 7.40 Mb
    ShellParams(2, 1, 0, 24.5874, 5e4, 13.61, 949.2, 1.469, 3.188,
                2.039, 0.4434, 2.136),
]

# Fe K-shell APPROXIMATE model (edge energy and fluorescence line/yield
# are published values; the cross-section fit shape is a calibrated
# power-law approximation, exact Verner coefficients ship with resource
# tables via load_pa_file). sigma(K edge+) ~ 3.5e-20 cm^2/atom with ~E^-2.7
# falloff reproduces tabulated Fe photo-absorption to tens of percent —
# good enough for demo/validation skis, clearly below resource-pack grade.
FE_K_SHELL = ShellParams(26, 1, 0, 7112.0, 3e5, 711.2, 21.66, 1e30, 1.6,
                         0.0, 0.0, 0.0)


def verner_sigma(E_eV: np.ndarray, p: ShellParams) -> np.ndarray:
    """Photo-ionization cross section [m^2] for one subshell at photon
    energies E_eV (Verner+96 eq. 1; ref: XRayAtomicGasMix.cpp
    crossSection lambda)."""
    E = np.asarray(E_eV, np.float64)
    x = E / p.E0 - p.y0
    y = np.sqrt(x * x + p.y1 * p.y1)
    # exponent Q = 5.5 + l - P/2 (Verner+96 eq. 1; the l term matters for
    # p/d subshells — round-5 fix, ref: XRayAtomicGasMix.cpp:134)
    Q = 5.5 + p.l - 0.5 * p.P
    F = ((x - 1.0) ** 2 + p.yw ** 2) \
        * np.power(np.maximum(y, 1e-300), -Q) \
        * np.power(1.0 + np.sqrt(np.maximum(y, 0.0) / p.ya), -p.P)
    sig = p.sigma0 * MBARN * F
    return np.where((E >= p.Eth) & (E < p.Emax), sig, 0.0)


def load_pa_file(path: str) -> list:
    """Parse the reference's XRay_PA.txt photo-absorption resource format:
    whitespace columns Z, n, l, Eth(eV), Emax(eV), E0(eV), sigma0(Mb),
    ya, P, yw, y0, y1 (ref: XRayAtomicGasMix.cpp:113-149 loadStruct with
    CrossSectionParams)."""
    rows = np.atleast_2d(np.loadtxt(path))
    return [ShellParams(int(r[0]), int(r[1]), int(r[2]), *r[3:12])
            for r in rows]


@dataclasses.dataclass(frozen=True)
class FluorescenceLine:
    """One fluorescence transition (ref: FluorescenceParams,
    XRayAtomicGasMix.cpp:100-109): vacancies in shell (Z, n, l) decay
    with probability `yield_` emitting at E_line [eV]."""

    Z: int
    n: int
    l: int
    yield_: float
    E_line: float
    width: float = 0.0  # Lorentzian width [eV] (0 = delta line)


# published Fe K fluorescence transitions (energies/yields well-known)
FE_K_LINES = [
    FluorescenceLine(26, 1, 0, 0.340, 6404.0),   # K-alpha
    FluorescenceLine(26, 1, 0, 0.045, 7058.0),   # K-beta
]


def load_fl_file(path: str) -> list:
    """Parse an XRay_FL.txt-shaped fluorescence table: columns Z, n, l,
    yield, E_line(eV) [, width(eV)]."""
    rows = np.atleast_2d(np.loadtxt(path))
    out = []
    for r in rows:
        w = r[5] if len(r) > 5 else 0.0
        out.append(FluorescenceLine(int(r[0]), int(r[1]), int(r[2]),
                                    float(r[3]), float(r[4]), float(w)))
    return out


# default solar-like abundances relative to H for Z=1..30 (Anders &
# Grevesse-style logarithmic abundances; the reference's default list,
# XRayAtomicGasMix.hpp:305 defaults to Table 2 of Anders & Grevesse 1989)
SOLAR_ABUNDANCES = 10.0 ** (np.array([
    12.00, 10.99, 1.16, 1.15, 2.6, 8.56, 8.05, 8.93, 4.56, 8.09,
    6.33, 7.58, 6.47, 7.55, 5.45, 7.21, 5.5, 6.56, 5.12, 6.36,
    3.10, 4.99, 4.00, 5.67, 5.39, 7.67, 4.92, 6.25, 4.21, 4.60,
]) - 12.00)


@dataclasses.dataclass(frozen=True)
class XRayTables:
    """Per-wavelength optics + fluorescence machinery for the mix."""

    lam: np.ndarray          # (T,) wavelength grid [m]
    sigma_abs: np.ndarray    # (T,) photo-absorption per H atom [m^2]
    sigma_sca: np.ndarray    # (T,) electron scattering per H atom [m^2]
    sigma_fluor: np.ndarray  # (T,) part of sigma_abs that fluoresces
    # fluorescence channel tables: per wavelength bin, cdf over lines and
    # the line wavelengths (zero lines -> empty)
    line_lam: np.ndarray     # (L,) emission wavelengths [m]
    line_cdf: np.ndarray     # (T, L) cumulative probability per energy bin

    @property
    def sigma_ext(self) -> np.ndarray:
        return self.sigma_abs + self.sigma_sca


def build_xray_tables(lam_grid: np.ndarray,
                      abundances: np.ndarray | None = None,
                      shells: list | None = None,
                      lines: list | None = None,
                      scatter: str = "Free") -> XRayTables:
    """Assemble the per-wavelength cross sections.

    abundances: (30,) number abundances relative to H (index Z-1);
    shells/lines: Verner fit records / fluorescence transitions (defaults:
    the built-in H+He set); scatter: 'None' or 'Free' (Klein-Nishina off
    the total bound electron count, the reference's Free mode)."""
    ab = np.asarray(abundances if abundances is not None
                    else SOLAR_ABUNDANCES, np.float64)
    shells = BUILTIN_SHELLS if shells is None else shells
    lines = [] if lines is None else lines
    lam = np.asarray(lam_grid, np.float64)
    E = HC_EV / lam                                        # [eV]

    sigma_abs = np.zeros_like(lam)
    sigma_fluor = np.zeros_like(lam)
    # per-line absorption contribution (for channel probabilities)
    per_line = np.zeros((len(lines), len(lam)))
    for p in shells:
        if p.Z - 1 >= len(ab) or ab[p.Z - 1] <= 0:
            continue
        s = ab[p.Z - 1] * verner_sigma(E, p)
        sigma_abs += s
        for li, fl in enumerate(lines):
            if (fl.Z, fl.n, fl.l) == (p.Z, p.n, p.l):
                per_line[li] += fl.yield_ * s
    if lines:
        sigma_fluor = per_line.sum(axis=0)
        tot = np.maximum(per_line.sum(axis=0), 1e-300)
        line_cdf = np.cumsum(per_line / tot, axis=0).T      # (T, L)
        line_lam = np.array([HC_EV / fl.E_line for fl in lines])
    else:
        line_cdf = np.zeros((len(lam), 0))
        line_lam = np.zeros(0)

    # electron scattering: Klein-Nishina per electron x electrons per H
    n_e = float(np.sum(ab * np.arange(1, len(ab) + 1)))
    if scatter == "Free":
        x = E / 510998.95                                  # E / m_e c^2
        # Klein-Nishina total cross section (exact)
        xs = np.maximum(x, 1e-12)
        kn = 0.75 * SIGMA_T * (
            (1 + xs) / xs ** 3 * (2 * xs * (1 + xs) / (1 + 2 * xs)
                                  - np.log1p(2 * xs))
            + np.log1p(2 * xs) / (2 * xs)
            - (1 + 3 * xs) / (1 + 2 * xs) ** 2)
        sigma_sca = n_e * kn
    else:
        sigma_sca = np.zeros_like(lam)

    return XRayTables(lam=lam, sigma_abs=sigma_abs, sigma_sca=sigma_sca,
                      sigma_fluor=sigma_fluor, line_lam=line_lam,
                      line_cdf=line_cdf)


def sample_fluorescence(tabs: XRayTables, lam_in: np.ndarray,
                        u: np.ndarray, rng_lorentz: np.ndarray | None = None,
                        lines: list | None = None) -> np.ndarray:
    """Sample fluorescence emission wavelengths for absorptions at lam_in
    (host/testing helper; the engine path gathers the same tables on
    device). u: uniform (B,). Returns lam_out (B,)."""
    lam_in = np.atleast_1d(lam_in)
    k = np.clip(np.searchsorted(tabs.lam, lam_in) - 1, 0, len(tabs.lam) - 1)
    cdf = tabs.line_cdf[k]                                 # (B, L)
    li = (cdf < u[:, None]).sum(axis=1)
    li = np.clip(li, 0, len(tabs.line_lam) - 1)
    lam_out = tabs.line_lam[li]
    if rng_lorentz is not None and lines:
        w = np.array([ln.width for ln in lines])[li]
        E0 = HC_EV / lam_out
        E = E0 + w * np.tan(np.pi * (rng_lorentz - 0.5)) \
            * (w > 0)
        lam_out = np.where(w > 0, HC_EV / np.maximum(E, 1.0), lam_out)
    return lam_out


# standard atomic weights for Z = 1..30 (mean mass per atom in amu)
ATOMIC_WEIGHTS = np.array([
    1.008, 4.003, 6.94, 9.012, 10.81, 12.011, 14.007, 15.999, 18.998,
    20.180, 22.990, 24.305, 26.982, 28.085, 30.974, 32.06, 35.45, 39.948,
    39.098, 40.078, 44.956, 47.867, 50.942, 51.996, 54.938, 55.845,
    58.933, 58.693, 63.546, 65.38])
AMU = 1.66053906660e-27  # kg


def device_tables(tabs: XRayTables) -> dict:
    """Device copies for the transport engine's X-ray branch
    (lifecycle TransportOptions.xray): channel cross sections vs wavelength
    plus fluorescence line sampling tables."""
    import jax.numpy as jnp
    return {
        "lam": jnp.asarray(tabs.lam, jnp.float32),
        "sigma_ext": jnp.asarray(tabs.sigma_ext, jnp.float32),
        "sigma_sca": jnp.asarray(tabs.sigma_sca, jnp.float32),
        "sigma_fluor": jnp.asarray(tabs.sigma_fluor, jnp.float32),
        "line_lam": jnp.asarray(tabs.line_lam, jnp.float32),
        "line_cdf": jnp.asarray(tabs.line_cdf, jnp.float32),
    }


def as_mix_tables(tabs: XRayTables, abundances: np.ndarray | None = None):
    """Wrap into the engine's MixTables (per-H-atom optics; mu = mean mass
    per hydrogen atom over the abundance set, so MassMaterialNormalization
    converts to H column like the reference)."""
    from . import mixes as mx
    ab = np.asarray(abundances if abundances is not None
                    else SOLAR_ABUNDANCES, np.float64)
    mu = float(np.sum(ab * ATOMIC_WEIGHTS[:len(ab)]) * AMU)
    # "scattering" includes the fluorescence channel (a wavelength-changing
    # scattering, ref: XRayAtomicGasMix performScattering channel list)
    albedo = (tabs.sigma_sca + tabs.sigma_fluor) \
        / np.maximum(tabs.sigma_ext, 1e-300)
    g = np.zeros_like(tabs.lam)  # KN sampling handles anisotropy via the
    #                              compton option; HG fallback isotropic
    mix = mx.tabulated(tabs.lam, tabs.sigma_ext, albedo, g, mu=mu)
    object.__setattr__(mix, "_xray", tabs)
    return mix
