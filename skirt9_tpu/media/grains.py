"""Multi-grain dust mixes: size distributions, grain optics, populations.

Batched counterpart of the reference's MultiGrainDustMix pipeline
(ref: SKIRT/core/MultiGrainDustMix.hpp:108, GrainComposition.hpp:54,
GrainSizeDistribution.hpp:33, GrainPopulation): optical properties are
integrated over grain populations (composition x size distribution x size
bins) into

  * representative-grain MixTables for the transport engine (one row of
    sigma_ext/albedo/g per medium component), and
  * per-size-bin absorption cross sections + enthalpy data consumed by the
    equilibrium and stochastic dust-emission calculators
    (ref: EquilibriumDustEmissionCalculator.hpp:55,
     StochasticDustEmissionCalculator.hpp:87).

All of this is host-side table construction (numpy, runs once at setup); the
results are dense device tables, so nothing here touches the hot path.

The reference reads grain optical properties (Q_abs, Q_sca, g vs size and
wavelength) from versioned resource packs that are not redistributable in
this repo. Optical data therefore comes from, in order of fidelity:

  1. user-provided files of (a, lam) -> Q_abs/Q_sca/g tables (exact parity
     with any reference resource a user exports),
  2. user-provided complex refractive index n,k files + the built-in Mie
     solver below,
  3. built-in *documented approximate* n,k models for astronomical silicate
     and graphite/PAH (correct feature positions and broad shape; stand-ins
     adequate for engine validation, replaceable without code changes).

Grain enthalpies use the published Draine & Li 2001 analytic heat
capacities (their eqs. 9-11), which the reference also builds on.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from ..utils import constants as c
from .mixes import MixTables

# --------------------------------------------------------------------- Mie

def mie_q(m: complex | np.ndarray, x: np.ndarray):
    """Mie efficiencies for homogeneous spheres (Bohren & Huffman algorithm,
    vectorized over size parameter x; m may be scalar or broadcast with x).

    Returns (Q_ext, Q_sca, g). Host-side numpy; used only at setup to build
    tables (the reference ships precomputed Q tables in resource packs).
    """
    x = np.atleast_1d(np.asarray(x, np.float64))
    m = np.asarray(m, np.complex128)
    m = np.broadcast_to(m, x.shape).copy()
    x = np.maximum(x, 1e-8)
    nmax_e = np.ceil(x + 4.0 * x ** (1.0 / 3.0) + 2.0).astype(int)
    nmax = int(np.max(nmax_e))
    mx = m * x
    # logarithmic derivative D_n(mx) by downward recurrence
    # (iteration at index n yields D_{n-1} from D_n)
    nstart = nmax + 16
    D = np.zeros(x.shape, np.complex128)
    Dlist = [None] * (nmax + 1)
    for n in range(nstart, 1, -1):
        D = n / mx - 1.0 / (D + n / mx)
        if n - 1 <= nmax:
            Dlist[n - 1] = D.copy()
    # Riccati-Bessel psi, chi by upward recurrence; lanes past their own
    # nmax are frozen (chi overflows there otherwise)
    psi0 = np.cos(x)   # psi_{-1}
    psi1 = np.sin(x)   # psi_0
    chi0 = -np.sin(x)  # chi_{-1}
    chi1 = np.cos(x)   # chi_0
    qext = np.zeros_like(x)
    qsca = np.zeros_like(x)
    gsum = np.zeros_like(x)
    a_prev = np.zeros(x.shape, np.complex128)
    b_prev = np.zeros(x.shape, np.complex128)
    with np.errstate(over="ignore", invalid="ignore"):
        for n in range(1, nmax + 1):
            live = n <= nmax_e
            psi = (2 * n - 1) / x * psi1 - psi0
            chi = (2 * n - 1) / x * chi1 - chi0
            xi1 = psi1 - 1j * chi1
            xi = psi - 1j * chi
            Dn = Dlist[n]
            da = Dn / m + n / x
            db = Dn * m + n / x
            an = np.where(live, (da * psi - psi1) / (da * xi - xi1), 0.0)
            bn = np.where(live, (db * psi - psi1) / (db * xi - xi1), 0.0)
            an = np.nan_to_num(an)
            bn = np.nan_to_num(bn)
            f = 2 * n + 1
            qext += f * (an.real + bn.real)
            qsca += f * (np.abs(an) ** 2 + np.abs(bn) ** 2)
            if n > 1:
                k = n - 1.0
                gsum += (k * (k + 2) / (k + 1)
                         * (a_prev * np.conj(an) + b_prev * np.conj(bn)).real)
                # only for lanes whose own series extends past k (else the
                # `last` line below already counted their a_k b_k* term)
                gsum += np.where(n - 1 < nmax_e,
                                 (2 * k + 1) / (k * (k + 1))
                                 * (a_prev * np.conj(b_prev)).real, 0.0)
            # final a_n b_n* cross term for each lane at its own nmax
            last = n == nmax_e
            gsum += np.where(last,
                             f / (n * (n + 1.0)) * (an * np.conj(bn)).real, 0.0)
            a_prev, b_prev = an, bn
            cap = 1e150
            psi0 = np.clip(psi1, -cap, cap)
            psi1 = np.clip(psi, -cap, cap)
            chi0 = np.clip(chi1, -cap, cap)
            chi1 = np.clip(chi, -cap, cap)
    x2 = x * x
    qext = 2.0 / x2 * qext
    qsca = np.minimum(2.0 / x2 * qsca, qext)
    g = np.where(qsca > 1e-12, 4.0 / (x2 * np.maximum(qsca, 1e-300)) * gsum, 0.0)
    return qext, qsca, np.clip(g, -1.0, 1.0)


# ------------------------------------------------ refractive index models

def nk_silicate_approx(lam: np.ndarray) -> np.ndarray:
    """Approximate complex refractive index of astronomical silicate:
    UV absorption rise, transparent optical window, 9.7 and 18 micron
    Si-O lattice features (Lorentz oscillators), FIR k ~ lam^-1 decline.
    Documented stand-in for the Draine 2003 resource table
    (ref: DraineSilicateGrainComposition)."""
    l_um = np.asarray(lam) * 1e6
    n = np.full_like(l_um, 1.7)
    # Lorentz oscillators at 9.7 and 18 um contribute to both n and k
    def lorentz(l0, gamma, s):
        w = 1.0 / l_um
        w0 = 1.0 / l0
        d = (w0**2 - w**2) - 1j * gamma * w * w0
        return s * w0**2 / d
    eps = (1.7 + 0.03j) ** 2 + lorentz(9.7, 0.10, 1.2) + lorentz(18.0, 0.15, 0.8)
    # UV rise in k below 0.25 um
    k_uv = 0.8 * np.exp(-((np.log(l_um / 0.10)) ** 2) / 1.0)
    m = np.sqrt(eps)
    k = np.abs(m.imag) + k_uv + 0.02 / np.maximum(l_um, 1e-3)
    return m.real + 1j * np.maximum(k, 1e-4)


def nk_graphite_approx(lam: np.ndarray) -> np.ndarray:
    """Approximate graphite ("1/3 - 2/3" isotropic): strong 2175 A pi-plasmon
    Drude feature, metallic-like FIR behavior. Stand-in for the Draine 2003
    graphite tables (ref: DraineGraphiteGrainComposition)."""
    l_um = np.asarray(lam) * 1e6
    x = 1.0 / l_um  # inverse microns
    x0, gam = 4.6, 1.1
    drude = 3.0 * x0**2 / ((x0**2 - x**2) - 1j * gam * x)
    eps = (2.3 + 1.0j) ** 2 + drude
    m = np.sqrt(eps)
    k = np.abs(m.imag) + 0.15 * np.maximum(l_um, 1.0) ** 0.5
    return np.abs(m.real) + 1j * k


# ---------------------------------------------------------- heat capacity

def _debye_fprime(n: int, x: np.ndarray) -> np.ndarray:
    """d/dx [ x^n * n * int_0^1 y^n dy / (exp(y/x)-1) ]-style Debye-model
    specific heat term f'_n(x) of Draine & Li 2001 eq. 10:
        f_n(x) = n * int_0^1 y^n / (exp(y/x) - 1) dy ;  returns d f_n/dx * x ...
    Implemented directly as the specific-heat integral
        f'_n(x) = n * int_0^1 (y/x)^2 y^n e^{y/x} / (e^{y/x}-1)^2 dy.
    """
    y = np.linspace(1e-6, 1.0, 400)
    x = np.atleast_1d(x)
    yx = y[None, :] / x[:, None]
    # x e^x/(e^x-1)^2 = x / (4 sinh^2(x/2)) -> ~x e^-x for large x; cut at 50
    small = yx < 50.0
    yxs = np.where(small, yx, 1.0)
    val = np.where(small,
                   yxs**2 / (4.0 * np.sinh(yxs / 2.0) ** 2), 0.0)
    integ = (y[None, :] ** n) * val
    return n * np.trapezoid(integ, y, axis=-1)


def enthalpy_graphite(T: np.ndarray, natoms: float) -> np.ndarray:
    """Grain enthalpy [J] vs temperature for graphite/PAH with N carbon
    atoms — Draine & Li 2001 eq. 9: C/(N k) = f'_2(T/863K) + 2 f'_3(T/2504K),
    integrated over T."""
    Tg = np.geomspace(0.1, max(np.max(T) * 1.05, 1.0), 600)
    C = (natoms - 2) * c.K_BOLTZMANN * (_debye_fprime(2, Tg / 863.0)
                                + 2.0 * _debye_fprime(3, Tg / 2504.0))
    U = np.concatenate([[0.0], np.cumsum(0.5 * (C[1:] + C[:-1]) * np.diff(Tg))])
    return np.interp(T, Tg, U)


def enthalpy_silicate(T: np.ndarray, natoms: float) -> np.ndarray:
    """Draine & Li 2001 eq. 11: C/((N-2) k) = 2 f'_2(T/500K) + f'_3(T/1500K)."""
    Tg = np.geomspace(0.1, max(np.max(T) * 1.05, 1.0), 600)
    C = (natoms - 2) * c.K_BOLTZMANN * (2.0 * _debye_fprime(2, Tg / 500.0)
                                + _debye_fprime(3, Tg / 1500.0))
    U = np.concatenate([[0.0], np.cumsum(0.5 * (C[1:] + C[:-1]) * np.diff(Tg))])
    return np.interp(T, Tg, U)


# ------------------------------------------------------------ compositions

@dataclasses.dataclass(frozen=True)
class GrainComposition:
    """Optical + calorimetric properties of one grain material
    (ref: GrainComposition.hpp:54). `q_tables(a, lam)` returns
    (Q_abs, Q_sca, g) arrays of shape (len(a), len(lam))."""

    name: str
    bulk_density: float                      # [kg/m^3]
    atomic_mass: float                       # mean atomic mass [kg] for enthalpy
    q_tables: Callable[[np.ndarray, np.ndarray], tuple]
    enthalpy: Callable[[np.ndarray, float], np.ndarray]  # (T, natoms) -> U [J]


def _mie_composition(name: str, nk_fn, rho: float, amass: float,
                     enthalpy_fn) -> GrainComposition:
    def q_tables(a, lam):
        a = np.asarray(a)
        lam = np.asarray(lam)
        m = nk_fn(lam)  # (L,)
        x = 2.0 * np.pi * a[:, None] / lam[None, :]
        # cap x: geometric-optics limit beyond x~100 (Q_ext->2)
        xc = np.minimum(x, 100.0)
        qe = np.empty(x.shape)
        qs = np.empty(x.shape)
        gg = np.empty(x.shape)
        for i in range(a.size):
            qe[i], qs[i], gg[i] = mie_q(m, xc[i])
        big = x > 100.0
        # geometric-optics limit: Q_ext -> 2; Q_sca keeps its value computed
        # at the capped x=100 (a reasonable large-x plateau for these n,k)
        qe = np.where(big, 2.0, qe)
        qa = np.maximum(qe - qs, 0.0)
        return qa, qs, gg

    return GrainComposition(name=name, bulk_density=rho, atomic_mass=amass,
                            q_tables=q_tables, enthalpy=enthalpy_fn)


def silicate_composition() -> GrainComposition:
    """Astronomical silicate (approximate n,k + Mie; rho=3500 kg/m3,
    mean atomic mass ~ 172/7 amu as in MgFeSiO4)."""
    return _mie_composition("Silicate", nk_silicate_approx, 3500.0,
                            172.0 / 7.0 * 1.6605e-27, enthalpy_silicate)


def graphite_composition() -> GrainComposition:
    return _mie_composition("Graphite", nk_graphite_approx, 2240.0,
                            12.0 * 1.6605e-27, enthalpy_graphite)


# exact named grain compositions: resource names + bulk densities
# (ref: GrainComposition.hpp:72/114 resourceNameForOpticalProps/
# Enthalpies; concrete values from DraineSilicateGrainComposition.cpp:32-42
# et al.). Install a SKIRT9 resource pack (SKIRT9_TPU_RESOURCES) for the
# exact tables; the approximate Mie built-ins remain the fallback.
NAMED_COMPOSITIONS = {
    "DraineSilicateGrainComposition":
        ("DraineSilicateOpticalProps", "DraineSilicateEnthalpies",
         3000.0, 172.0 / 7.0),
    "DraineGraphiteGrainComposition":
        ("DraineGraphiteOpticalProps", "DraineGraphiteEnthalpies",
         2240.0, 12.0),
    "DraineNeutralPAHGrainComposition":
        ("DraineNeutralPAHOpticalProps", "DraineGraphiteEnthalpies",
         2240.0, 12.0),
    "DraineIonizedPAHGrainComposition":
        ("DraineIonizedPAHOpticalProps", "DraineGraphiteEnthalpies",
         2240.0, 12.0),
    "MieSilicateGrainComposition":
        ("MieSilicateOpticalProps", "DraineSilicateEnthalpies",
         3000.0, 172.0 / 7.0),
    "TrustSilicateGrainComposition":
        ("TrustSilicateOpticalProps", "TrustSilicateEnthalpies",
         3500.0, 172.0 / 7.0),
    "TrustGraphiteGrainComposition":
        ("TrustGraphiteOpticalProps", "TrustGraphiteEnthalpies",
         2240.0, 12.0),
    "TrustNeutralPAHGrainComposition":
        ("TrustBenchmarkNeutralPAHOpticalProps",
         "TrustBenchmarkGraphiteEnthalpies", 2240.0, 12.0),
    # laboratory mineral species (DustEM aSil calorimetry like the
    # reference; ref: BegemannPorousAluminaGrainComposition.cpp:32-42 et al)
    "BegemannPorousAluminaGrainComposition":
        ("BegemannPorousAluminaOpticalProps", "DustEM_aSil_Enthalpies",
         3970.0, 102.0 / 5.0),
    "CrystalEnstatiteGrainComposition":
        ("MinEnstatiteOpticalProps", "DustEM_aSil_Enthalpies",
         2800.0, 100.0 / 5.0),
    "CrystalForsteriteGrainComposition":
        ("MinForsteriteOpticalProps", "DustEM_aSil_Enthalpies",
         3330.0, 140.0 / 7.0),
    "DorschnerOlivineGrainComposition":
        ("DorschnerOlivineOpticalProps", "DustEM_aSil_Enthalpies",
         3710.0, 172.0 / 7.0),
    "HofmeisterPericlaseGrainComposition":
        ("HofmeisterPericlaseOpticalProps", "DustEM_aSil_Enthalpies",
         3580.0, 40.0 / 2.0),
    "MinSilicateGrainComposition":
        ("MinSilicateOpticalProps", "DustEM_aSil_Enthalpies",
         3200.0, 172.0 / 7.0),
}

_AMU = 1.6605e-27


def composition_from_resource(kind: str) -> GrainComposition:
    """Exact grain composition from resource stored tables: optical props
    with axes a(m), lambda(m) and quantities Qabs/Qsca/g(1); enthalpies
    with axis T(K) and quantity h(J/m3) — volume-specific enthalpy,
    converted per grain via the bulk density exactly as the reference
    (ref: MultiGrainDustMix.cpp:136-139 StoredTable opens,
    StochasticDustEmissionCalculator.cpp:117-127 h * meanMass/bulkDensity).
    """
    from ..utils.filepaths import find_resource
    from ..utils.storedtable import read_stored_table

    opt_name, enth_name, rho, amass_amu = NAMED_COMPOSITIONS[kind]
    opt = read_stored_table(find_resource(opt_name + ".stab"))
    a_ax = opt.axes_points[0]
    l_ax = opt.axes_points[1]
    # stored-table values carry the first declared axis LAST: quantity
    # dims are (lambda, a) for axes a(m), lambda(m) -> transpose
    qa_t = np.asarray(opt.quantity("Qabs")).reshape(len(l_ax),
                                                    len(a_ax)).T
    qs_t = np.asarray(opt.quantity("Qsca")).reshape(len(l_ax),
                                                    len(a_ax)).T
    gg_t = np.asarray(opt.quantity("g")).reshape(len(l_ax), len(a_ax)).T

    def q_tables(a, lam):
        def interp2(tab):
            rows = np.empty((a_ax.size, len(lam)))
            for i in range(a_ax.size):
                rows[i] = np.interp(np.log(lam), np.log(l_ax), tab[i])
            out = np.empty((len(a), len(lam)))
            for j in range(len(lam)):
                out[:, j] = np.interp(np.log(a), np.log(a_ax), rows[:, j])
            return out
        return interp2(qa_t), interp2(qs_t), interp2(gg_t)

    enth = read_stored_table(find_resource(enth_name + ".stab"))
    T_ax = enth.axes_points[0]
    h_vol = enth.quantity(enth.quantity_names[0]).reshape(-1)  # J/m3

    amass = amass_amu * _AMU

    def enthalpy(T, natoms):
        # per-grain enthalpy: h(T) [J/m3] * grain volume; grain mass =
        # natoms * amass, volume = mass / rho
        h = np.interp(np.asarray(T, np.float64), T_ax, h_vol)
        return h * (natoms * amass / rho)

    return GrainComposition(name=kind, bulk_density=rho, atomic_mass=amass,
                            q_tables=q_tables, enthalpy=enthalpy)


def composition_from_q_file(path: str, name: str = "File",
                            bulk_density: float = 3000.0,
                            atomic_mass: float = 20 * 1.6605e-27,
                            enthalpy_fn=enthalpy_silicate) -> GrainComposition:
    """Exact-parity path: text file with blocks 'a lam Q_abs Q_sca g'
    (columns), one row per (a, lam) pair on a rectangular grid
    (ref: GrainComposition resource tables)."""
    d = np.loadtxt(path)
    a_ax = np.unique(d[:, 0])
    l_ax = np.unique(d[:, 1])
    shape = (a_ax.size, l_ax.size)
    qa = d[:, 2].reshape(shape)
    qs = d[:, 3].reshape(shape)
    gg = d[:, 4].reshape(shape)

    def q_tables(a, lam):
        # separable log-log bilinear interpolation (numpy only)
        def interp2(tab):
            rows = np.empty((a_ax.size, len(lam)))
            for i in range(a_ax.size):
                rows[i] = np.interp(np.log(lam), np.log(l_ax), tab[i])
            out = np.empty((len(a), len(lam)))
            for j in range(len(lam)):
                out[:, j] = np.interp(np.log(a), np.log(a_ax), rows[:, j])
            return out
        return interp2(qa), interp2(qs), interp2(gg)

    return GrainComposition(name=name, bulk_density=bulk_density,
                            atomic_mass=atomic_mass, q_tables=q_tables,
                            enthalpy=enthalpy_fn)


# ------------------------------------------------------ size distributions

@dataclasses.dataclass(frozen=True)
class SizeDistribution:
    """dn/da (arbitrary normalization; GrainPopulation fixes the scale)
    on [a_min, a_max] (ref: GrainSizeDistribution.hpp:33)."""

    a_min: float
    a_max: float
    dnda: Callable[[np.ndarray], np.ndarray]


def power_law_sizes(a_min=5e-9, a_max=250e-9, gamma=3.5) -> SizeDistribution:
    """MRN: dn/da ~ a^-gamma (ref: PowerLawGrainSizeDistribution)."""
    return SizeDistribution(a_min, a_max, lambda a: a ** (-gamma))


def modified_power_law_sizes(a_min=5e-9, a_max=250e-9, gamma=3.5,
                             a_t=50e-9, a_c=100e-9, zeta=0.0) -> SizeDistribution:
    """Power law with curvature + exponential cutoff above a_t
    (ref: ModifiedPowerLawGrainSizeDistribution)."""
    def dnda(a):
        base = a ** (-gamma) * (1.0 + np.abs(zeta) * (a / a_t)) ** np.sign(zeta)
        return base * np.where(a <= a_t, 1.0, np.exp(-((a - a_t) / a_c)))
    return SizeDistribution(a_min, a_max, dnda)


def log_normal_sizes(a_min=5e-9, a_max=1e-6, a0=100e-9,
                     width=0.4) -> SizeDistribution:
    """dn/da ~ (1/a) exp(-ln^2(a/a0)/(2 w^2))
    (ref: LogNormalGrainSizeDistribution)."""
    return SizeDistribution(a_min, a_max,
                            lambda a: np.exp(-np.log(a / a0) ** 2 /
                                             (2 * width**2)) / a)


def modified_log_normal_sizes(a_min=5e-9, a_max=1e-6, a0=100e-9, width=0.4,
                              y0=1.0, y1=1.0) -> SizeDistribution:
    """Log-normal times a linear mix term (ref:
    ModifiedLogNormalGrainSizeDistribution)."""
    base = log_normal_sizes(a_min, a_max, a0, width).dnda
    def dnda(a):
        t = (np.log(a) - np.log(a_min)) / (np.log(a_max) - np.log(a_min))
        return base(a) * (y0 * (1 - t) + y1 * t)
    return SizeDistribution(a_min, a_max, dnda)


def hirashita_log_normal_sizes(a_min=3e-9, a_max=3e-6, a0=20e-9,
                               width=np.log(1.6)) -> SizeDistribution:
    """Hirashita 2015 lognormal: dn/da ~ a^-4 exp(-ln^2(a/a0)/(2w^2))
    (ref: HirashitaLogNormalGrainSizeDistribution)."""
    return SizeDistribution(a_min, a_max,
                            lambda a: a**-4 * np.exp(-np.log(a / a0) ** 2 /
                                                     (2 * width**2)))


def single_size(a0: float) -> SizeDistribution:
    """Delta function approximated by a narrow log-normal
    (ref: SingleGrainSizeDistribution)."""
    return SizeDistribution(a0 * 0.99, a0 * 1.01,
                            lambda a: np.ones_like(a))


def sizes_from_table(a: np.ndarray, dnda: np.ndarray) -> SizeDistribution:
    """(ref: FileGrainSizeDistribution / ListGrainSizeDistribution)"""
    a = np.asarray(a, np.float64)
    v = np.asarray(dnda, np.float64)
    def f(x):
        return np.exp(np.interp(np.log(x), np.log(a),
                                np.log(np.maximum(v, 1e-300))))
    return SizeDistribution(float(a[0]), float(a[-1]), f)


def zubko_silicate_sizes() -> SizeDistribution:
    """Zubko+2004 BARE-GR-S silicate fit, simplified published shape:
    power law with exponential cutoff (ref: ZubkoSilicateGrainSizeDistribution)."""
    return modified_power_law_sizes(3e-9, 370e-9, 3.4, 170e-9, 50e-9, 0.0)


def zubko_graphite_sizes() -> SizeDistribution:
    return modified_power_law_sizes(3e-9, 330e-9, 3.5, 150e-9, 60e-9, 0.0)


def zubko_pah_sizes() -> SizeDistribution:
    return log_normal_sizes(3.5e-10, 5e-9, 6e-10, 0.4)


# ----------------------------------------------------------- populations

@dataclasses.dataclass(frozen=True)
class GrainPopulation:
    """composition x size distribution x #bins x dust-mass normalization
    (ref: GrainPopulation.hpp). `mass_per_h` is dust mass per hydrogen
    atom [kg]; densities in MediumTables are then hydrogen number
    densities, matching the reference's convention."""

    composition: GrainComposition
    sizes: SizeDistribution
    num_bins: int = 8
    mass_per_h: float = 1e-29


@dataclasses.dataclass(frozen=True)
class MultiGrainTables:
    """Per-size-bin data for the emission calculators
    (ref: MultiGrainDustMix::populationXXX accessors used by
    Equilibrium/StochasticDustEmissionCalculator)."""

    mix: MixTables                 # representative-grain transport tables
    lam: np.ndarray                # (L,)
    sigma_abs_bin: np.ndarray      # (NB, L) absorption cross section per H
    mass_bin: np.ndarray           # (NB,) mean grain mass per bin [kg]
    number_bin: np.ndarray         # (NB,) grains per H per bin
    enthalpy_fn: list              # NB callables T -> U [J] per grain
    labels: list                   # NB (population, bin) labels


def build_multi_grain(populations: list[GrainPopulation],
                      lam: np.ndarray | None = None,
                      nsizes_per_bin: int = 12) -> MultiGrainTables:
    """Integrate optical properties over the size distributions
    (log-spaced sub-sizes per bin, trapezoidal in ln a) to produce both the
    representative-grain MixTables and per-bin emission data
    (ref: MultiGrainDustMix.hpp:108 'integrates optical properties over
    grain populations')."""
    if lam is None:
        lam = np.geomspace(0.01e-6, 3000e-6, 160)
    lam = np.asarray(lam, np.float64)
    L = lam.size

    sig_abs_bins, mass_bins, num_bins_, enth, labels = [], [], [], [], []
    sig_sca_tot = np.zeros(L)
    gxs_tot = np.zeros(L)   # g-weighted scattering (for mix-level g)
    mass_tot = 0.0

    for pop in populations:
        comp = pop.composition
        edges = np.geomspace(pop.sizes.a_min, pop.sizes.a_max, pop.num_bins + 1)
        # raw (unnormalized) moments for the whole population
        a_all = np.geomspace(pop.sizes.a_min, pop.sizes.a_max,
                             pop.num_bins * nsizes_per_bin)
        w_all = pop.sizes.dnda(a_all) * a_all  # per dln a
        m_all = 4.0 / 3.0 * np.pi * a_all**3 * comp.bulk_density
        mass_raw = np.trapezoid(w_all * m_all, np.log(a_all))
        scale = pop.mass_per_h / mass_raw  # grains per H per unit dn/da
        for b in range(pop.num_bins):
            a = np.geomspace(edges[b], edges[b + 1], nsizes_per_bin)
            w = pop.sizes.dnda(a) * a  # d n/d ln a
            qa, qs, gg = comp.q_tables(a, lam)
            geo = np.pi * a**2
            lna = np.log(a)
            nb = scale * np.trapezoid(w, lna)
            sab = scale * np.trapezoid(w[:, None] * geo[:, None] * qa, lna, axis=0)
            ssc = scale * np.trapezoid(w[:, None] * geo[:, None] * qs, lna, axis=0)
            gsc = scale * np.trapezoid(w[:, None] * geo[:, None] * qs * gg,
                                       lna, axis=0)
            mb = scale * np.trapezoid(
                w * 4.0 / 3.0 * np.pi * a**3 * comp.bulk_density, lna)
            a_mean = (np.trapezoid(w * a**3, lna) /
                      max(np.trapezoid(w, lna), 1e-300)) ** (1.0 / 3.0)
            natoms = max(4.0 / 3.0 * np.pi * a_mean**3 * comp.bulk_density
                         / comp.atomic_mass, 10.0)
            sig_abs_bins.append(sab)
            mass_bins.append(mb / max(nb, 1e-300))
            num_bins_.append(nb)
            enth.append((comp.enthalpy, natoms))
            labels.append((comp.name, b))
            sig_sca_tot += ssc
            gxs_tot += gsc
            mass_tot += mb

    sigma_abs = np.sum(sig_abs_bins, axis=0)
    sigma_ext = sigma_abs + sig_sca_tot
    albedo = np.where(sigma_ext > 0, sig_sca_tot / np.maximum(sigma_ext, 1e-300), 0.0)
    g = np.where(sig_sca_tot > 0, gxs_tot / np.maximum(sig_sca_tot, 1e-300), 0.0)
    mix = MixTables(lam=lam, sigma_ext=sigma_ext, albedo=albedo,
                    g=np.clip(g, -0.999, 0.999), mu=mass_tot)
    enth_fns = [(lambda T, fn=fn, na=na: fn(T, na)) for fn, na in enth]
    return MultiGrainTables(mix=mix, lam=lam,
                            sigma_abs_bin=np.array(sig_abs_bins),
                            mass_bin=np.array(mass_bins),
                            number_bin=np.array(num_bins_),
                            enthalpy_fn=enth_fns, labels=labels)


# ------------------------------------------------------------ turnkey mixes

def mrn_mix(nbins: int = 6) -> MultiGrainTables:
    """MRN (Mathis, Rumpl & Nordsieck 1977): silicate + graphite a^-3.5,
    5 nm - 250 nm (ref: MRNDustMix)."""
    return build_multi_grain([
        GrainPopulation(silicate_composition(), power_law_sizes(), nbins,
                        mass_per_h=3.0e-30),
        GrainPopulation(graphite_composition(), power_law_sizes(), nbins,
                        mass_per_h=2.2e-30),
    ])


def draine_li_mix(nbins: int = 6) -> MultiGrainTables:
    """Draine & Li 2007-style: silicate + graphite + PAH-sized carbon
    lognormal (approximate populations; ref: DraineLiDustMix)."""
    return build_multi_grain([
        GrainPopulation(silicate_composition(),
                        modified_power_law_sizes(3.5e-9, 2e-6, 3.4, 0.17e-6),
                        nbins, mass_per_h=4.0e-30),
        GrainPopulation(graphite_composition(),
                        modified_power_law_sizes(3.5e-9, 2e-6, 3.5, 0.1e-6),
                        nbins, mass_per_h=1.8e-30),
        GrainPopulation(graphite_composition(),
                        log_normal_sizes(3.5e-10, 1.2e-8, 6e-10, 0.4),
                        max(2, nbins // 2), mass_per_h=0.6e-30),
    ])


def zubko_mix(nbins: int = 6) -> MultiGrainTables:
    """(ref: ZubkoDustMix; BARE-GR-S model)"""
    return build_multi_grain([
        GrainPopulation(silicate_composition(), zubko_silicate_sizes(), nbins,
                        mass_per_h=3.2e-30),
        GrainPopulation(graphite_composition(), zubko_graphite_sizes(), nbins,
                        mass_per_h=1.9e-30),
        GrainPopulation(graphite_composition(), zubko_pah_sizes(),
                        max(2, nbins // 2), mass_per_h=0.5e-30),
    ])


def weingartner_draine_mix(nbins: int = 6) -> MultiGrainTables:
    """(ref: WeingartnerDraineDustMix; Milky Way R_V=3.1 case,
    simplified functional forms of WD01)"""
    return build_multi_grain([
        GrainPopulation(silicate_composition(),
                        modified_power_law_sizes(3.5e-9, 1e-6, 3.4,
                                                 0.164e-6, 0.1e-6, 0.3),
                        nbins, mass_per_h=3.8e-30),
        GrainPopulation(graphite_composition(),
                        modified_power_law_sizes(3.5e-9, 1e-6, 3.5,
                                                 0.0107e-6, 0.428e-6, 0.9),
                        nbins, mass_per_h=2.3e-30),
    ])


def themis_mix(nbins: int = 6) -> MultiGrainTables:
    """(ref: ThemisDustMix; Jones+2017 THEMIS model, approximated as
    amorphous-silicate power-law + small/large carbon populations)"""
    return build_multi_grain([
        GrainPopulation(silicate_composition(),
                        log_normal_sizes(1e-9, 3e-6, 140e-9, 0.5),
                        nbins, mass_per_h=4.2e-30),
        GrainPopulation(graphite_composition(),
                        modified_power_law_sizes(0.4e-9, 4.9e-9, 5.0,
                                                 10e-9, 50e-9, 0.0),
                        max(2, nbins // 2), mass_per_h=1.0e-30),
        GrainPopulation(graphite_composition(),
                        log_normal_sizes(0.5e-9, 3e-6, 160e-9, 0.35),
                        nbins, mass_per_h=0.8e-30),
    ])


def mie_amplitudes(m, x, costheta):
    """Mie scattering amplitudes S1, S2 for homogeneous spheres
    (Bohren & Huffman §4.3): returns complex (len(x), len(costheta)).

    Basis for SPHERICAL-polarization Mueller matrices computed from our
    own Mie pipeline instead of resource-pack tables (ref: DustMix
    ScatteringMode::SphericalPolarization + PolarizedSilicate/Graphite
    GrainComposition resources).
    """
    x = np.atleast_1d(np.asarray(x, np.float64))
    ct = np.atleast_1d(np.asarray(costheta, np.float64))
    m = np.broadcast_to(np.asarray(m, np.complex128), x.shape).copy()
    x = np.maximum(x, 1e-8)
    nmax_e = np.ceil(x + 4.0 * x ** (1.0 / 3.0) + 2.0).astype(int)
    nmax = int(np.max(nmax_e))
    mx = m * x
    nstart = nmax + 16
    D = np.zeros(x.shape, np.complex128)
    Dlist = [None] * (nmax + 1)
    for n in range(nstart, 1, -1):
        D = n / mx - 1.0 / (D + n / mx)
        if n - 1 <= nmax:
            Dlist[n - 1] = D.copy()
    psi0, psi1 = np.cos(x), np.sin(x)
    chi0, chi1 = -np.sin(x), np.cos(x)
    S1 = np.zeros((len(x), len(ct)), np.complex128)
    S2 = np.zeros((len(x), len(ct)), np.complex128)
    pi_prev = np.zeros(len(ct))          # pi_0
    pi_cur = np.ones(len(ct))            # pi_1
    with np.errstate(over="ignore", invalid="ignore"):
        for n in range(1, nmax + 1):
            live = (n <= nmax_e)[:, None]
            psi = (2 * n - 1) / x * psi1 - psi0
            chi = (2 * n - 1) / x * chi1 - chi0
            xi1 = psi1 - 1j * chi1
            xi = psi - 1j * chi
            Dn = Dlist[n]
            da = Dn / m + n / x
            db = Dn * m + n / x
            an = np.nan_to_num((da * psi - psi1) / (da * xi - xi1))
            bn = np.nan_to_num((db * psi - psi1) / (db * xi - xi1))
            tau = n * ct * pi_cur - (n + 1) * pi_prev
            f = (2 * n + 1) / (n * (n + 1.0))
            S1 += np.where(live, f * (an[:, None] * pi_cur[None, :]
                                      + bn[:, None] * tau[None, :]), 0.0)
            S2 += np.where(live, f * (an[:, None] * tau[None, :]
                                      + bn[:, None] * pi_cur[None, :]), 0.0)
            pi_next = ((2 * n + 1) / n) * ct * pi_cur - ((n + 1) / n) * pi_prev
            pi_prev, pi_cur = pi_cur, pi_next
            cap = 1e150
            psi0 = np.clip(psi1, -cap, cap)
            psi1 = np.clip(psi, -cap, cap)
            chi0 = np.clip(chi1, -cap, cap)
            chi1 = np.clip(chi, -cap, cap)
    return S1, S2


def mie_mueller(nk_sizes, lam0: float, n_theta: int = 91,
                nsizes: int = 24):
    """Size-distribution-averaged Mueller matrix of a grain mix at lam0
    (ref: the polarized grain compositions' Mueller resources,
    PolarizedSilicateGrainComposition et al.; amplitudes add incoherently
    across the ensemble).

    nk_sizes: list of (nk_fn(lam)->complex, SizeDistribution) pairs.
    Returns ops.stokes MuellerTables (single component; evaluated at the
    representative wavelength lam0 — the lam-resolved refinement follows
    the same path per wavelength bin).
    """
    from ..ops import stokes as stk
    theta = np.linspace(0.0, np.pi, n_theta)
    ct = np.cos(theta)
    S11 = np.zeros(n_theta)
    S12 = np.zeros(n_theta)
    S33 = np.zeros(n_theta)
    S34 = np.zeros(n_theta)
    for nk_fn, sizes in nk_sizes:
        a = np.geomspace(sizes.a_min, sizes.a_max, nsizes)
        w = sizes.dnda(a) * np.gradient(a)
        nk = nk_fn(np.array([lam0]))[0]
        x = 2 * np.pi * a / lam0
        s1, s2 = mie_amplitudes(nk, x, ct)
        # weight each size by its number; |S|^2 carries the a-dependence
        W = w[:, None]
        S11 += (W * 0.5 * (np.abs(s1) ** 2 + np.abs(s2) ** 2)).sum(0)
        S12 += (W * 0.5 * (np.abs(s2) ** 2 - np.abs(s1) ** 2)).sum(0)
        S33 += (W * (s2 * np.conj(s1)).real).sum(0)
        S34 += (W * (s2 * np.conj(s1)).imag).sum(0)
    return stk.build_mueller(theta[None, :], S11[None, :], S12[None, :],
                             S33[None, :], S34[None, :])


def mrn_mueller(lam0: float = 0.55e-6, n_theta: int = 91):
    """Polarized-scattering Mueller tables for the MRN silicate+graphite
    mixture at lam0 (the dust SphericalPolarization mode without resource
    packs)."""
    return mie_mueller([(nk_silicate_approx, power_law_sizes()),
                        (nk_graphite_approx, power_law_sizes())], lam0,
                       n_theta=n_theta)


# ------------------------------------------------ spheroidal emission tables

@dataclasses.dataclass(frozen=True)
class SpheroidalEmissionSpec:
    """Aligned-grain polarized-emission tables for one population
    (ref: GrainComposition::resourcesForSpheroidalEmission,
    SpheroidalSilicateGrainComposition.hpp Builtin/OneTable/TwoTables).

    table1/table2: .stab path or StoredTable with axes
    a(m), lambda(m), theta(rad) and quantities Qabs(1), Qabspol(1)
    (the CosTuuM layout the reference consumes,
    MultiGrainDustMix.cpp:198-203). `fraction` is the alignment fraction
    q interpolating table1 (non-aligned) -> table2 (aligned)."""

    table1: object
    table2: object = None
    fraction: float = 0.0


@dataclasses.dataclass(frozen=True)
class SpheroidalEmissionTables:
    """Size-integrated polarized-emission cross sections per H
    (ref: MultiGrainDustMix.cpp:186-317 sigmaabsvv/sigmaabspolvv)."""

    lam: np.ndarray       # (L,)
    theta: np.ndarray     # (T,) zenith angle w.r.t. the alignment axis
    sabs: np.ndarray      # (L, T) sigma_abs per H [m^2]
    sabspol: np.ndarray   # (L, T) linearly polarized component [m^2]


def _open_spheroidal(table):
    from ..utils.storedtable import StoredTable, read_stored_table
    if isinstance(table, StoredTable):
        return table
    return read_stored_table(str(table))


def _q_at_sizes(tab, a):
    """(Qabs, Qabspol) interpolated to sizes a: each (n_a, L, T).

    Stored-table values carry the FIRST declared axis LAST, so for axes
    (a, lambda, theta) a quantity is shaped (T, L, A)."""
    a_ax = np.asarray(tab.axes_points[0], np.float64)
    la = np.log(a_ax)
    lq = np.log(np.clip(a, a_ax[0], a_ax[-1]))
    j = np.clip(np.searchsorted(la, lq) - 1, 0, len(a_ax) - 2)
    f = np.clip((lq - la[j]) / np.maximum(la[j + 1] - la[j], 1e-300),
                0.0, 1.0)
    out = []
    for qname in ("Qabs", "Qabspol"):
        v = tab.quantity(qname).transpose(2, 1, 0)   # (A, L, T)
        out.append((1.0 - f)[:, None, None] * v[j]
                   + f[:, None, None] * v[j + 1])
    return out


def build_spheroidal_emission(populations: list,
                              specs: list,
                              nsizes_per_bin: int = 12
                              ) -> SpheroidalEmissionTables:
    """Integrate aligned-grain emission properties over the grain size
    distributions (ref: MultiGrainDustMix.cpp:216-295: the spheroidal
    branch weights pi a^2 Q(a, lambda, theta) by the size distribution).

    `specs` parallels `populations`; a None entry contributes the
    SPHERICAL terms Qabs(a,lambda,theta)=Qabs(a,lambda), Qabspol=0
    (ref branch at MultiGrainDustMix.cpp:279-283). Output axes are those
    of the first table; every table must share them.
    """
    first = next(s for s in specs if s is not None)
    t0 = _open_spheroidal(first.table1)
    l_out = np.asarray(t0.axes_points[1], np.float64)
    th_out = np.asarray(t0.axes_points[2], np.float64)
    L, T = len(l_out), len(th_out)
    sabs = np.zeros((L, T))
    sabspol = np.zeros((L, T))
    for pop, spec in zip(populations, specs):
        comp = pop.composition
        a = np.geomspace(pop.sizes.a_min, pop.sizes.a_max,
                         pop.num_bins * nsizes_per_bin)
        w = pop.sizes.dnda(a) * a                       # per dln a
        m_all = 4.0 / 3.0 * np.pi * a**3 * comp.bulk_density
        mass_raw = np.trapezoid(w * m_all, np.log(a))
        scale = pop.mass_per_h / mass_raw
        factor = w * np.pi * a**2
        if spec is None:
            qa, _, _ = comp.q_tables(a, l_out)          # (n_a, L)
            sabs += scale * np.trapezoid(factor[:, None] * qa,
                                         np.log(a), axis=0)[:, None]
            continue
        tab1 = _open_spheroidal(spec.table1)
        if (len(tab1.axes_points[1]) != L
                or len(tab1.axes_points[2]) != T
                or not np.allclose(tab1.axes_points[1], l_out)
                or not np.allclose(tab1.axes_points[2], th_out)):
            raise ValueError("spheroidal emission tables must share "
                             "(lambda, theta) axes across populations")
        Qa, Qp = _q_at_sizes(tab1, a)
        if spec.fraction and spec.table2 is not None:
            Qa2, Qp2 = _q_at_sizes(_open_spheroidal(spec.table2), a)
            q = float(spec.fraction)
            Qa = (1.0 - q) * Qa + q * Qa2
            Qp = (1.0 - q) * Qp + q * Qp2
        sabs += scale * np.trapezoid(factor[:, None, None] * Qa,
                                     np.log(a), axis=0)
        sabspol += scale * np.trapezoid(factor[:, None, None] * Qp,
                                        np.log(a), axis=0)
    return SpheroidalEmissionTables(lam=l_out, theta=th_out,
                                    sabs=sabs, sabspol=sabspol)
