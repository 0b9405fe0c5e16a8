"""Nebular continuum and hydrogen recombination-line emission.

Batched counterpart of the reference's NebularContinuumEmission +
NebularLineEmission (ref: SKIRT/core/NebularContinuumEmission.hpp:26-31,
NebularLineEmission.cpp; consumed through EmittingGasMix.hpp). The
reference embeds large Cloudy/Ercolano-Storey/CHIANTI data tables; this
module implements the same physical channels with published ANALYTIC
forms (documented stand-ins, the same posture as the approximate grain
optical constants in media/grains.py):

  * free-free: hydrogenic emissivity with the Draine (2011, eq. 10.8)
    Gaunt-factor approximation;
  * free-bound: hydrogenic recombination continuum summed over levels
    n>=2 with Milne-relation kappa_n cross sections (Osterbrock &
    Ferland ch. 4);
  * two-photon: 2s->1s decay with the Nussbaumer & Schmutz (1984)
    spectral profile and effective alpha_2s Case B coefficient;
  * H recombination lines: Case B effective coefficients with
    Storey & Hummer (1995) power-law temperature scalings for the Balmer
    and Paschen series heads.

Everything is vectorized over (cell, wavelength) tables; per-cell spectra
feed the standard secondary-source launcher.
"""

from __future__ import annotations

import dataclasses

import numpy as np

H_PLANCK = 6.62607015e-34
C_LIGHT = 2.99792458e8
K_B = 1.380649e-23
E_CHARGE = 1.602176634e-19
M_E = 9.1093837015e-31
RYD = 2.1798723611e-18          # [J]
LAM_LYA = 121.56701e-9


def gaunt_ff(lam: np.ndarray, T: np.ndarray) -> np.ndarray:
    """Thermally-averaged free-free Gaunt factor (Draine 2011 eq. 10.8,
    valid for radio through optical nebular conditions)."""
    nu = C_LIGHT / lam
    x = H_PLANCK * nu / (K_B * T)
    g = np.where(
        x < 0.5,
        # low-frequency limit
        np.sqrt(3) / np.pi * (np.log(np.maximum(
            (2.246 * K_B * T) / (H_PLANCK * nu), 1.0001))),
        1.0 + 0.1728 * np.cbrt(H_PLANCK * nu / RYD)
        * np.exp(-x / 3.0))
    return np.maximum(g, 1.0)


def free_free_emissivity(lam, T, ne, nion):
    """gamma_ff per unit wavelength [W m^3 / m]: 4 pi j_lam / (ne n+).

    Standard hydrogenic form (Osterbrock & Ferland eq. 4.22 converted to
    per-wavelength SI): scales as T^-1/2 exp(-hc/lam k T)/lam^2.
    """
    lam = np.asarray(lam, np.float64)
    T = np.asarray(T, np.float64)
    pref = 6.8e-51  # [W m^3 Hz^-1 K^1/2] 4pi j_nu/(ne np) coefficient
    x = H_PLANCK * C_LIGHT / (lam * K_B * T)
    g = gaunt_ff(lam, T)
    gamma_nu = pref * g / np.sqrt(T) * np.exp(-x)
    # per wavelength: gamma_lam = gamma_nu c / lam^2
    return ne * nion * gamma_nu * C_LIGHT / lam**2


def free_bound_emissivity(lam, T, ne, nHII, n_max: int = 8):
    """Hydrogen recombination continuum per unit wavelength [W/m^3/m]:
    sum over levels n >= 2 of the Milne-relation emissivity above each
    threshold (Osterbrock & Ferland ch. 4; hydrogenic kappa_n ~
    7.91e-22 n / (nu/nu_n)^3 m^2 above threshold nu_n)."""
    lam = np.asarray(lam, np.float64)[..., None]          # (..., L, 1)
    T = np.asarray(T, np.float64)[..., None]
    n = np.arange(2, n_max + 1, dtype=np.float64)          # (N,)
    nu = C_LIGHT / lam
    nu_n = RYD / (H_PLANCK * n**2)
    above = nu >= nu_n
    # Milne relation: gamma_n(nu) ~ (2 h nu^3/c^2) (h^2/(2 pi m k T))^{3/2}
    #   * n^2 kappa_n(nu) exp(-(h nu - h nu_n)/kT) * (2 h nu / (m c^2))...
    # collapsing constants into the hydrogenic kappa:
    kappa = 7.906e-22 * n * (nu_n / nu) ** 3              # [m^2]
    lth = (H_PLANCK**2 / (2 * np.pi * M_E * K_B * T)) ** 1.5
    gamma_nu = (2 * H_PLANCK * nu**3 / C_LIGHT**2) * lth * n**2 \
        * kappa * np.exp(-np.maximum(H_PLANCK * (nu - nu_n), 0.0)
                         / (K_B * T))
    gamma_nu = np.where(above, gamma_nu, 0.0).sum(axis=-1)  # (..., L)
    return ne * nHII * gamma_nu * C_LIGHT / np.squeeze(lam, -1)**2


def two_photon_emissivity(lam, T, ne, nHII):
    """2s->1s two-photon continuum per unit wavelength [W/m^3/m]
    (Nussbaumer & Schmutz 1984 profile; effective alpha_2s^B ~
    0.838e-19 m^3/s at 1e4 K with T^-0.67 scaling)."""
    lam = np.asarray(lam, np.float64)
    y = LAM_LYA / lam                                  # fraction of Lya freq
    # NS84 fit to the normalized frequency profile psi(y), y in (0,1)
    yc = np.clip(y, 1e-12, 1.0 - 1e-12)
    w = yc * (1.0 - yc)
    P = np.where((y > 0) & (y < 1),
                 1.307 * (w * 4.0) ** 0.8 * (1 - np.abs(1 - 2 * yc) ** 1.5),
                 0.0)
    alpha_2s = 0.838e-19 * (np.asarray(T, np.float64) / 1e4) ** (-0.67)
    # energy emitted per decay distributed over the profile: total = h nu_lya
    E_tot = H_PLANCK * C_LIGHT / LAM_LYA
    # unit-normalized wavelength profile: phi(lam) = P(y) |dy/dlam| / ∫P dy
    # with |dy/dlam| = LAM/lam^2, so ∫ phi dlam = 1 exactly
    yg = np.linspace(1e-4, 1 - 1e-4, 512)
    wg = yg * (1.0 - yg)
    Pg = 1.307 * (wg * 4.0) ** 0.8 * (1 - np.abs(1 - 2 * yg) ** 1.5)
    norm = float(np.trapezoid(Pg, yg))
    prof_lam = P * LAM_LYA / lam**2
    return ne * nHII * alpha_2s * E_tot * prof_lam / norm


# Case B effective recombination coefficients at 1e4 K [m^3/s] and
# temperature exponents (Storey & Hummer 1995 / Osterbrock tables)
H_LINES = {
    # alpha_eff at 1e4 K and d(ln alpha)/d(ln T); the Halpha slope is
    # steeper than Hbeta so the Balmer decrement RISES toward low T
    # (Osterbrock & Ferland table 4.4: j_Ha/j_Hb = 3.04/2.86/2.75 at
    # 5e3/1e4/2e4 K; alpha_Hb = 5.37/3.03/1.62e-14 cm^3/s)
    "Halpha": {"lam": 656.461e-9, "alpha": 1.17e-19, "slope": -0.90},
    "Hbeta": {"lam": 486.271e-9, "alpha": 3.03e-20, "slope": -0.83},
    "Hgamma": {"lam": 434.169e-9, "alpha": 1.27e-20, "slope": -0.81},
    "Paalpha": {"lam": 1875.6e-9, "alpha": 3.96e-20, "slope": -1.05},
    "Pabeta": {"lam": 1282.2e-9, "alpha": 1.74e-20, "slope": -1.00},
    "Bralpha": {"lam": 4052.3e-9, "alpha": 1.38e-20, "slope": -1.16},
}


def line_luminosity_density(T, ne, nHII, line: str) -> np.ndarray:
    """Line power per unit volume [W/m^3] for an H Case B line."""
    d = H_LINES[line]
    alpha = d["alpha"] * (np.asarray(T, np.float64) / 1e4) ** d["slope"]
    E = H_PLANCK * C_LIGHT / d["lam"]
    return ne * nHII * alpha * E


@dataclasses.dataclass(frozen=True)
class NebularEmission:
    """Per-cell nebular emission calculator: continuum + H lines.

    Mirrors the EmittingGasMix contract (ref: EmittingGasMix.hpp): given
    per-cell (T, ne, nHII) state, produce luminosity spectra on the
    secondary-emission wavelength grid. Lines are injected into their
    host wavelength bins (the reference adds Gaussian thermal profiles;
    bin injection is exact for bins wider than the thermal width).
    """

    include_free_free: bool = True
    include_free_bound: bool = True
    include_two_photon: bool = True
    lines: tuple = tuple(H_LINES)

    def cell_spectra(self, ems_borders, T, ne, nHII, volumes):
        """Returns (eps (ncells, L) [W/m per m^3], L_cell (ncells,) [W])."""
        eb = np.asarray(ems_borders, np.float64)
        lam_c = np.sqrt(eb[1:] * eb[:-1])
        dlam = np.diff(eb)
        T = np.asarray(T, np.float64)[:, None]
        ne = np.asarray(ne, np.float64)[:, None]
        nH = np.asarray(nHII, np.float64)[:, None]
        eps = np.zeros((T.shape[0], lam_c.size))
        if self.include_free_free:
            eps += free_free_emissivity(lam_c[None, :], T, ne, nH)
        if self.include_free_bound:
            eps += free_bound_emissivity(lam_c[None, :], T, ne, nH)
        if self.include_two_photon:
            eps += two_photon_emissivity(lam_c[None, :], T, ne, nH)
        for name in self.lines:
            lam0 = H_LINES[name]["lam"]
            b = int(np.searchsorted(eb, lam0)) - 1
            if 0 <= b < lam_c.size:
                Lv = line_luminosity_density(T[:, 0], ne[:, 0], nH[:, 0],
                                             name)
                eps[:, b] += Lv / dlam[b]
        v = np.asarray(volumes, np.float64)
        L_cell = (eps * dlam[None, :]).sum(axis=1) * v
        return eps, L_cell
