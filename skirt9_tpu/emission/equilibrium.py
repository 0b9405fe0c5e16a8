"""Equilibrium dust emission: temperatures and emission spectra per cell.

Counterpart of the reference's EquilibriumDustEmissionCalculator
(ref: SKIRT/core/EquilibriumDustEmissionCalculator.hpp:55): solve the
energy balance

    P_abs = integral sigma_abs(lam) c u_lam(cell) dlam           (from the RF)
          = 4 pi integral sigma_abs(lam) B_lam(T) dlam = P_em(T)

per (cell, component) by inverting a precomputed P_em(T) table on a log-T
grid — exactly the reference's strategy of precalculated Planck-integral
tables, but batched over all cells at once on device.

Radiation-field convention: rf[cell, bin] stores sum of L * ds * e^-tau
path segments [W m] (see transport/lifecycle.propagate_deposit). The mean
intensity is J_lam = rf / (4 pi V_cell dlam_bin), so the absorbed power per
entity is  P_abs = sum_bins sigma_abs(lam_bin) * rf[cell,bin] / V_cell.
(ref: MediumSystem radiation-field accounting, MediumSystem.cpp:1294-1310.)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..media.system import MediumTables
from ..ops import planck, sampling


class EmissionTables(NamedTuple):
    """Precomputed device tables for equilibrium emission."""

    T_grid: jax.Array       # (NT,) temperature grid [K]
    P_em: jax.Array         # (H, NT) emitted power per entity [W]
    lam_ems: jax.Array      # (L,) emission wavelength grid centers [m]
    dlam_ems: jax.Array     # (L,) bin widths
    sigma_abs_ems: jax.Array  # (H, L) absorption cross section on lam_ems
    sigma_abs_rf: jax.Array   # (H, R) absorption cross section on RF grid centers


def build_emission_tables(med: MediumTables, rf_borders: np.ndarray,
                          ems_borders: np.ndarray,
                          T_min: float = 2.0, T_max: float = 3000.0,
                          nT: int = 256) -> EmissionTables:
    lam_t = np.asarray(med.lam_t, np.float64)
    s_ext = np.asarray(med.sigma_ext, np.float64)
    s_sca = np.asarray(med.sigma_sca, np.float64)
    s_abs = np.maximum(s_ext - s_sca, 0.0)

    def interp_abs(lams):
        out = []
        for h in range(s_abs.shape[0]):
            out.append(np.exp(np.interp(np.log(lams), np.log(lam_t),
                                        np.log(np.maximum(s_abs[h], 1e-300)))))
        out = np.array(out)
        out[out < 1e-200] = 0.0
        return out

    rf_c = np.sqrt(rf_borders[1:] * rf_borders[:-1])
    ems_c = np.sqrt(ems_borders[1:] * ems_borders[:-1])
    dlam_e = np.diff(ems_borders)

    # P_em(T) on a fine integration grid (log-spaced, wide)
    lam_int = np.geomspace(1e-8, 1e-2, 800)
    sa_int = interp_abs(lam_int)           # (H, LI)
    T_grid = np.geomspace(T_min, T_max, nT)
    B = planck.b_lambda_np(lam_int[None, :], T_grid[:, None])  # (NT, LI)
    # P_em[h, t] = 4 pi ∫ sigma_abs B dlam
    P = 4 * np.pi * np.trapezoid(sa_int[:, None, :] * B[None, :, :],
                                 lam_int, axis=-1)  # (H, NT)

    return EmissionTables(
        T_grid=jnp.asarray(T_grid, jnp.float32),
        P_em=jnp.asarray(P, jnp.float32),
        lam_ems=jnp.asarray(ems_c, jnp.float32),
        dlam_ems=jnp.asarray(dlam_e, jnp.float32),
        sigma_abs_ems=jnp.asarray(interp_abs(ems_c), jnp.float32),
        sigma_abs_rf=jnp.asarray(interp_abs(rf_c), jnp.float32),
    )


def absorbed_power(med: MediumTables, tabs: EmissionTables,
                   rf, volumes, rf_scale: float = 1.0) -> np.ndarray:
    """Absorbed power per entity per component: (ncells, H) [W].

    Host-side f64 numpy on purpose: rf is stored in units of rf_scale
    (~1e42), and f32 device arithmetic on these magnitudes is both
    overflow-prone and subject to XLA constant-folding hazards. These
    reductions run once per emission iteration on small tables — setup
    cost, not hot path.
    """
    rf64 = np.asarray(rf, np.float64)                # (ncells, R)
    sab = np.asarray(tabs.sigma_abs_rf, np.float64)  # (H, R)
    v = np.asarray(volumes, np.float64)
    return (rf64 @ sab.T) * (rf_scale / v)[:, None]


def cmb_heating_power(tabs: EmissionTables, T_cmb: float) -> np.ndarray:
    """Per-entity absorbed CMB power (H,) [W]: by Kirchhoff's law this is
    exactly P_em evaluated at the CMB temperature (ref:
    EquilibriumDustEmissionCalculator.hpp:55 includeHeatingByCMB —
    the equilibrium balance gains a 4 pi int sigma_abs B(lam, T_cmb) term).
    """
    if not T_cmb or T_cmb <= 0:
        return np.zeros(np.asarray(tabs.P_em).shape[0])
    P = np.asarray(tabs.P_em, np.float64)
    lT = np.log(np.asarray(tabs.T_grid, np.float64))
    out = np.empty(P.shape[0])
    for h in range(P.shape[0]):
        out[h] = np.exp(np.interp(np.log(T_cmb), lT,
                                  np.log(np.maximum(P[h], 1e-300))))
    return out


def equilibrium_temperature(tabs: EmissionTables, p_abs,
                            p_cmb=None) -> np.ndarray:
    """Invert P_em(T) per component: p_abs (ncells, H) -> T (ncells, H).

    Log-log interpolation on the precomputed table (monotone in T); host
    f64. p_cmb (H,) adds the CMB heating term to the balance.
    """
    p = np.asarray(p_abs, np.float64)
    if p_cmb is not None:
        p = p + np.asarray(p_cmb, np.float64)[None, :]
    P = np.asarray(tabs.P_em, np.float64)
    lT = np.log(np.asarray(tabs.T_grid, np.float64))
    out = np.empty_like(p)
    for h in range(P.shape[0]):
        lp = np.log(np.maximum(p[:, h], 1e-300))
        lP = np.log(np.maximum(P[h], 1e-300))
        out[:, h] = np.exp(np.interp(lp, lP, lT))
    return out


def cell_emission_spectra(med: MediumTables, tabs: EmissionTables,
                          T) -> jax.Array:
    """Per-cell bolometric-normalized emission spectrum on lam_ems.

    Returns eps (ncells, L): luminosity density per wavelength summed over
    components, eps[cell, l] = sum_h nd[cell,h] sigma_abs[h,l] B_lam(lam_l,
    T[cell,h]) * 4 pi  [W/m per unit volume]. Used to build sampling cdfs and
    the dust luminosity; absolute scale cancels in sampling but matters for
    L_dust.
    (ref: MediumSystem::dustEmissionSpectrum + DustMix::emissivity.)
    """
    lam = tabs.lam_ems  # (L,)
    T = jnp.asarray(T, jnp.float32)
    # B (ncells, H, L)
    B = planck.b_lambda(lam[None, None, :], T[:, :, None])
    eps = 4 * jnp.pi * jnp.sum(
        med.nd[:, :, None] * tabs.sigma_abs_ems[None, :, :] * B, axis=1)
    return eps


@jax.jit
def _absorbed_scaled(rf, sab, nd):
    """(rf @ sab.T): per-cell absorbed power in rf_scale units — f32-safe
    (the rf_scale factor ~1e36 is applied OUTSIDE, by the caller, to keep
    intermediates in range)."""
    a = jnp.dot(rf, sab.T,
                precision=jax.lax.Precision.HIGHEST)   # (ncells, H)
    return a, a * nd


def emission_state_device(med: MediumTables, tabs: EmissionTables, rf,
                          volumes, rf_scale: float, p_cmb=None):
    """Device-side per-cell emission state: (L_cell [W], T [K], eps).

    The host round trip of a numpy pipeline (pull rf -> numpy solve ->
    push spectra, every iteration) shrinks to a
    single (ncells,) pull for the launch cdf: absorbed power, temperature
    inversion (log-log on the precomputed P_em table) and the emission
    spectra all stay on device.
    """
    rf32 = jnp.asarray(rf, jnp.float32)
    nd = jnp.asarray(med.nd, jnp.float32)
    a, an = _absorbed_scaled(rf32, tabs.sigma_abs_rf, nd)
    # rf_scale (~1e42) exceeds the f32 range: apply it as two sqrt factors
    half = jnp.float32(np.sqrt(rf_scale))
    L_cell = (jnp.sum(an, axis=1) * half) * half              # [W]
    # temperature: work in logs — volumes (~1e47 m^3) and rf_scale both
    # overflow/underflow plain f32, their LOGS do not
    log_v = jnp.asarray(np.log(np.asarray(volumes, np.float64)),
                        jnp.float32)
    log_pabs = (jnp.log(jnp.maximum(a, 1e-30)) + np.log(rf_scale)
                - log_v[:, None])
    if p_cmb is not None and np.any(np.asarray(p_cmb) > 0):
        # CMB heating joins the balance in log space (logaddexp keeps the
        # rf_scale reparameterization exact)
        log_cmb = jnp.asarray(np.log(np.maximum(np.asarray(p_cmb),
                                                1e-300)), jnp.float32)
        log_pabs = jnp.logaddexp(log_pabs, log_cmb[None, :])
    lT = jnp.log(tabs.T_grid)
    Ts = []
    for h in range(tabs.P_em.shape[0]):
        lP = jnp.log(jnp.maximum(tabs.P_em[h], 1e-300))
        Ts.append(jnp.exp(sampling.interp_linlin(log_pabs[:, h], lP, lT)))
    T = jnp.stack(Ts, axis=1)                                  # (ncells, H)
    eps = cell_emission_spectra(med, tabs, T)
    return L_cell, T, eps


def total_absorbed_device(med: MediumTables, tabs: EmissionTables, rf,
                          rf_scale: float) -> float:
    """Total absorbed (= emitted) power [W] without pulling rf to host —
    only a scalar crosses the link (convergence checks run per iteration,
    ref: DustAbsorptionConvergence)."""
    rf32 = jnp.asarray(rf, jnp.float32)
    nd = jnp.asarray(med.nd, jnp.float32)
    a = jnp.dot(rf32, tabs.sigma_abs_rf.T,
                precision=jax.lax.Precision.HIGHEST)
    return float(jnp.sum(a * nd)) * rf_scale  # scalar float64 on host


def dust_luminosities(med: MediumTables, tabs: EmissionTables,
                      rf, rf_scale: float = 1.0) -> np.ndarray:
    """Bolometric dust luminosity per cell (ncells,) [W]: the absorbed power
    (== emitted in equilibrium) summed over components:
    L_cell = sum_h nd[cell,h] * sum_bins sigma_abs[h,bin] * rf[cell,bin]
    (ref: MediumSystem::dustLuminosity, used by
    DustSecondarySource::calculateLuminosities; rf already integrates
    L ds e^-tau over the cell so multiplying by the absorption opacity gives
    absorbed power directly). Host f64 — see absorbed_power."""
    rf64 = np.asarray(rf, np.float64)
    sab = np.asarray(tabs.sigma_abs_rf, np.float64)
    nd = np.asarray(med.nd, np.float64)
    return np.sum((rf64 @ sab.T) * nd, axis=1) * rf_scale
