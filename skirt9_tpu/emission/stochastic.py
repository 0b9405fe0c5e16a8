"""Stochastically-heated dust emission (Guhathakurta & Draine 1989 scheme).

Counterpart of the reference's StochasticDustEmissionCalculator
(ref: SKIRT/core/StochasticDustEmissionCalculator.hpp:87): small grains do
not reach an equilibrium temperature — each (cell, size bin) gets a
temperature *probability distribution* P_i over enthalpy states, obtained
from the transition-matrix recursion:

  * upward rates (photon absorption)  A_{f,i} = sigma_abs(E_fi) c
      u_E(E_fi) dU_f / E_fi   with E_fi = U_f - U_i,
  * downward rates in the continuous-cooling approximation (only f = i-1):
      A_{i-1,i} = P_rad(T_i) / (U_i - U_{i-1}),
  * solution by the standard GD89 recursion over cumulative upward rates
      B_{f,i} = sum_{f' >= f} A_{f',i};  X_0 = 1,
      X_j = sum_{i<j} B_{j,i} X_i / A_{j-1,j};  P = X / sum X.

Vectorized structure: the per-cell upward rates are a single dense matmul
u_lambda[cells, R] @ W[R, pairs] (W precomputed from the size-bin cross
sections and the enthalpy grid), and the emissivity is another matmul
P[cells, NT] @ M[NT, L]. The sequential part is only the NT-step recursion,
vectorized over all cells of a chunk. Enthalpies come from the Draine & Li
2001 analytic heat capacities in media/grains.py.

Runs once per emission iteration (setup-scale, not hot path); host f64 for
the same overflow-robustness reasons as emission/equilibrium.absorbed_power.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..media.grains import MultiGrainTables
from ..ops import planck
from ..utils import constants as c


@dataclasses.dataclass(frozen=True)
class StochasticTables:
    """Precomputed per-size-bin transition machinery."""

    T_bins: np.ndarray        # (NB, NT) temperature grids
    dU: np.ndarray            # (NB, NT) enthalpy-state widths [J]
    cool: np.ndarray          # (NB, NT) downward rate A_{i-1,i} [1/s] (i>=1)
    W_up: np.ndarray          # (NB, NP, R) upward-rate weights vs u_lambda
    pairs: np.ndarray         # (NP, 2) (f, i) index pairs, f > i
    M_ems: np.ndarray         # (NB, NT, L) sigma_abs(lam) B_lam(T_i) [W/m]
    lam_ems: np.ndarray       # (L,)
    number_bin: np.ndarray    # (NB,) grains per H


def build_stochastic_tables(mg: MultiGrainTables, rf_borders: np.ndarray,
                            ems_borders: np.ndarray, nT: int = 36,
                            T_min: float = 2.0,
                            T_max: float = 2500.0) -> StochasticTables:
    rf_borders = np.asarray(rf_borders, np.float64)
    rf_c = np.sqrt(rf_borders[1:] * rf_borders[:-1])
    R = rf_c.size
    ems_c = np.sqrt(np.asarray(ems_borders[1:], np.float64)
                    * np.asarray(ems_borders[:-1], np.float64))
    L = ems_c.size
    NB = mg.sigma_abs_bin.shape[0]

    # absorption cross sections of each bin interpolated onto arbitrary lam
    def sab_at(b, lam):
        tab = np.maximum(mg.sigma_abs_bin[b], 1e-300)
        return np.exp(np.interp(np.log(lam), np.log(mg.lam), np.log(tab)))

    pairs = np.array([(f, i) for i in range(nT) for f in range(i + 1, nT)],
                     np.int32)
    NP = pairs.shape[0]

    T_bins = np.empty((NB, nT))
    dU_all = np.empty((NB, nT))
    cool = np.zeros((NB, nT))
    W_up = np.zeros((NB, NP, R))
    M_ems = np.empty((NB, nT, L))

    lam_int = np.geomspace(1e-8, 1e-2, 500)
    for b in range(NB):
        T = np.geomspace(T_min, T_max, nT)
        U = mg.enthalpy_fn[b](T)           # (NT,) per grain [J]
        # enforce strict monotonicity for transition energies
        U = np.maximum.accumulate(U) + np.arange(nT) * 1e-40
        edges = np.concatenate([[U[0] - 0.5 * (U[1] - U[0])],
                                0.5 * (U[1:] + U[:-1]),
                                [U[-1] + 0.5 * (U[-1] - U[-2])]])
        dU = np.maximum(np.diff(edges), 1e-40)
        T_bins[b] = T
        dU_all[b] = dU

        # cooling: radiated power per grain at T_i over (U_i - U_{i-1})
        sa_int = sab_at(b, lam_int) / max(mg.number_bin[b], 1e-300)  # per grain
        B = planck.b_lambda_np(lam_int[None, :], T[:, None])         # (NT, LI)
        P_rad = 4 * np.pi * np.trapezoid(sa_int[None, :] * B, lam_int, axis=-1)
        cool[b, 1:] = P_rad[1:] / np.maximum(U[1:] - U[:-1], 1e-40)

        # upward weights: A_fi = sigma(lam_fi) c u_lam(lam_fi)
        #                         * lam_fi^2 dU_f / (h c E_fi)
        f_idx, i_idx = pairs[:, 0], pairs[:, 1]
        E = U[f_idx] - U[i_idx]
        lam_fi = c.H_PLANCK * c.C_LIGHT / np.maximum(E, 1e-60)
        coeff = (sab_at(b, lam_fi) / max(mg.number_bin[b], 1e-300)
                 * c.C_LIGHT * lam_fi**2 * dU[f_idx]
                 / (c.H_PLANCK * c.C_LIGHT * np.maximum(E, 1e-60)))
        # distribute each lam_fi onto the two neighboring RF-grid centers
        # (linear in log lambda); photons outside the RF grid don't heat
        lg = np.log(rf_c)
        lq = np.log(lam_fi)
        j = np.clip(np.searchsorted(lg, lq) - 1, 0, R - 2)
        t = (lq - lg[j]) / (lg[j + 1] - lg[j])
        inside = (lq >= lg[0]) & (lq <= lg[-1])
        t = np.clip(t, 0.0, 1.0)
        rows = np.arange(NP)
        W = np.zeros((NP, R))
        W[rows, j] = coeff * (1 - t) * inside
        W[rows, j + 1] += coeff * t * inside
        W_up[b] = W

        # emissivity basis: per grain sigma_abs(lam_l) * 4 pi B(lam_l, T_i)
        sa_e = sab_at(b, ems_c) / max(mg.number_bin[b], 1e-300)
        M_ems[b] = 4 * np.pi * sa_e[None, :] * planck.b_lambda_np(
            ems_c[None, :], T[:, None])

    return StochasticTables(T_bins=T_bins, dU=dU_all, cool=cool, W_up=W_up,
                            pairs=pairs, M_ems=M_ems, lam_ems=ems_c,
                            number_bin=np.asarray(mg.number_bin, np.float64))


def state_distribution(tabs: StochasticTables, b: int,
                       u_lam: np.ndarray) -> np.ndarray:
    """P[cells, NT] for size bin b given per-cell spectral energy density
    u_lam (cells, R) [J/m^3/m] on the RF grid centers."""
    nT = tabs.T_bins.shape[1]
    A_up = u_lam @ tabs.W_up[b].T            # (cells, NP)
    ncell = A_up.shape[0]
    # scatter pair rates into dense (cells, NT, NT) is wasteful; build
    # cumulative B_{f,i} = sum_{f'>=f} A_{f',i} directly per column i
    Bmat = np.zeros((ncell, nT, nT))
    f_idx, i_idx = tabs.pairs[:, 0], tabs.pairs[:, 1]
    Bmat[:, f_idx, i_idx] = A_up
    Bmat = np.flip(np.cumsum(np.flip(Bmat, axis=1), axis=1), axis=1)

    X = np.zeros((ncell, nT))
    X[:, 0] = 1.0
    for j in range(1, nT):
        num = np.einsum("ci,ci->c", Bmat[:, j, :j], X[:, :j])
        X[:, j] = num / max(tabs.cool[b, j], 1e-300)
        mx = X.max(axis=1, keepdims=True)
        big = mx[:, 0] > 1e100
        if big.any():
            X[big] /= mx[big]
    s = X.sum(axis=1, keepdims=True)
    return X / np.maximum(s, 1e-300)


def cell_emission_spectra(tabs: StochasticTables, nd: np.ndarray,
                          u_lam: np.ndarray,
                          chunk: int = 4096,
                          component: int = 0) -> np.ndarray:
    """Per-cell stochastic emission spectra eps (ncells, L) [W/m per unit
    volume], summed over size bins: eps = sum_b n_H N_b * (P_b @ M_b).
    `component` is the medium-component index that holds the multi-grain
    dust (nd may carry several media components).
    Drop-in replacement for equilibrium.cell_emission_spectra
    (ref: DustEmissionOptions 'dustEmissionType Stochastic')."""
    nd = np.asarray(nd, np.float64)
    if nd.ndim == 2:
        nd = nd[:, component]
    ncells = u_lam.shape[0]
    L = tabs.lam_ems.size
    eps = np.zeros((ncells, L))
    NB = tabs.T_bins.shape[0]
    for s in range(0, ncells, chunk):
        sl = slice(s, min(s + chunk, ncells))
        for b in range(NB):
            P = state_distribution(tabs, b, u_lam[sl])
            eps[sl] += (nd[sl, None] * tabs.number_bin[b]) * (P @ tabs.M_ems[b])
    return eps


def u_lambda_from_rf(rf, rf_borders, volumes, rf_scale: float = 1.0):
    """Spectral energy density u_lambda (ncells, R) [J/m^3/m] from the
    deposited radiation field rf[cell, r] = sum L ds e^-tau [W m / rf_scale]
    (see transport/lifecycle.propagate_deposit): u = rf / (V c dlam)."""
    rf64 = np.asarray(rf, np.float64) * rf_scale
    dlam = np.diff(np.asarray(rf_borders, np.float64))
    v = np.asarray(volumes, np.float64)
    return rf64 / (v[:, None] * c.C_LIGHT * dlam[None, :])
