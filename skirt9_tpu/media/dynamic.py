"""Dynamic medium state: recipes updating densities from the radiation field.

Batched counterpart of the reference's DynamicStateRecipe machinery
(ref: SKIRT/core/DynamicStateRecipe.hpp:67, ClearDensityRecipe.cpp:20-35,
DustDestructionRecipe.cpp:49-90, LinearDustDestructionRecipe.cpp:21-31).
The reference updates per-cell MaterialState objects one cell at a time
inside `MediumSystem::updatePrimaryDynamicMediumState`; here each recipe is
a vectorized host-side pass over the full (ncells, H) density table driven
by the accumulated radiation field — one numpy sweep per iteration instead
of a per-cell virtual call.

Deviation from the reference noted per recipe: dust destruction applies a
mass-weighted aggregate density fraction to the multi-grain component
instead of tracking per-fragment dynamic densities (the
FragmentDustMixDecorator custom-state mechanism); the temperature physics
per size bin is identical.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# local interstellar radiation field integrated over wavelength
# (Mathis et al. 1983; ref: ClearDensityRecipe.cpp:25)
JTOT_MW = 1.7623e-06


class UpdateResult:
    """Aggregate of per-cell update outcomes (ref: UpdateStatus)."""

    def __init__(self, nd, n_updated: int, n_not_converged: int):
        self.nd = nd
        self.n_updated = int(n_updated)
        self.n_not_converged = int(n_not_converged)


def field_strength(rf, volumes, rf_scale: float) -> np.ndarray:
    """Habing-normalized bolometric field strength U per cell.

    rf[cell, bin] stores sum of L ds e^-tau path segments [W m] in units of
    rf_scale, so sum_bins rf * rf_scale / (4 pi V) = integral J_lam dlam.
    """
    rf64 = np.asarray(rf, np.float64)
    v = np.asarray(volumes, np.float64)
    Jtot = rf64.sum(axis=1) * rf_scale / (4.0 * np.pi * v)
    return Jtot / JTOT_MW


@dataclasses.dataclass
class ClearDensityRecipe:
    """Clear all material from cells whose field strength exceeds a
    threshold (ref: ClearDensityRecipe.cpp:20-35)."""

    field_strength_threshold: float = 1.0

    def update(self, nd: np.ndarray, rf, volumes,
               rf_scale: float, context=None) -> UpdateResult:
        nd = np.asarray(nd, np.float64).copy()
        U = field_strength(rf, volumes, rf_scale)
        has = nd.sum(axis=1) > 0.0
        clear = has & (U > self.field_strength_threshold)
        nd[clear] = 0.0
        n = int(clear.sum())
        return UpdateResult(nd, n, n)


@dataclasses.dataclass
class LinearDustDestructionRecipe:
    """Destroy dust grains linearly between a minimum and maximum
    equilibrium temperature (ref: LinearDustDestructionRecipe.cpp:21-31:
    f = 1 below Tmin, 0 above Tmax, (Tmax-T)/(Tmax-Tmin) in between,
    per grain-size bin; silicate vs graphite thresholds).

    Requires the multi-grain tables of the dust component (per-size-bin
    absorption cross sections + labels) to evaluate per-bin equilibrium
    temperatures from the cell radiation field.
    """

    grain_tables: object                  # media.grains.MultiGrainTables
    rf_borders: np.ndarray                # radiation-field bin borders [m]
    component: int = 0                    # medium component holding the dust
    min_silicate_temperature: float = 1200.0
    max_silicate_temperature: float = 1400.0
    min_graphite_temperature: float = 2000.0
    max_graphite_temperature: float = 2200.0
    density_fraction_tolerance: float = 0.05

    def __post_init__(self):
        from ..ops import planck
        mg = self.grain_tables
        lam = np.asarray(mg.lam, np.float64)
        rb = np.asarray(self.rf_borders, np.float64)
        rf_c = np.sqrt(rb[1:] * rb[:-1])
        sab = np.asarray(mg.sigma_abs_bin, np.float64)  # (NB, L)
        # per-bin sigma_abs on the RF grid centers (log-log interp)
        self._sab_rf = np.exp([np.interp(np.log(rf_c), np.log(lam),
                                         np.log(np.maximum(s, 1e-300)))
                               for s in sab])            # (NB, R)
        # per-bin P_em(T) table for temperature inversion
        lam_int = np.geomspace(1e-8, 1e-2, 600)
        sab_int = np.exp([np.interp(np.log(lam_int), np.log(lam),
                                    np.log(np.maximum(s, 1e-300)))
                          for s in sab])                 # (NB, LI)
        T_grid = np.geomspace(2.0, 5000.0, 256)
        B = planck.b_lambda_np(lam_int[None, :], T_grid[:, None])  # (NT, LI)
        self._T_grid = T_grid
        self._P_em = 4 * np.pi * np.trapezoid(
            sab_int[:, None, :] * B[None, :, :], lam_int, axis=-1)  # (NB,NT)
        # graphitic bins use the graphite thresholds (incl. PAHs, which the
        # reference treats as graphite for destruction purposes)
        names = [str(lbl[0]) for lbl in mg.labels]
        self._graphite = np.array(
            ["gra" in n.lower() or "pah" in n.lower() for n in names])
        # mass weights for the aggregate component density fraction
        self._mass_w = (np.asarray(mg.mass_bin, np.float64)
                        * np.asarray(mg.number_bin, np.float64))
        self._prev_frac = None

    def bin_temperatures(self, rf, volumes, rf_scale: float) -> np.ndarray:
        """Equilibrium temperature per (cell, size bin)."""
        rf64 = np.asarray(rf, np.float64)
        v = np.asarray(volumes, np.float64)
        # absorbed power per grain per bin: sigma_abs . rf / V
        p_abs = (rf64 @ self._sab_rf.T) * (rf_scale / v)[:, None]  # (N, NB)
        lT = np.log(self._T_grid)
        T = np.empty_like(p_abs)
        for b in range(self._P_em.shape[0]):
            lp = np.log(np.maximum(p_abs[:, b], 1e-300))
            lP = np.log(np.maximum(self._P_em[b], 1e-300))
            T[:, b] = np.exp(np.interp(lp, lP, lT))
        return T

    def update(self, nd: np.ndarray, rf, volumes,
               rf_scale: float, context=None) -> UpdateResult:
        nd = np.asarray(nd, np.float64).copy()
        T = self.bin_temperatures(rf, volumes, rf_scale)   # (N, NB)
        Tmin = np.where(self._graphite, self.min_graphite_temperature,
                        self.min_silicate_temperature)
        Tmax = np.where(self._graphite, self.max_graphite_temperature,
                        self.max_silicate_temperature)
        frac = np.clip((Tmax - T) / np.maximum(Tmax - Tmin, 1e-30), 0.0, 1.0)
        if context is None or "nd0" not in context:
            raise ValueError("DustDestructionRecipe needs the pristine "
                             "densities in context['nd0']")
        nd0 = np.asarray(context["nd0"], np.float64)
        # aggregate mass-weighted fraction -> component density scale
        w = self._mass_w / self._mass_w.sum()
        f_cell = frac @ w                                   # (N,)
        prev = self._prev_frac if self._prev_frac is not None \
            else np.ones_like(f_cell)
        diff = np.abs(f_cell - prev)
        updated = diff > 1e-6
        not_conv = diff > self.density_fraction_tolerance
        nd[:, self.component] = nd0[:, self.component] * f_cell
        self._prev_frac = f_cell
        return UpdateResult(nd, int(updated.sum()), int(not_conv.sum()))


@dataclasses.dataclass
class NonLTELineRecipe:
    """Couple NonLTE level populations to the radiation field through the
    primary-emission iteration flow (ref: NonLTELineGasMix.hpp:289 — the
    statistical-equilibrium solve repeats each primary iteration with the
    current mean intensity until the populations converge).

    The recipe updates the line component's EFFECTIVE absorber density
    n_eff = n_l - (g_l/g_u) n_u for the configured transition (stimulated
    emission enters as negative absorption, the reference's negative-
    extinction capability) from populations solved with J at the line
    frequency taken from the stored radiation field.
    """

    mol: object                 # nonlte.MoleculeData
    component: int              # medium component holding the line opacity
    n_mol: np.ndarray           # (ncells,) molecule number density [1/m^3]
    n_col: np.ndarray           # (ncells,) collision-partner density
    T_kin: np.ndarray           # (ncells,) kinetic temperature [K]
    rf_borders: np.ndarray      # RF wavelength borders (for J at lines)
    transition: int = 0         # line index driving the opacity
    max_change: float = 0.05    # convergence: max relative pop change

    def update(self, nd: np.ndarray, rf, volumes,
               rf_scale: float, context=None) -> UpdateResult:
        from . import nonlte as nl

        rf64 = np.asarray(rf, np.float64)
        v = np.asarray(volumes, np.float64)
        rb = np.asarray(self.rf_borders, np.float64)
        dlam = np.diff(rb)
        # J_lambda per cell per bin [W/m^3/sr] -> J_nu at line frequencies
        J_lam = rf64 * rf_scale / (4.0 * np.pi * v[:, None] * dlam[None, :])
        lam_line = np.asarray(self.mol.line_lam)
        k = np.clip(np.searchsorted(rb, lam_line) - 1, 0, rf64.shape[1] - 1)
        C = 2.99792458e8
        J_nu = J_lam[:, k] * (lam_line[None, :] ** 2 / C)   # (ncells, M)
        pops = np.asarray(nl.solve_populations(self.mol, self.n_col,
                                               self.T_kin, J_rad=J_nu))
        prev = context.get("nonlte_pops") if context else None
        if context is not None:
            context["nonlte_pops"] = pops
        li = self.transition
        u, l = int(self.mol.up[li]), int(self.mol.lo[li])
        g = np.asarray(self.mol.g, np.float64)
        n_eff = self.n_mol * (pops[:, l] - (g[l] / g[u]) * pops[:, u])
        nd = np.array(nd, np.float64, copy=True)
        changed = np.abs(nd[:, self.component] - n_eff) \
            > 1e-6 * np.maximum(np.abs(n_eff), 1e-300)
        nd[:, self.component] = n_eff
        if prev is None:
            n_not = len(nd)
        else:
            rel = np.abs(pops - prev) / np.maximum(np.abs(prev), 1e-12)
            n_not = int((rel.max(axis=1) > self.max_change).sum())
        return UpdateResult(nd, int(changed.sum()), n_not)
