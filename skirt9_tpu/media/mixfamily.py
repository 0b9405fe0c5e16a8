"""Per-cell material-mix families: a different mix in every cell.

Counterpart of the reference's MaterialMixFamily machinery (ref:
SKIRT/core/MaterialMixFamily.hpp + SelectDustMixFamily — an ImportedMedium
can hand each cell its own mix selected by an imported parameter;
FragmentDustMixDecorator.hpp:39 — a multi-grain mix decomposed into its
population fragments, each carrying per-cell weight state).

Batched design: a family of K mixes expands into K MEDIUM COMPONENTS
sharing the engine's existing multi-component machinery — cell c with
family index f gets nd[c, k] = n(c) * [k == f]. Per-cell dispatch
becomes plain dense per-component math (no per-cell virtual calls, no
gather of mix tables); memory is ncells x K, small for the handful of
mixes a family holds. Fragment weights are then just the per-component
densities, updatable by dynamic-state recipes exactly like the
reference's fragment weight state.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import mixes as mx
from . import system as msys


@dataclasses.dataclass(frozen=True)
class SelectDustMixFamily:
    """A discrete family: imported parameter selects one of `mixes`
    (ref: SelectDustMixFamily — 'select one of the configured dust mixes
    based on the value of an imported parameter')."""

    mixes: tuple

    @property
    def num_mixes(self) -> int:
        return len(self.mixes)

    def indices(self, param: np.ndarray) -> np.ndarray:
        """Parameter -> mix index: the reference rounds the imported value
        to the nearest configured index (1-based in ski files)."""
        i = np.rint(np.asarray(param, np.float64)).astype(np.int64) - 1
        return np.clip(i, 0, self.num_mixes - 1)


def family_medium(grid, nd_total: np.ndarray, family: SelectDustMixFamily,
                  param: np.ndarray, bulk_v=None) -> msys.MediumTables:
    """MediumTables with one component per family member: cell c's density
    lands in the component its parameter selects."""
    idx = family.indices(param)
    K = family.num_mixes
    nd = np.zeros((len(nd_total), K), np.float32)
    nd[np.arange(len(nd_total)), idx] = np.asarray(nd_total, np.float64)
    lam, se, al, g = mx.stack(list(family.mixes))
    return msys.make_medium(grid, nd, lam, se, al, g, bulk_v=bulk_v)


def fragment_mixes(mg, per_size_bin: bool = False):
    """Decompose a multi-grain build into population-fragment mixes
    (ref: FragmentDustMixDecorator.hpp:39 — fragments behave as separate
    medium components whose weights form per-cell state).

    mg: media.grains.MultiGrainTables. Returns a list of MixTables, one
    per population (or per size bin with per_size_bin), with absorption
    split by the per-bin cross sections and the scattering/asymmetry
    inherited from the representative grain.
    """
    lam = np.asarray(mg.lam, np.float64)
    mixm = mg.mix
    sab = np.asarray(mg.sigma_abs_bin, np.float64)       # (NB, L)
    if per_size_bin:
        groups = [[b] for b in range(sab.shape[0])]
    else:
        pops = {}
        for b, (pop, _) in enumerate(mg.labels):
            pops.setdefault(pop, []).append(b)
        groups = list(pops.values())
    tot_abs = np.maximum(sab.sum(axis=0), 1e-300)
    sig_ext_t = np.interp(lam, mixm.lam, mixm.sigma_ext)
    alb_t = np.interp(lam, mixm.lam, mixm.albedo)
    g_t = np.interp(lam, mixm.lam, mixm.g)
    sig_sca_t = sig_ext_t * alb_t
    sig_abs_t = sig_ext_t - sig_sca_t
    out = []
    for grp in groups:
        frac = sab[grp].sum(axis=0) / tot_abs
        s_abs = sig_abs_t * frac
        s_sca = sig_sca_t * frac          # scattering split proportionally
        s_ext = s_abs + s_sca
        out.append(mx.tabulated(lam, s_ext,
                                np.where(s_ext > 0, s_sca
                                         / np.maximum(s_ext, 1e-300), 0.0),
                                g_t, mu=mixm.mu))
    return out
