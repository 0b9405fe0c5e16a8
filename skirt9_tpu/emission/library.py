"""Spatial cell libraries: group cells for shared dust-emission spectra.

Batched counterpart of the reference's SpatialCellLibrary family
(ref: SKIRT/core/SpatialCellLibrary.hpp, FieldStrengthCellLibrary.cpp:20-70,
TemperatureWavelengthCellLibrary.cpp:25-120, AllCellsLibrary; consumed by
DustSecondarySource.cpp:214-258). The reference walks cells sequentially,
caching the last entry's spectrum; here the mapping and the per-entry
radiation-field averages are single vectorized host passes (np.add.at
scatter means), and the per-cell emission temperatures become a gather of
the per-entry temperatures — the downstream batched spectrum machinery is
unchanged.

All libraries expose mapping(...) -> (ncells,) int entry indices, -1 for
cells excluded from secondary emission.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Mathis et al. 1983 local ISRF (ref: FieldStrengthCellLibrary.cpp:29)
JTOT_MW = 1.7623e-06


@dataclasses.dataclass(frozen=True)
class AllCellsLibrary:
    """Identity mapping: every cell is its own entry (the default)."""

    def n_entries(self, ncells: int) -> int:
        return ncells

    def mapping(self, J, dlam, mask, sigma_abs=None, T_ind=None,
                lam_c=None):
        m = np.arange(J.shape[0], dtype=np.int64)
        return np.where(mask, m, -1)


@dataclasses.dataclass(frozen=True)
class FieldStrengthCellLibrary:
    """1-D library over log10 of the Habing-normalized bolometric field
    strength (ref: FieldStrengthCellLibrary.cpp:20-70)."""

    num_field_strengths: int = 1000

    def n_entries(self, ncells: int) -> int:
        return self.num_field_strengths

    def mapping(self, J, dlam, mask, sigma_abs=None, T_ind=None,
                lam_c=None):
        U = (np.asarray(J, np.float64) * dlam).sum(axis=1) / JTOT_MW
        use = mask & (U > 1e-6)
        if not use.any():
            return np.full(J.shape[0], -1, np.int64)
        logU = np.log10(np.maximum(U, 1e-300))
        lo, hi = logU[use].min(), logU[use].max()
        d = max((hi - lo) / self.num_field_strengths, 1e-12)
        n = np.clip(((logU - lo) / d).astype(np.int64), 0,
                    self.num_field_strengths - 1)
        return np.where(use, n, -1)


@dataclasses.dataclass(frozen=True)
class TemperatureWavelengthCellLibrary:
    """2-D library over indicative dust temperature (linear bins) and
    absorption-weighted mean wavelength (log bins)
    (ref: TemperatureWavelengthCellLibrary.cpp:25-120)."""

    num_temperatures: int = 40
    num_wavelengths: int = 25

    def n_entries(self, ncells: int) -> int:
        return self.num_temperatures * self.num_wavelengths

    def mapping(self, J, dlam, mask, sigma_abs=None, T_ind=None,
                lam_c=None):
        if sigma_abs is None or T_ind is None:
            raise ValueError("TemperatureWavelengthCellLibrary needs "
                             "sigma_abs (R,) and indicative T (ncells,)")
        if lam_c is None:
            raise ValueError("TemperatureWavelengthCellLibrary needs lam_c")
        J = np.asarray(J, np.float64)
        lam_c = np.asarray(lam_c, np.float64)
        prod = J * (sigma_abs * dlam)[None, :]          # (ncells, R)
        bot = prod.sum(axis=1)
        lam_ind = np.where(bot > 0, (prod * lam_c).sum(axis=1)
                           / np.maximum(bot, 1e-300), 0.0)
        T = np.asarray(T_ind, np.float64)
        use = mask & (T > 0) & (lam_ind > 0)
        if not use.any():
            return np.full(J.shape[0], -1, np.int64)
        Tmin, Tmax = T[use].min(), T[use].max()
        dT = max((Tmax - Tmin) / self.num_temperatures, 1e-12)
        i = np.clip(((T - Tmin) / dT).astype(np.int64), 0,
                    self.num_temperatures - 1)
        ll = np.log10(np.maximum(lam_ind, 1e-300))
        lmin, lmax = ll[use].min(), ll[use].max()
        dl = max((lmax - lmin) / self.num_wavelengths, 1e-12)
        j = np.clip(((ll - lmin) / dl).astype(np.int64), 0,
                    self.num_wavelengths - 1)
        return np.where(use, i + self.num_temperatures * j, -1)



def entry_average(x: np.ndarray, mapping: np.ndarray,
                  n_entries: int) -> np.ndarray:
    """Unweighted mean of x (ncells, ...) over each entry's member cells
    (ref: DustSecondarySource.cpp:235-238 average radiation field)."""
    x = np.asarray(x, np.float64)
    m = np.asarray(mapping, np.int64)
    valid = m >= 0
    out = np.zeros((n_entries,) + x.shape[1:])
    cnt = np.zeros(n_entries)
    np.add.at(out, m[valid], x[valid])
    np.add.at(cnt, m[valid], 1.0)
    cnt = np.maximum(cnt, 1.0)
    return out / cnt.reshape((n_entries,) + (1,) * (x.ndim - 1))


def library_temperatures(library, med, etabs, rf, vols, rf_scale,
                         rf_borders) -> np.ndarray:
    """Per-cell equilibrium temperatures computed through the library:
    average the cells' radiation fields per entry, solve the energy balance
    once per entry, gather back to cells. Cells mapped to -1 get T=0 (no
    emission). Returns (ncells, H)."""
    from . import equilibrium as eq
    rf64 = np.asarray(rf, np.float64)
    v = np.asarray(vols, np.float64)
    rb = np.asarray(rf_borders, np.float64)
    dlam = np.diff(rb)
    # mean intensity per cell [W/m^3/sr]
    J = rf64 * rf_scale / (4.0 * np.pi * v[:, None] * dlam[None, :])
    nd = np.asarray(med.nd, np.float64)
    mask = nd.sum(axis=1) > 0
    kwargs = {}
    if isinstance(library, TemperatureWavelengthCellLibrary):
        kwargs["lam_c"] = np.sqrt(rb[1:] * rb[:-1])
        sab = np.asarray(etabs.sigma_abs_rf, np.float64)  # (H, R)
        p_abs = eq.absorbed_power(med, etabs, rf, vols, rf_scale)
        T_all = eq.equilibrium_temperature(etabs, p_abs)
        kwargs["T_ind"] = (T_all * np.maximum(nd, 1e-300)).sum(axis=1) \
            / np.maximum(nd.sum(axis=1), 1e-300)
        # per-cell mean sigma changes with density; the reference uses the
        # cell's own opacity — approximate with the density-weighted mean
        kwargs["sigma_abs"] = sab.mean(axis=0)
    n_ent = library.n_entries(rf64.shape[0])
    mapping = library.mapping(J, dlam, mask, **kwargs)
    # normalized field density per cell feeding the energy balance
    rfd = rf64 * rf_scale / v[:, None]                  # (ncells, R)
    rfd_ent = entry_average(rfd, mapping, n_ent)
    sab = np.asarray(etabs.sigma_abs_rf, np.float64)
    p_abs_ent = rfd_ent @ sab.T                         # (n_ent, H)
    T_ent = eq.equilibrium_temperature(etabs, p_abs_ent)
    T = np.zeros((rf64.shape[0], T_ent.shape[1]))
    valid = mapping >= 0
    T[valid] = T_ent[mapping[valid]]
    return T
