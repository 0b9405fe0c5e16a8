"""Medium system: per-cell state + material optical properties, as tables.

Batched redesign of the reference's MediumSystem/MediumState/MaterialMix
triangle (ref: SKIRT/core/MediumSystem.hpp:99, MediumState.hpp:131,
MaterialMix.hpp:195): instead of virtual per-cell dispatch, the medium is a
pair of dense device tables —

  nd[cell, h]      number density of medium component h in cell [1/m^3]
  per-component optical-property tables on a log wavelength axis:
  sigma_ext/sigma_sca[h, :] cross sections per entity [m^2], g[h, :] asymmetry

The hot-path contract: wavelength-dependent properties are gathered ONCE per
packet wavelength into (B, H) arrays ("Optics"), so each traversal step needs
only a gather of nd[cell] and a tiny dot product — no per-step interpolation
(the reference similarly pre-caches cross sections on the simulation
wavelength grid, ref: SKIRT/core/DustMix.hpp:104 setup caching).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import sampling


class MediumTables(NamedTuple):
    nd: jax.Array         # (ncells, H) number density [1/m^3]
    lam_t: jax.Array      # (T,) wavelength table [m], increasing
    sigma_ext: jax.Array  # (H, T) extinction cross section [m^2]
    sigma_sca: jax.Array  # (H, T) scattering cross section [m^2]
    g: jax.Array          # (H, T) HG asymmetry parameter
    bulk_v: jax.Array     # (ncells, 3) bulk velocity [m/s] (kinematics)
    temperature: jax.Array  # (ncells,) gas kinetic temperature [K]
    # extended medium state (ref: MediumState.hpp magneticField,
    # metallicity, custom variables); zeros when not imported/configured
    magnetic_field: jax.Array = None  # (ncells, 3) [T]
    metallicity: jax.Array = None     # (ncells,)
                            # (used by resonant-line materials, e.g. Lya)

    @property
    def ncomp(self) -> int:
        return self.sigma_ext.shape[0]

    @property
    def ncells(self) -> int:
        return self.nd.shape[0]


class Optics(NamedTuple):
    """Per-packet per-component cross sections at the packet wavelength."""

    sigma_ext: jax.Array  # (B, H)
    sigma_sca: jax.Array  # (B, H)
    g: jax.Array          # (B, H)


def optics_at(med: MediumTables, lam: jax.Array) -> Optics:
    """Gather per-component optical properties at packet wavelengths (B,).

    Log-log interpolation for cross sections (power-law between table points,
    the convention of the reference's resource tables), linear for g.
    """
    def per_comp(tab_ext, tab_sca, tab_g):
        se = sampling.interp_loglog(lam, med.lam_t, tab_ext)
        ss = sampling.interp_loglog(lam, med.lam_t, tab_sca)
        gg = sampling.interp_linlin(lam, med.lam_t, tab_g)
        return se, ss, gg

    se, ss, gg = jax.vmap(per_comp, in_axes=0, out_axes=1)(
        med.sigma_ext, med.sigma_sca, med.g
    )
    return Optics(sigma_ext=se, sigma_sca=ss, g=gg)


def opacity_ext(med: MediumTables, opt: Optics, cell: jax.Array) -> jax.Array:
    """Total extinction opacity k[1/m] in each packet's cell (B,).

    Outside cells (cell<0) contribute zero.
    """
    nd = med.nd[jnp.maximum(cell, 0)]  # (B,H)
    k = jnp.sum(nd * opt.sigma_ext, axis=-1)
    return jnp.where(cell >= 0, k, 0.0)


def opacity_sca(med: MediumTables, opt: Optics, cell: jax.Array) -> jax.Array:
    nd = med.nd[jnp.maximum(cell, 0)]
    k = jnp.sum(nd * opt.sigma_sca, axis=-1)
    return jnp.where(cell >= 0, k, 0.0)


def albedo_for_scattering(med: MediumTables, opt: Optics, cell: jax.Array) -> jax.Array:
    """Aggregate albedo = k_sca/k_ext at the interaction cell
    (ref: MediumSystem::albedoForScattering, MediumSystem.cpp:678)."""
    if med.ncomp == 1:
        # single component: the density cancels — no per-cell gather needed
        ke = opt.sigma_ext[..., 0]
        ks = opt.sigma_sca[..., 0]
        return jnp.where(ke > 0, ks / jnp.maximum(ke, 1e-30), 0.0)
    ke = opacity_ext(med, opt, cell)
    ks = opacity_sca(med, opt, cell)
    return jnp.where(ke > 0, ks / jnp.maximum(ke, 1e-30), 0.0)


def scattering_weights(med: MediumTables, opt: Optics, cell: jax.Array) -> jax.Array:
    """Per-component scattering-opacity weights (B, H), normalized.

    Used both to select the scattering component (ref:
    MediumSystem::simulateScattering h-selection cdf) and to weight the
    per-component phase functions in peel-off (ref:
    MediumSystem::peelOffScattering, MediumSystem.cpp:734).
    """
    if med.ncomp == 1:
        return jnp.ones(cell.shape + (1,), jnp.float32)
    nd = med.nd[jnp.maximum(cell, 0)]
    w = nd * opt.sigma_sca
    tot = jnp.sum(w, axis=-1, keepdims=True)
    return w / jnp.maximum(tot, 1e-30)


def select_component(med: MediumTables, opt: Optics, cell: jax.Array, u: jax.Array) -> jax.Array:
    """Sample the scattering component index per packet from the weights."""
    if med.ncomp == 1:
        return jnp.zeros(cell.shape, jnp.int32)
    w = scattering_weights(med, opt, cell)
    cdf = jnp.cumsum(w, axis=-1)
    return jnp.argmax(cdf >= u[..., None], axis=-1).astype(jnp.int32)


# ------------------------------------------------------------------ builders

def uniform_density_sphere(grid, tau_radius: float, sigma_ext_val: float,
                           radius: float, center=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Host-side: per-cell number density for a uniform sphere with radial
    optical depth tau_radius at the reference cross-section. Sampled at cell
    centers (the reference samples density numDensitySamples times per cell,
    ref: SamplingOptions.hpp:50; center sampling is its N=1 case)."""
    centers = np.asarray(grid.cell_centers())
    r = np.linalg.norm(centers - np.asarray(center), axis=-1)
    nd_val = tau_radius / (sigma_ext_val * radius)
    return np.where(r <= radius, nd_val, 0.0).astype(np.float32)


def make_medium(grid, nd: np.ndarray, lam_t: np.ndarray, sigma_ext: np.ndarray,
                albedo: np.ndarray, g: np.ndarray,
                bulk_v: np.ndarray | None = None,
                temperature: np.ndarray | None = None,
                magnetic_field: np.ndarray | None = None,
                metallicity: np.ndarray | None = None) -> MediumTables:
    """Assemble MediumTables from host arrays.

    nd: (ncells,) or (ncells,H); tables: (T,) or (H,T).
    """
    nd = np.asarray(nd, np.float32)
    if nd.ndim == 1:
        nd = nd[:, None]
    lam_t = np.asarray(lam_t, np.float64)
    sigma_ext = np.atleast_2d(np.asarray(sigma_ext, np.float64))
    albedo = np.atleast_2d(np.asarray(albedo, np.float64))
    g = np.atleast_2d(np.asarray(g, np.float64))
    sigma_sca = sigma_ext * albedo
    if bulk_v is None:
        bulk_v = np.zeros((nd.shape[0], 3), np.float32)
    if temperature is None:
        temperature = np.zeros(nd.shape[0], np.float32)
    if magnetic_field is None:
        magnetic_field = np.zeros((nd.shape[0], 3), np.float32)
    if metallicity is None:
        metallicity = np.zeros(nd.shape[0], np.float32)
    return MediumTables(
        nd=jnp.asarray(nd),
        lam_t=jnp.asarray(lam_t, jnp.float32),
        sigma_ext=jnp.asarray(sigma_ext, jnp.float32),
        sigma_sca=jnp.asarray(sigma_sca, jnp.float32),
        g=jnp.asarray(g, jnp.float32),
        bulk_v=jnp.asarray(bulk_v, jnp.float32),
        temperature=jnp.asarray(temperature, jnp.float32),
        magnetic_field=jnp.asarray(magnetic_field, jnp.float32),
        metallicity=jnp.asarray(metallicity, jnp.float32),
    )
