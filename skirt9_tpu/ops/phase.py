"""Scattering phase functions: Henyey-Greenstein and dipole (Rayleigh/Thomson).

Batched, branch-free device functions. The reference implements HG sampling
and evaluation inside DustMix (ref: SKIRT/core/DustMix.hpp:51-100) and the
dipole phase function for electrons (ref: SKIRT/core/DipolePhaseFunction.hpp).
All functions take/return (B,) or (B,3) arrays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_ISO = 1.0 / (4.0 * jnp.pi)


def hg_phase(g: jnp.ndarray, costheta: jnp.ndarray) -> jnp.ndarray:
    """HG phase function value Phi(cos t), normalized to 1 over 4pi sr:
    (1/4pi) (1-g^2) / (1 + g^2 - 2 g cos t)^{3/2}. g=0 -> isotropic."""
    t = 1.0 + g * g - 2.0 * g * costheta
    return _ISO * (1.0 - g * g) / jnp.maximum(t * jnp.sqrt(t), 1e-30)


def hg_sample_costheta(g: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    """Inverse-cdf sample of cos(theta) from the HG phase function.

    Stable for g -> 0 (series switch), matching the reference's handling of
    near-isotropic grains (ref: DustMix HG generateCosineFromPhaseFunction).
    """
    near_iso = jnp.abs(g) < 1e-5
    gs = jnp.where(near_iso, 0.5, g)  # safe value to avoid 0/0 in the traced branch
    f = (1.0 - gs * gs) / (1.0 - gs + 2.0 * gs * u)
    ct_aniso = (1.0 + gs * gs - f * f) / (2.0 * gs)
    ct_iso = 2.0 * u - 1.0
    return jnp.clip(jnp.where(near_iso, ct_iso, ct_aniso), -1.0, 1.0)


def dipole_phase(costheta: jnp.ndarray) -> jnp.ndarray:
    """Dipole (Rayleigh/Thomson) phase function, normalized over 4pi:
    (3/16pi)(1+cos^2 t) (ref: DipolePhaseFunction.cpp)."""
    return 3.0 / (16.0 * jnp.pi) * (1.0 + costheta * costheta)


def dipole_sample_costheta(u: jnp.ndarray) -> jnp.ndarray:
    """Invert the dipole cdf: cos t solves mu^3 + 3 mu + (4 - 8u) = 0;
    closed-form Cardano root (the cubic is monotone, single real root)
    (ref: DipolePhaseFunction.cpp generateCosineFromPhaseFunction)."""
    p = 4.0 * u - 2.0
    d = jnp.sqrt(1.0 + p * p)
    return jnp.clip(jnp.cbrt(p + d) + jnp.cbrt(p - d), -1.0, 1.0)


def rotate_direction(k: jnp.ndarray, costheta: jnp.ndarray, phi: jnp.ndarray) -> jnp.ndarray:
    """New direction at polar angle (costheta, phi) relative to axis k (B,3).

    Builds an orthonormal frame around k without branches (robust Frisvad-style
    construction handling k_z ~ +-1), then rotates. Replaces the reference's
    Direction trigonometric construction (ref: SKIRT/core/Random.cpp direction
    overload with (bfk, costheta)).
    """
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    sign = jnp.where(kz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + kz)
    b = kx * ky * a
    e1 = jnp.stack([1.0 + sign * kx * kx * a, sign * b, -sign * kx], axis=-1)
    e2 = jnp.stack([b, sign + ky * ky * a, -ky], axis=-1)
    sint = jnp.sqrt(jnp.maximum(0.0, 1.0 - costheta * costheta))
    cp = jnp.cos(phi)
    sp = jnp.sin(phi)
    out = (
        sint[..., None] * (cp[..., None] * e1 + sp[..., None] * e2)
        + costheta[..., None] * k
    )
    # renormalize to counter f32 drift over many scatterings
    return out / jnp.linalg.norm(out, axis=-1, keepdims=True)


# ------------------------------------------------- tabulated phase functions

def build_tabulated_phase(lam_grid, ct_grid, phase):
    """Device tables for a custom (lambda, costheta) phase function
    (ref: DustMix ScatteringMode::MaterialPhaseFunction — scattering by a
    tabulated phase function instead of Henyey-Greenstein,
    DustMix.hpp:319). `phase` (T, A) is normalized so that
    (1/2) integral phase d(costheta) = 1 per wavelength row; a sampling
    cdf over costheta accompanies it."""
    import numpy as np
    lam_grid = np.asarray(lam_grid, np.float64)
    ct = np.asarray(ct_grid, np.float64)
    ph = np.maximum(np.asarray(phase, np.float64), 0.0)
    norm = 0.5 * np.trapezoid(ph, ct, axis=-1)
    ph = ph / np.maximum(norm[:, None], 1e-300)
    seg = 0.5 * (ph[:, 1:] + ph[:, :-1]) * np.diff(ct)[None, :]
    cdf = np.concatenate([np.zeros((ph.shape[0], 1)),
                          np.cumsum(seg, axis=-1)], axis=-1)
    cdf = cdf / np.maximum(cdf[:, -1:], 1e-300)
    return {"lam": jnp.asarray(lam_grid, jnp.float32),
            "ct": jnp.asarray(ct, jnp.float32),
            "phase": jnp.asarray(ph, jnp.float32),
            "cdf": jnp.asarray(cdf, jnp.float32)}


def _lam_row_weights(tabs, lam):
    from . import sampling as smp
    lg = tabs["lam"]
    i = jnp.clip(smp.searchsorted_right(lg, lam) - 1, 0, lg.shape[0] - 2)
    l0 = smp.take_small(lg, i)
    l1 = smp.take_small(lg, i + 1)
    f = jnp.clip((lam - l0) / jnp.maximum(l1 - l0, 1e-37), 0.0, 1.0)
    return i, f


def tabulated_phase_value(tabs, lam, ct):
    """Phase value per (lane lambda, lane costheta), normalized per sr
    times 4pi (divide by 4pi for per-steradian peel-off weights)."""
    from . import sampling as smp
    i, f = _lam_row_weights(tabs, lam)
    ctg = tabs["ct"]
    j = jnp.clip(smp.searchsorted_right(ctg, ct) - 1, 0,
                 ctg.shape[0] - 2)
    c0 = smp.take_small(ctg, j)
    c1 = smp.take_small(ctg, j + 1)
    g = jnp.clip((ct - c0) / jnp.maximum(c1 - c0, 1e-37), 0.0, 1.0)

    def at(ii, jj):
        # dense 2-D lookup: one-hot over rows x one-hot over cols
        P = tabs["phase"]
        oh_r = (ii[:, None] == jnp.arange(P.shape[0], dtype=jnp.int32))
        rows = jnp.dot(oh_r.astype(P.dtype), P,
                       precision=jax.lax.Precision.HIGHEST)   # (B, A)
        return smp.take_along_small(rows, jj)

    v00 = at(i, j)
    v01 = at(i, j + 1)
    v10 = at(i + 1, j)
    v11 = at(i + 1, j + 1)
    return ((1 - f) * ((1 - g) * v00 + g * v01)
            + f * ((1 - g) * v10 + g * v11))


def tabulated_phase_sample(tabs, lam, u):
    """Sample costheta from the tabulated phase function's cdf at each
    lane's wavelength (nearest wavelength row; the reference interpolates
    the cdf rows the same way its per-lambda tables do)."""
    from . import sampling as smp
    i, f = _lam_row_weights(tabs, lam)
    irow = jnp.where(f > 0.5, i + 1, i)
    C = tabs["cdf"]
    oh_r = (irow[:, None] == jnp.arange(C.shape[0], dtype=jnp.int32))
    rows = jnp.dot(oh_r.astype(C.dtype), C,
                   precision=jax.lax.Precision.HIGHEST)       # (B, A)
    j = jnp.clip(jnp.sum((rows < u[:, None]).astype(jnp.int32),
                         axis=-1) - 1, 0, C.shape[1] - 2)
    c0 = smp.take_along_small(rows, j)
    c1 = smp.take_along_small(rows, j + 1)
    g = jnp.where(c1 > c0, (u - c0) / jnp.maximum(c1 - c0, 1e-37), 0.5)
    ctg = tabs["ct"]
    t0 = smp.take_small(ctg, j)
    return t0 + g * (smp.take_small(ctg, j + 1) - t0)
