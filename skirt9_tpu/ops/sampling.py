"""Numerical toolkit: interpolation, cdf construction and batched inversion.

Batched analog of the reference's NR namespace
(ref: SKIRT/utils/NR.hpp — interpolation, cdf construction, sampling).
Host-side cdf *construction* uses numpy f64 (setup time, exactness matters);
device-side *inversion* is batched jnp (hot path).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------- host (setup)

def cdf_linlin(xv: np.ndarray, pv: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Normalized cdf of a piecewise-linear density p(x) on grid xv.

    Returns (cdf at the grid points, normalization integral).
    (ref: NR::cdf with linear interpolation.)
    """
    xv = np.asarray(xv, dtype=np.float64)
    pv = np.asarray(pv, dtype=np.float64)
    seg = 0.5 * (pv[1:] + pv[:-1]) * np.diff(xv)
    cdf = np.concatenate([[0.0], np.cumsum(seg)])
    total = cdf[-1]
    if total <= 0:
        raise ValueError("cannot build cdf of non-positive density")
    return cdf / total, total


def cdf_loglog(xv: np.ndarray, pv: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """cdf of a density that is log-log (power-law) between grid points
    (ref: NR::cdf2 log-log variant used for SEDs/dust cross sections)."""
    xv = np.asarray(xv, dtype=np.float64)
    pv = np.asarray(pv, dtype=np.float64).copy()
    tiny = np.finfo(np.float64).tiny
    pv = np.maximum(pv, tiny)
    alpha = np.log(pv[1:] / pv[:-1]) / np.log(xv[1:] / xv[:-1])
    # integral of p0*(x/x0)^alpha dx over [x0,x1]
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        seg = np.where(
            np.abs(alpha + 1.0) > 1e-6,
            pv[:-1] * xv[:-1] / (alpha + 1.0) * ((xv[1:] / xv[:-1]) ** (alpha + 1.0) - 1.0),
            pv[:-1] * xv[:-1] * np.log(xv[1:] / xv[:-1]),
        )
    cdf = np.concatenate([[0.0], np.cumsum(seg)])
    total = cdf[-1]
    return cdf / total, total


# ---------------------------------------------------- device (hot path, batched)
#
# Small-table lookups use a dense compare-reduce over the table instead of
# a gather/searchsorted, for tables up to _DENSE_MAX entries; larger tables
# take the gather. Whether the dense form still pays on a GPU is open.

_DENSE_MAX = 2048


def take_small(tab: jnp.ndarray, i: jnp.ndarray) -> jnp.ndarray:
    """tab[i] for a small 1-D table without a serialized gather."""
    L = tab.shape[0]
    if L > _DENSE_MAX:
        return tab[i]
    oh = i[..., None] == jnp.arange(L, dtype=jnp.int32)
    return jnp.sum(jnp.where(oh, tab, jnp.zeros((), tab.dtype)), axis=-1)


def take_along_small(rows: jnp.ndarray, j: jnp.ndarray) -> jnp.ndarray:
    """rows[i, j[i]] for (B, L) rows with small L, without a serialized
    per-lane gather (dense one-hot reduce over L)."""
    L = rows.shape[-1]
    if L > _DENSE_MAX:
        return jnp.take_along_axis(rows, j[..., None], axis=-1)[..., 0]
    oh = j[..., None] == jnp.arange(L, dtype=jnp.int32)
    return jnp.sum(jnp.where(oh, rows, jnp.zeros((), rows.dtype)), axis=-1)


def searchsorted_right(tab: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """searchsorted(tab, x, side='right') without per-round gathers."""
    if tab.shape[0] > _DENSE_MAX:
        return jnp.searchsorted(tab, x, side="right")
    return jnp.sum((tab <= x[..., None]).astype(jnp.int32), axis=-1)


def interp_linlin(x: jnp.ndarray, xv: jnp.ndarray, yv: jnp.ndarray) -> jnp.ndarray:
    """Batched linear interpolation with edge clamping."""
    if xv.shape[0] > _DENSE_MAX:
        return jnp.interp(x, xv, yv)
    i = jnp.clip(searchsorted_right(xv, x) - 1, 0, xv.shape[0] - 2)
    x0 = take_small(xv, i)
    x1 = take_small(xv, i + 1)
    y0 = take_small(yv, i)
    y1 = take_small(yv, i + 1)
    t = jnp.clip((x - x0) / jnp.maximum(x1 - x0, jnp.finfo(x0.dtype).tiny),
                 0.0, 1.0)
    return y0 + t * (y1 - y0)


def interp_loglog(x: jnp.ndarray, xv: jnp.ndarray, yv: jnp.ndarray) -> jnp.ndarray:
    """Batched log-log interpolation (power-law between points), clamped.

    Used for dust optical properties vs wavelength, matching the reference's
    resource-table interpolation convention (ref: StoredTable log axes).
    """
    lx = jnp.log(x)
    lxv = jnp.log(xv)
    lyv = jnp.log(jnp.maximum(yv, jnp.finfo(yv.dtype).tiny))
    out = jnp.exp(interp_linlin(lx, lxv, lyv))
    # values interpolated from the tiny-clamped floor represent exact zeros
    return jnp.where(out < 1e-35, 0.0, out)


def sample_cdf_linlin(u: jnp.ndarray, xv: jnp.ndarray, cdf: jnp.ndarray) -> jnp.ndarray:
    """Invert a tabulated cdf with linear interpolation within bins.

    u in (0,1), xv (N,), cdf (N,) normalized increasing. Batched over u.
    (ref: Random::cdfLinLin, SKIRT/core/Random.hpp:160.)
    """
    i = jnp.clip(searchsorted_right(cdf, u) - 1, 0, xv.shape[0] - 2)
    c0 = take_small(cdf, i)
    c1 = take_small(cdf, i + 1)
    frac = jnp.where(c1 > c0, (u - c0) / jnp.maximum(c1 - c0, 1e-30), 0.0)
    x0 = take_small(xv, i)
    return x0 + frac * (take_small(xv, i + 1) - x0)


def sample_cdf_loglog(u: jnp.ndarray, xv: jnp.ndarray, cdf: jnp.ndarray) -> jnp.ndarray:
    """Invert a tabulated cdf with log-x interpolation within bins
    (ref: Random::cdfLogLog). Good for wide wavelength ranges."""
    i = jnp.clip(searchsorted_right(cdf, u) - 1, 0, xv.shape[0] - 2)
    c0 = take_small(cdf, i)
    c1 = take_small(cdf, i + 1)
    frac = jnp.where(c1 > c0, (u - c0) / jnp.maximum(c1 - c0, 1e-30), 0.0)
    lx0 = jnp.log(take_small(xv, i))
    lx1 = jnp.log(take_small(xv, i + 1))
    return jnp.exp(lx0 + frac * (lx1 - lx0))


def locate_clip(xv: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Index i such that xv[i] <= x < xv[i+1], clipped to [0, N-2]
    (ref: NR::locateClip)."""
    return jnp.clip(searchsorted_right(xv, x) - 1, 0, xv.shape[0] - 2)
