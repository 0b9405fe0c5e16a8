"""f32 numerics of the transport core (SURVEY §7 hard part 6).

The reference accumulates optical depth in f64 (SpatialGridPath.hpp:155);
the engine runs f32 throughout (f64 is slow or emulated on accelerators). These
tests bound the actual error sources:

  * long-path tau accumulation (256-step marches): f32 sequential summation
    error vs an f64 reduction of the same per-step dtau values, and vs the
    analytic optical depth;
  * interaction-point cdf inversion: the sampled tau at the located point
    reproduces tau_int;
  * the documented bound lives in BASELINE.md (numerics note).
"""

import jax
import jax.numpy as jnp
import numpy as np

from skirt9_tpu.grids.cartesian import make_cartesian
from skirt9_tpu.media import system as msys
from skirt9_tpu.transport import lifecycle as lc

PC = 3.0857e16


def _long_path_problem(n=86, tau_r=10.0):
    grid = make_cartesian(((-1.2 * PC, 1.2 * PC),) * 3, (n,) * 3)
    sigma = 1e-24
    nd = msys.uniform_density_sphere(grid, tau_r, sigma, PC)
    med = msys.make_medium(grid, nd, np.array([0.4e-6, 0.7e-6]),
                           sigma_ext=np.array([[sigma, sigma]]),
                           albedo=np.full((1, 2), 0.9),
                           g=np.full((1, 2), 0.5))
    return grid, med


def test_tau_accumulation_f32_error():
    """256+ step marches: f32 summation error on tau stays below 1e-5
    relative — far under MC noise (the reference's f64 advantage is moot)."""
    grid, med = _long_path_problem()
    B = 128
    # diagonal-ish rays through the center: the longest, highest-tau paths
    rs = np.random.RandomState(0)
    d = rs.normal(size=(B, 3)) * np.array([1.0, 0.3, 0.3]) + \
        np.array([1.0, 0.0, 0.0])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos = np.repeat(np.array([[-1.19 * PC, 0.0, 0.0]]), B, axis=0)
    pos += rs.uniform(-0.02, 0.02, size=(B, 3)) * PC
    posj = jnp.asarray(pos, jnp.float32)
    dj = jnp.asarray(d, jnp.float32)
    p0, c0, _ = grid.move_inside(posj, dj)
    mask = c0 >= 0
    S = grid.max_steps()
    assert S >= 256
    cells, ds = lc.march_geometry(grid, p0, dj, c0, S, mask)
    opt = msys.optics_at(med, jnp.full((B,), 0.55e-6, jnp.float32))
    dtau = lc.opacity_on_path(med, opt, cells, ds, dj)
    tau_f32 = np.asarray(jnp.sum(dtau, axis=0), np.float64)
    tau_f64 = np.asarray(dtau, np.float64).sum(axis=0)
    m = tau_f64 > 1.0
    rel = np.abs(tau_f32[m] - tau_f64[m]) / tau_f64[m]
    assert rel.max() < 1e-5, rel.max()

    # against the analytic chord optical depth (geometry discretization is
    # the dominant error, not f32): central ray tau ~ 2*tau_r
    j = np.argmax(np.abs(d[:, 0]))  # most x-aligned ray
    tau_c = tau_f64[j]
    # chord length through the sphere for this ray
    o, k = pos[j], d[j]
    b = np.dot(o, k)
    c = np.dot(o, o) - PC * PC
    disc = b * b - c
    chord = 2 * np.sqrt(max(disc, 0.0))
    tau_true = 10.0 * chord / PC  # kappa = tau_r / R
    # dominated by sphere voxelization (staircase boundary at 86^3 ~ 0.5%),
    # NOT by f32: the f32-vs-f64 sum above agrees to <1e-5
    assert abs(tau_c / tau_true - 1.0) < 1.5e-2, (tau_c, tau_true)


def test_interaction_point_inversion():
    """The located interaction point reproduces the sampled tau_int: the
    linear-in-tau in-step interpolation inverts the cumulative sum to f32
    precision even at tau ~ 20 (256-step paths)."""
    grid, med = _long_path_problem()
    B = 256
    rs = np.random.RandomState(1)
    d = rs.normal(size=(B, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos = rs.uniform(-0.3, 0.3, size=(B, 3)) * PC
    posj = jnp.asarray(pos, jnp.float32)
    dj = jnp.asarray(d, jnp.float32)
    c0 = grid.locate(posj)
    mask = c0 >= 0
    S = grid.max_steps()
    cells, ds = lc.march_geometry(grid, posj, dj, c0, S, mask)
    opt = msys.optics_at(med, jnp.full((B,), 0.55e-6, jnp.float32))
    dtau = lc.opacity_on_path(med, opt, cells, ds, dj)
    tau_before = jnp.cumsum(dtau, axis=0) - dtau
    tau_path = tau_before[-1] + dtau[-1]
    u = jnp.asarray(rs.uniform(0.02, 0.98, B), jnp.float32)
    tau_int = u * tau_path
    ipos, icell, found, idx, frac = lc.interaction_point(
        posj, dj, cells, ds, dtau, tau_before, tau_int, mask)
    # re-march from the start to the interaction point: accumulated tau
    # must equal tau_int
    s_int = jnp.linalg.norm(ipos - posj, axis=-1)
    s_before = jnp.cumsum(ds, axis=0) - ds
    # tau at the interaction = tau_before[idx] + frac*dtau[idx]
    take = lambda a: np.asarray(
        jnp.take_along_axis(a, idx[None, :], axis=0)[0], np.float64)
    tau_at = take(tau_before) + np.asarray(frac, np.float64) * take(dtau)
    ok = np.asarray(found)
    rel = np.abs(tau_at[ok] - np.asarray(tau_int, np.float64)[ok]) \
        / np.maximum(np.asarray(tau_int, np.float64)[ok], 1e-30)
    assert rel.max() < 2e-6, rel.max()
    # and the point lies inside the reported cell
    assert (np.asarray(grid.locate(ipos))[ok] == np.asarray(icell)[ok]).all()
