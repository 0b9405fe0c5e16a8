"""Voronoi grid: build, locate, traversal, transport consistency."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from skirt9_tpu.grids.voronoi import build_voronoi, density_sites


def make_grid(n_sites=300, seed=4):
    rs = np.random.default_rng(seed)
    sites = rs.uniform(-1, 1, (n_sites, 3))
    return build_voronoi(sites, ((-1, 1), (-1, 1), (-1, 1)),
                         lookup_res=16, volume_samples=100_000)


def test_locate_matches_nearest_site():
    g = make_grid()
    rs = np.random.default_rng(0)
    pos = rs.uniform(-0.99, 0.99, (500, 3)).astype(np.float32)
    got = np.asarray(g.locate(jnp.asarray(pos)))
    from scipy.spatial import cKDTree
    kdt = cKDTree(np.asarray(g.sites, np.float64))
    _, want = kdt.query(pos)
    assert (got == want).mean() > 0.999  # f32 ties may flip rare boundary pts
    out = np.asarray(g.locate(jnp.asarray([[1.5, 0, 0]], jnp.float32)))
    assert out[0] == -1


def test_volumes_tile_box():
    g = make_grid()
    assert g.volumes().sum() == pytest.approx(8.0, rel=1e-6)
    assert (g.volumes() > 0).all()


def test_exact_volumes_match_mc():
    """Exact clipped-polyhedron volumes agree with a high-count MC estimate
    per cell (the MC estimate converges as 1/sqrt(count))."""
    g = make_grid(n_sites=100)
    vols = g.volumes()
    from scipy.spatial import cKDTree
    kdt = cKDTree(np.asarray(g.sites, np.float64))
    rs = np.random.default_rng(7)
    nsamp = 2_000_000
    samp = rs.uniform(-1, 1, (nsamp, 3))
    _, which = kdt.query(samp)
    mc = np.bincount(which, minlength=100) / nsamp * 8.0
    # per-cell MC sigma ~ V/sqrt(count); allow 5 sigma
    count = np.maximum(np.bincount(which, minlength=100), 1)
    assert (np.abs(vols - mc) < 5 * mc / np.sqrt(count) + 1e-12).all()


def test_traversal_chord_and_consistency():
    """Stepping accumulates the chord length, and each step's midpoint lies
    in the cell the traversal claims (validates neighbor exits)."""
    g = make_grid()
    rs = np.random.default_rng(1)
    B = 64
    pos = jnp.asarray(rs.uniform(-0.9, 0.9, (B, 3)).astype(np.float32))
    d = rs.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = jnp.asarray(d)
    c = g.locate(pos)

    total = jnp.zeros(B)
    ok_mid = np.ones(B, bool)
    p = pos
    for _ in range(g.max_steps()):
        ds, c2, p2 = g.step(p, d, c)
        mid = p + 0.5 * ds[:, None] * d
        claimed = np.asarray(c)
        located = np.asarray(g.locate(mid))
        act = np.asarray(c) >= 0
        ok_mid &= ~act | (located == claimed) | (np.asarray(ds) <= 0)
        total = total + jnp.where(c >= 0, ds, 0.0)
        p, c = p2, c2
        if (np.asarray(c) == -1).all():
            break
    assert (np.asarray(c) == -1).all()
    assert ok_mid.mean() > 0.95  # f32 plane ties allow rare mismatches

    pos_n, d_n = np.asarray(pos, np.float64), np.asarray(d, np.float64)
    with np.errstate(divide="ignore"):
        t1 = (-1 - pos_n) / d_n
        t2 = (1 - pos_n) / d_n
    tmax = np.min(np.maximum(t1, t2), axis=-1)
    np.testing.assert_allclose(np.asarray(total), tmax, rtol=5e-3)


def test_density_sites():
    dens = lambda p: np.exp(-np.linalg.norm(p, axis=-1) ** 2 / 0.08)
    sites = density_sites(dens, ((-1, 1),) * 3, 200, seed=2)
    r = np.linalg.norm(sites, axis=-1)
    assert np.median(r) < 0.5  # concentrated toward the center


def test_transport_on_voronoi_matches_cartesian():
    """Uniform-sphere problem on a Voronoi grid agrees with Cartesian."""
    from skirt9_tpu.grids.cartesian import make_cartesian
    from skirt9_tpu.instruments import distant as dinst
    from skirt9_tpu.media import system as msys
    from skirt9_tpu.simulation import Simulation
    from skirt9_tpu.sources.base import PointSource
    from skirt9_tpu.transport import lifecycle as lc

    PC = 3.0857e16
    R, box = PC, 1.2 * PC
    sigma = 1e-24

    def run(grid, max_steps):
        centers = np.asarray(grid.cell_centers(), np.float64)
        r = np.linalg.norm(centers, axis=-1)
        nd = np.where(r <= R, 1.0 / (sigma * R), 0.0).astype(np.float32)
        med = msys.make_medium(grid, nd, np.array([0.4e-6, 0.7e-6]),
                               np.array([[sigma, sigma]]),
                               np.full((1, 2), 0.4), np.full((1, 2), 0.3))
        inst = dinst.DistantInstrumentCfg(name="i",
                                          wave_borders=(0.5e-6, 0.6e-6),
                                          distance=100 * PC)
        opts = lc.TransportOptions(max_steps=max_steps, max_events=12)
        sim = Simulation(grid=grid, medium=med,
                         sources=[PointSource(luminosity=1.0, lam0=0.55e-6)],
                         instruments=[inst], options=opts, rf_borders=None,
                         num_packets=8192, batch_size=4096, seed=3)
        _, accs = sim.run_primary(verbose=False)
        return dinst.calibrate_sed(inst, jax.device_get(accs[0]))

    cart = run(make_cartesian(((-box, box),) * 3, (16,) * 3), 51)
    rs = np.random.default_rng(8)
    sites = rs.uniform(-box, box, (2000, 3))
    vor = build_voronoi(sites, ((-box, box),) * 3, lookup_res=16,
                        volume_samples=50_000)
    voro = run(vor, vor.max_steps())
    # different discretizations of the same sphere: agree to several %
    assert voro["total"][0] == pytest.approx(cart["total"][0], rel=0.08)


def test_scan_march_tau_matches_box_exit():
    """The scan march through a Voronoi grid of unit density accumulates
    exactly sigma * (distance to the box boundary): the exact cell walk
    loses no path length at the cell walls."""
    from skirt9_tpu.media import system as msys
    from skirt9_tpu.transport import lifecycle as lc

    g = make_grid()
    med = msys.make_medium(g, np.ones(g.ncells, np.float32),
                           np.array([0.4e-6, 0.7e-6]),
                           sigma_ext=np.full((1, 2), 1.0),
                           albedo=np.full((1, 2), 0.5),
                           g=np.zeros((1, 2)))
    rs = np.random.default_rng(2)
    B = 128
    pos = rs.uniform(-0.9, 0.9, (B, 3))
    d = rs.normal(size=(B, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_exit = np.min(np.where(d > 0, (1.0 - pos) / d, (-1.0 - pos) / d),
                    axis=-1)
    pos_j = jnp.asarray(pos, jnp.float32)
    opt = msys.optics_at(med, jnp.full((B,), 0.55e-6))
    cell = g.locate(pos_j)
    tau = lc.trace_tau(g, med, opt, pos_j, jnp.asarray(d, jnp.float32),
                       cell, g.max_steps(), cell >= 0)
    np.testing.assert_allclose(np.asarray(tau), t_exit, rtol=1e-4)
