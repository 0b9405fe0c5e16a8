"""Octree grid: build, locate, traversal consistency with Cartesian."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from skirt9_tpu.grids.octree import build_octree, load_topology, save_topology
from skirt9_tpu.geometries.analytic import PlummerGeometry


def make_tree(max_level=4):
    geom = PlummerGeometry(b=0.3)
    return build_octree(((-2, 2), (-2, 2), (-2, 2)), geom.density_np,
                        max_level=max_level, min_level=2,
                        max_fraction=5e-3, samples=32), geom


def test_octree_structure():
    tree, _ = make_tree()
    assert tree.ncells > 64          # refined beyond min level
    lo, hi = np.asarray(tree.cell_lo), np.asarray(tree.cell_hi)
    assert (hi > lo).all()
    # leaf volumes tile the root box exactly
    vols = np.prod(hi - lo, axis=-1)
    assert vols.sum() == pytest.approx(4.0**3, rel=1e-6)


def test_octree_locate_centers():
    tree, _ = make_tree()
    centers = tree.cell_centers()
    ids = np.asarray(tree.locate(centers))
    np.testing.assert_array_equal(ids, np.arange(tree.ncells))
    # outside points
    out = jnp.asarray([[3.0, 0, 0], [0, -2.5, 0]])
    assert (np.asarray(tree.locate(out)) == -1).all()


def test_octree_traversal_chord():
    """Total path length through the tree equals the box chord length."""
    tree, _ = make_tree()
    rs = np.random.default_rng(2)
    B = 32
    pos = jnp.asarray(rs.uniform(-1.8, 1.8, (B, 3)).astype(np.float32))
    d = rs.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = jnp.asarray(d)
    c = tree.locate(pos)
    total = jnp.zeros(B)
    p = pos
    for _ in range(tree.max_steps()):
        ds, c2, p2 = tree.step(p, d, c)
        total = total + jnp.where(c >= 0, ds, 0.0)
        p, c = p2, c2
        if bool((np.asarray(c) == -1).all()):
            break
    assert (np.asarray(c) == -1).all()
    pos_n, d_n = np.asarray(pos, np.float64), np.asarray(d, np.float64)
    with np.errstate(divide="ignore"):
        t1 = (-2 - pos_n) / d_n
        t2 = (2 - pos_n) / d_n
    tmax = np.min(np.maximum(t1, t2), axis=-1)
    np.testing.assert_allclose(np.asarray(total), tmax, rtol=3e-3)


def test_octree_topology_roundtrip(tmp_path):
    tree, _ = make_tree(max_level=3)
    p = str(tmp_path / "topo.npz")
    save_topology(tree, p)
    tree2 = load_topology(p)
    assert tree2.ncells == tree.ncells
    np.testing.assert_array_equal(np.asarray(tree.node_child),
                                  np.asarray(tree2.node_child))


def test_octree_transport_matches_cartesian():
    """The same uniform-sphere problem on octree vs Cartesian gives the same
    SED within MC noise."""
    from skirt9_tpu.grids.cartesian import make_cartesian
    from skirt9_tpu.instruments import distant as dinst
    from skirt9_tpu.media import system as msys
    from skirt9_tpu.simulation import Simulation
    from skirt9_tpu.sources.base import PointSource
    from skirt9_tpu.transport import lifecycle as lc

    PC = 3.0857e16
    R, box = PC, 1.2 * PC
    sigma = 1e-24

    def run(grid):
        centers = np.asarray(grid.cell_centers())
        r = np.linalg.norm(centers, axis=-1)
        nd = np.where(r <= R, 1.0 / (sigma * R), 0.0).astype(np.float32)
        med = msys.make_medium(grid, nd, np.array([0.4e-6, 0.7e-6]),
                               np.array([[sigma, sigma]]),
                               np.full((1, 2), 0.4), np.full((1, 2), 0.3))
        inst = dinst.DistantInstrumentCfg(name="i", wave_borders=(0.5e-6, 0.6e-6),
                                          distance=100 * PC)
        opts = lc.TransportOptions(max_steps=min(grid.max_steps(), 64),
                                   max_events=12)
        sim = Simulation(grid=grid, medium=med,
                         sources=[PointSource(luminosity=1.0, lam0=0.55e-6)],
                         instruments=[inst], options=opts, rf_borders=None,
                         num_packets=8192, batch_size=4096, seed=3)
        _, accs = sim.run_primary(verbose=False)
        return dinst.calibrate_sed(inst, jax.device_get(accs[0]))

    cart = run(make_cartesian(((-box, box),) * 3, (16,) * 3))
    tree = build_octree(((-box, box),) * 3,
                        lambda p: (np.linalg.norm(p, axis=-1) <= R) * 1.0,
                        max_level=4, min_level=4)  # uniform depth-4 = 16^3
    octo = run(tree)
    assert octo["total"][0] == pytest.approx(cart["total"][0], rel=0.05)
    assert octo["primarydirect"][0] == pytest.approx(cart["primarydirect"][0],
                                                     rel=0.02)


def test_bintree_build_and_march():
    """BinTree grid: alternate-axis splits, locate consistent with the
    leaf boxes, and the scan march exact across anisotropic leaves
    (ref: BinTreeNode.hpp; PolicyTreeSpatialGrid treeType=BinTree)."""
    from skirt9_tpu.grids.bintree import build_bintree
    from skirt9_tpu.media import system as msys
    from skirt9_tpu.transport import lifecycle as lc

    R = 1.0

    def dens(p):
        r = np.linalg.norm(p, axis=-1)
        return np.where(r < R, 1.0, 0.0)

    grid = build_bintree(((-1.2, 1.2),) * 3, dens, max_level=12,
                         min_level=3, max_fraction=3e-2)
    assert grid.ncells > 8
    # anisotropic leaves exist (bintree signature)
    d = np.asarray(grid.cell_hi) - np.asarray(grid.cell_lo)
    assert not np.allclose(d[:, 0], d[:, 1]) or \
        not np.allclose(d[:, 1], d[:, 2])
    # locate agrees with box membership
    rs = np.random.default_rng(0)
    pts = rs.uniform(-1.1, 1.1, (256, 3)).astype(np.float32)
    c = np.asarray(grid.locate(jnp.asarray(pts)))
    lo = np.asarray(grid.cell_lo)[np.maximum(c, 0)]
    hi = np.asarray(grid.cell_hi)[np.maximum(c, 0)]
    ok = c >= 0
    assert ok.all()
    assert (pts[ok] >= lo[ok] - 1e-5).all() and (pts[ok] <= hi[ok] + 1e-5).all()

    # the scan march through unit density accumulates exactly the path
    # length to the box boundary across the anisotropic leaves
    med = msys.make_medium(grid, np.ones(grid.ncells, np.float32),
                           np.array([0.4e-6, 0.7e-6]),
                           sigma_ext=np.full((1, 2), 1.0),
                           albedo=np.full((1, 2), 0.5),
                           g=np.zeros((1, 2)))
    B = 256
    pos = rs.uniform(-0.8, 0.8, (B, 3))
    dirn = rs.normal(size=(B, 3))
    dirn /= np.linalg.norm(dirn, axis=-1, keepdims=True)
    t_exit = np.min(np.where(dirn > 0, (1.2 - pos) / dirn,
                             (-1.2 - pos) / dirn), axis=-1)
    pos_j = jnp.asarray(pos, jnp.float32)
    opt = msys.optics_at(med, jnp.full((B,), 0.55e-6))
    cell = grid.locate(pos_j)
    tau = lc.trace_tau(grid, med, opt, pos_j,
                       jnp.asarray(dirn, jnp.float32), cell,
                       grid.max_steps(), cell >= 0)
    np.testing.assert_allclose(np.asarray(tau), t_exit, rtol=1e-4)


def test_site_list_policy():
    from skirt9_tpu.grids.octree import build_octree, site_list_refine_fn

    rs = np.random.default_rng(5)
    sites = rs.uniform(-0.9, 0.9, (40, 3))
    grid = build_octree(((-1.0, 1.0),) * 3, None, max_level=6, min_level=1,
                        refine_fn=site_list_refine_fn(sites))
    # every leaf holds at most one site (up to the level cap)
    lo = np.asarray(grid.cell_lo)
    hi = np.asarray(grid.cell_hi)
    counts = np.array([np.sum(np.all((sites >= lo[i]) & (sites < hi[i]),
                                     axis=-1)) for i in range(grid.ncells)])
    deep = (hi - lo)[:, 0] > 2.0 / 64 * 1.001  # above the level cap
    assert (counts[deep] <= 1).all()
