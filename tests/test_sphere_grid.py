"""1D spherical grid: exact traversal and benchmark-grade transport."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from skirt9_tpu.grids.sphere import make_sphere1d

PC = 3.0857e16


def test_locate_and_volumes():
    g = make_sphere1d(1.0, 10)
    pos = jnp.asarray([[0.05, 0, 0], [0, 0.55, 0], [0, 0, 1.5]])
    cells = np.asarray(g.locate(pos))
    assert cells[0] == 0 and cells[1] == 5 and cells[2] == -1
    assert g.volumes().sum() == pytest.approx(4 / 3 * np.pi, rel=1e-6)


def test_traversal_chord():
    g = make_sphere1d(1.0, 13)
    rs = np.random.default_rng(3)
    B = 128
    pos = rs.normal(size=(B, 3))
    pos = 0.8 * pos / np.linalg.norm(pos, axis=-1, keepdims=True) \
        * rs.uniform(0.05, 1.0, (B, 1))
    d = rs.normal(size=(B, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pos = jnp.asarray(pos, jnp.float32)
    d = jnp.asarray(d, jnp.float32)
    c = g.locate(pos)
    total = jnp.zeros(B)
    p = pos
    for _ in range(g.max_steps()):
        ds, c2, p2 = g.step(p, d, c)
        total = total + jnp.where(c >= 0, ds, 0.0)
        p, c = p2, c2
    assert (np.asarray(c) == -1).all()
    # chord to the outer sphere
    pn, dn = np.asarray(pos, np.float64), np.asarray(d, np.float64)
    b = np.sum(pn * dn, axis=-1)
    disc = 1.0 - (np.sum(pn * pn, -1) - b**2)
    t = -b + np.sqrt(disc)
    np.testing.assert_allclose(np.asarray(total), t, rtol=1e-4, atol=1e-5)


def test_ivezic_benchmark_shell_on_sphere_grid():
    """The Ivezic 1997 setup (central source, r^-1.5 shell, tau_V=1) on the
    natural 1D grid: exact attenuation against the analytically integrated
    discretized optical depth."""
    from skirt9_tpu.geometries.analytic import ShellGeometry
    from skirt9_tpu.instruments import distant as dinst
    from skirt9_tpu.media import geometric as gm, mixes as mx
    from skirt9_tpu.simulation import Simulation
    from skirt9_tpu.sources.base import PointSource
    from skirt9_tpu.transport import lifecycle as lc

    rin, rout = 0.1 * PC, 1.0 * PC
    grid = make_sphere1d(1.05 * rout, 60)
    geom = ShellGeometry(rmin=rin, rmax=rout, p=1.5)
    mix = mx.mean_ivezic_benchmark()
    norm = gm.OpticalDepthNormalization(tau=1.0, lam=0.55e-6, axis="z")
    med = gm.build_medium(grid, [(geom, mix, norm)], samples=1)
    inst = dinst.DistantInstrumentCfg(name="i", wave_borders=(0.5e-6, 0.6e-6),
                                      distance=1000 * PC)
    opts = lc.TransportOptions(max_steps=grid.max_steps(), max_events=4)
    sim = Simulation(grid=grid, medium=med,
                     sources=[PointSource(luminosity=1.0, lam0=0.55e-6)],
                     instruments=[inst], options=opts,
                     rf_borders=np.array([0.5e-6, 0.6e-6]),
                     num_packets=4096, batch_size=4096, seed=1)
    rf, accs = sim.run_primary(verbose=False)
    sed = dinst.calibrate_sed(inst, jax.device_get(accs[0]))
    att = sed["primarydirect"][0] / sed["transparent"][0]
    # discretized one-sided tau (full-axis normalization tau=1 -> 0.5)
    nd = np.asarray(med.nd, np.float64)[:, 0]
    sig, _, _ = mix.at(0.55e-6)
    rbn = np.asarray(grid.rb, np.float64)
    tau_d = float(np.sum(nd * sig * np.diff(rbn)))
    assert tau_d == pytest.approx(0.5, rel=0.1)
    assert att == pytest.approx(np.exp(-tau_d), rel=5e-3)
    # radiation field concentrates in inner shells (r^-1.5 profile + 1/r^2)
    rfn = np.asarray(rf, np.float64)[:, 0]
    inner = rfn[nd > 0][:5].sum()
    outer = rfn[nd > 0][-5:].sum()
    assert inner > outer


def test_cli_emulate(tmp_path):
    import subprocess
    import sys
    ski = tmp_path / "m.ski"
    import textwrap
    sys.path.insert(0, "/root/repo/tests")
    from test_ski import SKI
    ski.write_text(SKI)
    r = subprocess.run(
        [sys.executable, "-m", "skirt9_tpu", str(ski), "-e",
         "-o", str(tmp_path)],
        capture_output=True, text=True, cwd="/root/repo",
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-500:]
    assert "emulation: setup OK" in r.stdout
