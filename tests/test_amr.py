"""Adaptive-mesh (AMR) grid: parse, locate, traversal, transport parity.

(ref: AdaptiveMeshSnapshot.hpp:121 Morton-order '!' tree format;
AdaptiveMeshSpatialGrid path machinery)
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from skirt9_tpu.grids.amr import build_amr


def write_amr(tmp_path, text, name="mesh.amr"):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


TWO_LEVEL = ("# simple 2-level mesh\n! 2 2 2\n! 2 2 2\n"
             + "".join(f"{v}\n" for v in range(1, 16)))


def test_parse_and_topology(tmp_path):
    path = write_amr(tmp_path, TWO_LEVEL)
    g, vals = build_amr(path, ((-1, 1), (-1, 1), (-1, 1)))
    # 8 leaves in the refined first octant + 7 top-level leaves
    assert g.ncells == 15
    assert vals.shape[0] == 15
    assert g.volumes().sum() == pytest.approx(8.0, rel=1e-6)
    # first 8 leaves are the refined (-1..0)^3 octant -> volume (1/2)^3
    np.testing.assert_allclose(g.volumes()[:8], 0.125)
    np.testing.assert_allclose(g.volumes()[8:], 1.0)


def test_locate_matches_boxes(tmp_path):
    path = write_amr(tmp_path, TWO_LEVEL)
    g, _ = build_amr(path, ((-1, 1), (-1, 1), (-1, 1)))
    lo = np.asarray(g.cell_lo, np.float64)
    hi = np.asarray(g.cell_hi, np.float64)
    rs = np.random.default_rng(0)
    pos = rs.uniform(-0.99, 0.99, (512, 3)).astype(np.float32)
    got = np.asarray(g.locate(jnp.asarray(pos)))
    assert (got >= 0).all()
    inside = (pos >= lo[got]).all(axis=1) & (pos <= hi[got]).all(axis=1)
    assert inside.mean() > 0.999
    out = np.asarray(g.locate(jnp.asarray([[1.5, 0.0, 0.0]], jnp.float32)))
    assert out[0] == -1


def deep_mesh_text(rs):
    """Random 3-level mesh: 3x3x3 root, random children refined 2x2x2,
    random grandchildren refined 2x1x2."""
    lines = ["! 3 3 3"]
    for _ in range(27):
        if rs.random() < 0.4:
            lines.append("! 2 2 2")
            for _ in range(8):
                if rs.random() < 0.3:
                    lines.append("! 2 1 2")
                    lines.extend("0.5" for _ in range(4))
                else:
                    lines.append("0.5")
        else:
            lines.append("0.5")
    return "\n".join(lines) + "\n"


def test_traversal_accumulates_chord(tmp_path):
    rs = np.random.default_rng(5)
    path = write_amr(tmp_path, deep_mesh_text(rs))
    g, _ = build_amr(path, ((-1, 1), (-1, 1), (-1, 1)))
    assert g.volumes().sum() == pytest.approx(8.0, rel=1e-6)

    B = 128
    pos = rs.uniform(-0.9, 0.9, (B, 3)).astype(np.float32)
    d = rs.normal(size=(B, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = d.astype(np.float32)

    p = jnp.asarray(pos)
    dirn = jnp.asarray(d)
    cell = g.locate(p)
    total = jnp.zeros(B)
    ok_mid = []
    for _ in range(g.max_steps()):
        ds, nxt, p2 = g.step(p, dirn, cell)
        mid = p + 0.5 * ds[:, None] * dirn
        mid_cell = g.locate(mid)
        ok_mid.append(np.asarray((mid_cell == cell) | (cell < 0) | (ds == 0)))
        total = total + jnp.where(cell >= 0, ds, 0.0)
        p, cell = p2, nxt
    assert np.mean(ok_mid) > 0.99

    pos_n, d_n = pos.astype(np.float64), d.astype(np.float64)
    with np.errstate(divide="ignore"):
        t1 = (-1 - pos_n) / d_n
        t2 = (1 - pos_n) / d_n
    tmax = np.min(np.maximum(t1, t2), axis=-1)
    np.testing.assert_allclose(np.asarray(total), tmax, rtol=5e-3)


def test_move_inside(tmp_path):
    path = write_amr(tmp_path, TWO_LEVEL)
    g, _ = build_amr(path, ((-1, 1), (-1, 1), (-1, 1)))
    pos = jnp.asarray([[-3.0, 0.1, 0.1], [0.2, 0.2, 0.2], [3.0, 0.0, 0.0]],
                      jnp.float32)
    dirn = jnp.asarray([[1.0, 0, 0], [0, 0, 1.0], [1.0, 0, 0]], jnp.float32)
    newpos, cell, t = g.move_inside(pos, dirn)
    c = np.asarray(cell)
    assert c[0] >= 0 and c[1] >= 0 and c[2] == -1
    assert float(t[1]) == 0.0
    assert float(newpos[0, 0]) == pytest.approx(-1.0, abs=1e-4)


def test_transport_on_amr_matches_cartesian(tmp_path):
    """Uniform-sphere benchmark on an AMR grid agrees with Cartesian."""
    from skirt9_tpu.grids.cartesian import make_cartesian
    from skirt9_tpu.instruments import distant as dinst
    from skirt9_tpu.media import system as msys
    from skirt9_tpu.simulation import Simulation
    from skirt9_tpu.sources.base import PointSource
    from skirt9_tpu.transport import lifecycle as lc

    rs = np.random.default_rng(11)
    path = write_amr(tmp_path, deep_mesh_text(rs))

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
    amr, _ = build_amr(path, ((-box, box),) * 3)
    ag = run(amr, amr.max_steps())
    for k in ("transparent", "primarydirect", "primaryscattered"):
        assert ag[k][0] == pytest.approx(cart[k][0], rel=0.08), k


def test_ski_adaptive_mesh_medium(tmp_path):
    """AdaptiveMeshMedium + AdaptiveMeshSpatialGrid through the importer
    (ref: AdaptiveMeshMedium.hpp:65, AdaptiveMeshSpatialGrid.hpp:24)."""
    rs = np.random.default_rng(2)
    mesh = deep_mesh_text(rs)
    (tmp_path / "gas.amr").write_text(mesh)
    ski = """<?xml version="1.0"?>
<skirt-simulation-hierarchy type="MonteCarloSimulation" format="9">
 <MonteCarloSimulation userLevel="Regular" simulationMode="ExtinctionOnly"
     numPackets="1000">
  <random type="Random"><Random seed="0"/></random>
  <units type="Units"><ExtragalacticUnits/></units>
  <sourceSystem type="SourceSystem">
   <SourceSystem minWavelength="0.4 micron" maxWavelength="0.7 micron"
       wavelengths="0.55 micron" sourceBias="0.5">
    <sources type="Source">
     <PointSource positionX="0 m" positionY="0 m" positionZ="0 m">
      <sed type="SED"><BlackBodySED temperature="5000 K"/></sed>
      <normalization type="LuminosityNormalization">
       <IntegratedLuminosityNormalization wavelengthRange="Source"
           integratedLuminosity="1 Lsun"/>
      </normalization>
     </PointSource>
    </sources>
   </SourceSystem>
  </sourceSystem>
  <mediumSystem type="MediumSystem">
   <MediumSystem>
    <media type="Medium">
     <AdaptiveMeshMedium filename="gas.amr" minX="-1 pc" maxX="1 pc"
         minY="-1 pc" maxY="1 pc" minZ="-1 pc" maxZ="1 pc"
         massType="MassDensity" massFraction="1"
         importVelocity="false">
      <materialMix type="MaterialMix">
       <MeanInterstellarDustMix/>
      </materialMix>
     </AdaptiveMeshMedium>
    </media>
    <grid type="SpatialGrid">
     <AdaptiveMeshSpatialGrid/>
    </grid>
   </MediumSystem>
  </mediumSystem>
  <instrumentSystem type="InstrumentSystem">
   <InstrumentSystem>
    <instruments type="Instrument">
     <SEDInstrument instrumentName="i0" distance="10 Mpc" inclination="0 deg"
         azimuth="0 deg" roll="0 deg" recordComponents="true"
         numScatteringLevels="0" recordPolarization="false"
         recordStatistics="false">
      <wavelengthGrid type="WavelengthGrid">
       <LogWavelengthGrid minWavelength="0.45 micron"
           maxWavelength="0.65 micron" numWavelengths="2"/>
      </wavelengthGrid>
     </SEDInstrument>
    </instruments>
   </InstrumentSystem>
  </instrumentSystem>
  <probeSystem type="ProbeSystem"><ProbeSystem/></probeSystem>
 </MonteCarloSimulation>
</skirt-simulation-hierarchy>
"""
    p = tmp_path / "amr.ski"
    p.write_text(ski)
    from skirt9_tpu.config.ski import load_ski
    sim = load_ski(str(p), num_packets=4096, batch_size=2048)
    from skirt9_tpu.grids.amr import AMRGrid
    assert isinstance(sim.grid, AMRGrid)
    assert sim.grid.ncells > 27
    nd = np.asarray(sim.medium.nd)
    assert (nd > 0).all()
    # density: 0.5 Msun/pc3 / mu
    MSUN, PC = 1.98892e30, 3.0857e16
    mu = sim.medium_mixes[0].mu if hasattr(sim, "medium_mixes") else None
    _, accs = sim.run_primary(verbose=False)
    import jax
    from skirt9_tpu.instruments import distant as dinst
    sed = dinst.calibrate_sed(sim.instruments[0], jax.device_get(accs[0]))
    assert np.all(np.asarray(sed["total"]) > 0)


def test_amr_scan_march_tau_matches_box_exit(tmp_path):
    """The scan march through an AMR grid of unit density accumulates
    exactly sigma * (distance to the box boundary), across the refined
    and unrefined leaves alike (ref: AdaptiveMeshSpatialGrid path
    machinery)."""
    from skirt9_tpu.media import system as msys
    from skirt9_tpu.transport import lifecycle as lc

    rs = np.random.default_rng(1)
    path = write_amr(tmp_path, deep_mesh_text(rs))
    g, _ = build_amr(path, ((-1, 1), (-1, 1), (-1, 1)))
    med = msys.make_medium(g, np.ones(g.ncells, np.float32),
                           np.array([0.4e-6, 0.7e-6]),
                           sigma_ext=np.full((1, 2), 1.0),
                           albedo=np.full((1, 2), 0.5),
                           g=np.zeros((1, 2)))
    B = 256
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
