"""Multi-device packet data-parallelism on the virtual 8-CPU mesh.

Validates the psum-reduced sharded segment (the device-mesh equivalent of the
reference's threads+MPI scaling, SURVEY.md §2.2) and that sharded results
equal the single-device run exactly — counter-based RNG makes the physics
independent of the device decomposition, a property the reference's
per-thread RNG cannot offer (ref: Random.hpp:34).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from skirt9_tpu.grids.cartesian import make_cartesian
from skirt9_tpu.instruments import distant as dinst
from skirt9_tpu.media import system as msys
from skirt9_tpu.parallel import dp
from skirt9_tpu.sources.base import PointSource
from skirt9_tpu.transport import lifecycle as lc

PC = 3.0857e16


def problem():
    grid = make_cartesian(((-PC, PC),) * 3, (8,) * 3)
    sigma = 1e-24
    nd = msys.uniform_density_sphere(grid, 1.0, sigma, 0.8 * PC)
    med = msys.make_medium(grid, nd, np.array([0.4e-6, 0.7e-6]),
                           np.array([[sigma, sigma]]),
                           np.full((1, 2), 0.5), np.full((1, 2), 0.3))
    inst = dinst.DistantInstrumentCfg(name="i", wave_borders=(0.5e-6, 0.6e-6),
                                      distance=100 * PC)
    opts = lc.TransportOptions(max_steps=grid.max_steps(), max_events=8)
    src_ = PointSource(luminosity=1.0, lam0=0.55e-6)
    return grid, med, inst, opts, src_


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_sharded_segment_matches_single_device():
    grid, med, inst, opts, src_ = problem()
    tabs = [dinst.device_tables(inst)]
    rfb = jnp.asarray([0.5e-6, 0.6e-6], jnp.float32)
    n = 2048

    # single device reference
    from skirt9_tpu.sources import base as src
    pkt = src.launch_batch(src_, src_.tables(), grid, jax.random.PRNGKey(0),
                           jnp.arange(n, dtype=jnp.int32), n)
    rf1 = jnp.zeros((grid.ncells, 1), jnp.float32)
    accs1 = [dinst.init_accumulators(inst)]
    rf1, accs1 = lc.life_cycle(grid, med, opts, (inst,), tabs, rfb,
                               pkt, rf1, accs1)

    # 8-device sharded
    mesh = dp.make_mesh(jax.devices()[:8])
    run = dp.sharded_segment(mesh, grid, med, opts, (inst,), tabs, rfb,
                             src_, src_.tables(), n)
    rf8, accs8 = dp.init_accumulators(mesh, grid, [inst], [0.5e-6, 0.6e-6])
    rf8, accs8 = run(jax.random.PRNGKey(0),
                     jnp.arange(n, dtype=jnp.int32), rf8, accs8)

    # identical draws per history index; only f32 reduction order differs
    np.testing.assert_allclose(np.asarray(accs8[0]["sed"]),
                               np.asarray(accs1[0]["sed"]), rtol=2e-4)
    np.testing.assert_allclose(np.asarray(rf8).sum(),
                               np.asarray(rf1).sum(), rtol=2e-4)
