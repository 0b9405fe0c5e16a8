"""Packet data-parallelism over a device mesh.

Batched replacement for the reference's whole parallelism stack
(ref: SKIRT/core/Parallel.hpp:44 `call(maxIndex, target)`,
MultiHybridParallel.hpp:24 master-worker chunk serving over MPI,
ProcessManager.cpp:206 `sumToAll` radiation-field allreduce):

  * photon-history indices are sharded statically and equally over the mesh
    ("pp" axis) — MC work per packet is statistically uniform, so the
    reference's dynamic chunk-serving protocol is unnecessary;
  * the spatial grid, medium state, and optical-property tables are
    replicated per device (exactly the reference's memory model — every
    rank holds the full grid);
  * radiation-field and instrument accumulators are reduced with `psum`
    across the devices at the end of each segment (== the reference's per-segment
    MPI_Allreduce, MonteCarloSimulation.cpp:133).

Spatial domain decomposition (sharding the *grid* with alltoall packet
migration — the capability SKIRT9 lacks, SkirtCommandLineHandler.cpp:329)
is a separate, later module.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..instruments import distant as dinst
from ..sources import base as src
from ..transport import lifecycle as lc

PP_AXIS = "pp"


def make_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (PP_AXIS,))


def sharded_segment(mesh: Mesh, grid, med, opts: lc.TransportOptions,
                    inst_cfgs, inst_tabs, rf_borders, source, source_tabs,
                    n_total: int):
    """Build a jitted, shard_mapped segment runner.

    Returns run(seed_key, history, rf, accs) where history is a (B,) global
    batch of history indices sharded over the mesh, rf/accs are replicated
    accumulators; the function returns psum-reduced (rf, accs).
    """

    def per_device(seed_key, history, rf, accs):
        pkt = src.launch_batch(source, source_tabs, grid, seed_key,
                               history, n_total)
        rf, accs = lc.life_cycle(grid, med, opts, inst_cfgs, inst_tabs,
                                 rf_borders, pkt, rf, accs)
        # segment-end reduction (== communicateRadiationField + instrument
        # sumToRoot in the reference)
        if rf is not None:
            rf = jax.lax.psum(rf, PP_AXIS)
        accs = jax.lax.psum(accs, PP_AXIS)
        return rf, accs

    shard = jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(), P(PP_AXIS), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(shard)


def init_accumulators(mesh: Mesh, grid, instruments, rf_borders):
    """Replicated accumulator arrays."""
    rf = (jnp.zeros((grid.ncells, len(rf_borders) - 1), jnp.float32)
          if rf_borders is not None else None)
    accs = [dinst.init_accumulators(c) for c in instruments]
    return rf, accs
