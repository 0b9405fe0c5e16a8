"""skirt9_tpu — a JAX Monte Carlo radiative-transfer framework.

A brand-new JAX/XLA implementation of the capabilities of SKIRT 9
(advanced radiative transfer in dusty astrophysical systems): photon-packet
Monte Carlo transport through spatial grids of dusty/gaseous media, with
forced scattering, peel-off imaging to synthetic instruments, radiation-field
accumulation, and self-consistent secondary (thermal dust) emission.

Design (not a port — see SURVEY.md):
  * the per-packet object life cycle of the reference
    (ref: SKIRT/core/MonteCarloSimulation.cpp:538 `performLifeCycle`)
    becomes a batched structure-of-arrays state machine: every phase is a
    `jax.lax.scan` over scattering events, with an inner bounded ray-march
    scan over grid cells, over a whole packet batch at once;
  * spatial grids are flattened to device-resident index tables (no pointer
    trees); traversal is branch-light vectorized stepping;
  * accumulation (radiation field, instruments) uses scatter-add on device
    plus `psum` across devices (replaces the reference's LockFree CAS loops
    and MPI allreduce, ref: SKIRT/utils/LockFree.hpp:24,
    SKIRT/mpi/ProcessManager.cpp:206);
  * RNG is counter-based (threefry) keyed on (seed, history index, event,
    purpose) — identical packet histories under any parallel decomposition,
    which the reference only guarantees serially (ref:
    SKIRT/core/Random.hpp:34); the sums over them are equal up to f32
    summation order, since GPU scatter-adds run as atomics in no fixed
    order.
"""

__version__ = "0.1.0"
