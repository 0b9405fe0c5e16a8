"""Counter-based random streams for photon-packet Monte Carlo.

The reference uses per-thread Mersenne twisters, reproducible only in serial
runs (ref: SKIRT/core/Random.hpp:34-57, Random.cpp:24-43). Here every random
draw is a pure function of (seed, history index, event counter, purpose tag)
via threefry key folding, so every packet history is identical under ANY
device/batch decomposition — strictly stronger determinism than the
reference. Sums over histories are equal up to f32 summation order (GPU
scatter-adds run as atomics in no fixed order).

Samplers mirror the reference's Random API (uniform / gauss / expon /
exponCutoff / direction / cdf inversion; ref: SKIRT/core/Random.hpp:57-188)
but operate on whole packet batches.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# purpose tags (compile-time ints folded into keys so that different draw
# sites within one event never share a stream)
LAUNCH_WAVELENGTH = 1
LAUNCH_POSITION = 2
LAUNCH_DIRECTION = 3
PATH_TAU = 4
SCATTER_ANGLE = 5
SCATTER_COMPONENT = 6
ROULETTE = 7
LAUNCH_SOURCE = 8
SCATTER_AZIMUTH = 9
LAUNCH_CELL = 10
EMISSION_LAMBDA = 11
LAUNCH_TIME = 12
LAUNCH_FAMILY_CORNER = 13

# event-counter value reserved for launch-time draws (scattering events use
# 0..max_events-1, so any large constant is collision-free)
LAUNCH_EVENT = 1_000_003


def history_keys(seed_key: jax.Array, history: jax.Array) -> jax.Array:
    """Per-packet base keys from a run key and history indices (B,)."""
    return jax.vmap(lambda h: jax.random.fold_in(seed_key, h))(history)


def event_keys(hkeys: jax.Array, event: jax.Array | int) -> jax.Array:
    """Fold the scattering-event counter into per-packet keys.

    `event` may be a scalar (all lanes at the same event) or a per-lane
    (B,) array (mixed-age batches under lane refill — a lane's nscat equals
    its event count while alive, so refilled batches draw the exact same
    streams as unrefilled ones)."""
    ev = jnp.broadcast_to(jnp.asarray(event), (hkeys.shape[0],))
    return jax.vmap(lambda k, e: jax.random.fold_in(k, e))(hkeys, ev)


def purpose_key(keys: jax.Array, tag: int) -> jax.Array:
    return jax.vmap(lambda k: jax.random.fold_in(k, tag))(keys)


def uniform(keys: jax.Array, tag: int) -> jax.Array:
    """Uniform (0,1) per packet; excludes exact 0 like the reference's
    zero-rejecting uniform (ref: Random.cpp uniform loop)."""
    u = jax.vmap(lambda k: jax.random.uniform(k, ()))(purpose_key(keys, tag))
    return jnp.maximum(u, jnp.finfo(u.dtype).tiny)


def uniform2(keys: jax.Array, tag: int) -> tuple[jax.Array, jax.Array]:
    """Two independent uniforms per packet."""
    pk = purpose_key(keys, tag)
    uv = jax.vmap(lambda k: jax.random.uniform(k, (2,)))(pk)
    uv = jnp.maximum(uv, jnp.finfo(uv.dtype).tiny)
    return uv[:, 0], uv[:, 1]


def gauss(keys: jax.Array, tag: int) -> jax.Array:
    return jax.vmap(lambda k: jax.random.normal(k, ()))(purpose_key(keys, tag))


def expon(keys: jax.Array, tag: int) -> jax.Array:
    """Exponential with unit scale: tau = -ln(1-u)."""
    return -jnp.log1p(-uniform(keys, tag))


def expon_cutoff(keys: jax.Array, tag: int, taumax: jax.Array) -> jax.Array:
    """Exponential conditioned on tau < taumax
    (ref: SKIRT/core/Random.cpp exponCutoff): inverse-cdf of
    p(t) = e^-t / (1-e^-taumax) on [0, taumax]."""
    u = uniform(keys, tag)
    # tau = -log(1 - u*(1-exp(-taumax))), stable via log1p/expm1
    return -jnp.log1p(u * jnp.expm1(-taumax))


def isotropic_direction(keys: jax.Array, tag: int) -> jax.Array:
    """Uniform directions on the unit sphere, (B,3)
    (ref: SKIRT/core/Random.cpp direction())."""
    u, v = uniform2(keys, tag)
    cost = 2.0 * u - 1.0
    sint = jnp.sqrt(jnp.maximum(0.0, 1.0 - cost * cost))
    phi = 2.0 * jnp.pi * v
    return jnp.stack([sint * jnp.cos(phi), sint * jnp.sin(phi), cost], axis=-1)
