"""Failure detection: finiteness guards + diagnostic breadcrumbs.

Counterpart of the reference's FatalError / SignalHandler layer (ref:
SMILE/fundamentals/FatalError.hpp, SignalHandler.hpp:14 — segfaults become
stack-traced errors, exceptions log to console+file then abort). A
functional JAX engine cannot segfault, but device kernels can produce
non-finite accumulators (or the device can fault); these guards catch the
damage AT SEGMENT BOUNDARIES with a named breadcrumb instead of letting a
poisoned accumulator propagate silently into outputs (round-2 lesson: one
undiagnosed device fault erased the whole benchmark record).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


class EngineError(RuntimeError):
    """A transport-engine failure with a phase breadcrumb."""


def tree_finite_summary(tree) -> dict:
    """One device reduction per leaf: (finite?, sum). Cheap enough to run
    once per segment; the scalars pull in a single small transfer."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if not hasattr(leaf, "dtype") or not jnp.issubdtype(
                leaf.dtype, jnp.floating):
            continue
        name = jax.tree_util.keystr(path)
        out[name] = (bool(jnp.all(jnp.isfinite(leaf))),
                     float(jnp.sum(jnp.abs(leaf))))
    return out


def check_finite(tree, phase: str, logger=None):
    """Raise EngineError naming the phase and the offending accumulators
    when any floating leaf holds a non-finite value.

    Fast path: ONE fused device reduction and ONE scalar transfer for the
    healthy case (a per-leaf pull costs one device-to-host transfer
    each); the per-leaf breakdown only runs on failure."""
    import jax.numpy as jnp
    leaves = [leaf for leaf in jax.tree_util.tree_leaves(tree)
              if hasattr(leaf, "dtype")
              and jnp.issubdtype(leaf.dtype, jnp.floating)]
    if not leaves:
        return
    ok = bool(jnp.all(jnp.stack(
        [jnp.all(jnp.isfinite(leaf)) for leaf in leaves])))
    if ok:
        return
    bad = []
    for name, (finite, total) in tree_finite_summary(tree).items():
        if not finite or not np.isfinite(total):
            bad.append(name)
    msg = (f"non-finite accumulator(s) after phase '{phase}': "
           f"{', '.join(bad)} — the device kernel output is corrupt; "
           f"rerun with SKIRT9_TPU_GUARDS=verbose for per-batch checks")
    if logger is not None:
        logger.error(msg)
    raise EngineError(msg)


def guards_enabled() -> bool:
    """Segment-boundary guards default ON; SKIRT9_TPU_GUARDS=off disables
    (per-batch 'verbose' mode is read by the Simulation loop)."""
    import os
    return os.environ.get("SKIRT9_TPU_GUARDS", "on") != "off"
