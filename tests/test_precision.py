"""Every float32 contraction on the device path asks for HIGHEST precision.

On a GPU a float32 dot without a precision argument may run in TF32,
which keeps about three decimal digits: the optical depth of every march
is such a dot, and exp(-tau) at tau = 10 would carry ~1% error. The audit
walks the traced jaxpr of a whole segment step, sub-jaxprs included.
"""

import os

import jax
import jax.extend  # noqa: F401  (ClosedJaxpr, Jaxpr)
import jax.numpy as jnp
import numpy as np
import pytest

from skirt9_tpu import simulation as simmod
from skirt9_tpu.config.ski import load_ski
from skirt9_tpu.emission import equilibrium as eq

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
HIGHEST = jax.lax.Precision.HIGHEST


def _sub_jaxprs(value):
    if isinstance(value, jax.extend.core.ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, jax.extend.core.Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def _dots(jaxpr):
    """(precision, operand dtypes) of every dot_general, recursively."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append((eqn.params["precision"],
                        [v.aval.dtype for v in eqn.invars]))
        for p in eqn.params.values():
            for sub in _sub_jaxprs(p):
                out += _dots(sub)
    return out


def _assert_highest(dots):
    f32 = [(p, dt) for p, dt in dots if jnp.float32 in dt]
    assert f32, "expected float32 contractions on this path"
    bad = [(p, dt) for p, dt in f32
           if p is None or tuple(p) != (HIGHEST, HIGHEST)]
    assert not bad, bad


@pytest.mark.parametrize("ski", ["bench1.ski", "bench2.ski", "bench5.ski"])
def test_segment_step_contractions_are_highest(ski):
    """life_cycle for an extinction-only (bench1), a panchromatic
    dust-emission (bench2: stored radiation field, imaging frame) and a
    polarized kinematic (bench5) configuration."""
    B = 256
    sim = load_ski(os.path.join(GOLDEN, ski), num_packets=B, batch_size=B,
                   max_events=2)
    step = sim._segment_runner(sim.sources[0], sim.options, ("audit",))
    accs = [simmod._inst_accumulators(c) for c in sim.instruments]
    closed = jax.make_jaxpr(step, static_argnums=(0, 1))(
        B, 1.0, jax.random.PRNGKey(0), jnp.arange(B, dtype=jnp.int32),
        jnp.int32(B), sim._src_tabs[0], sim._init_rf(), accs)
    _assert_highest(_dots(closed.jaxpr))


def test_emission_state_contractions_are_highest():
    """Absorbed power behind the dust temperatures (bench2's medium)."""
    sim = load_ski(os.path.join(GOLDEN, "bench2.ski"), num_packets=256,
                   batch_size=256, max_events=2)
    etabs = sim._emission_tables()
    rf = jnp.ones((sim.grid.ncells, len(sim.rf_borders) - 1), jnp.float32)
    vols = np.asarray(sim.grid.volumes())
    closed = jax.make_jaxpr(lambda r: eq.emission_state_device(
        sim.medium, etabs, r, vols, sim.rf_scale))(rf)
    _assert_highest(_dots(closed.jaxpr))
