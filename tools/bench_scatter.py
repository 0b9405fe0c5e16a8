"""Time the two forms of the instrument-frame scatter on a GPU.

    python tools/bench_scatter.py

Shapes of bench.py's config 1: 2^17 packet lanes deposit into a 64x64
frame times its one SED bin. The forms compared:

  * `.at[].add`: XLA's scatter-add (atomics on a GPU) — what
    instruments/distant.py uses;
  * one-hot matmul: the value-weighted row one-hot times the column one-hot,
    contracted over lanes at HIGHEST precision (the form an earlier
    matrix-unit kernel used), written in plain jax.numpy.

Both results are checked against each other. Times are medians of warm,
synchronized calls on the host clock. Refuses to run without a GPU.
"""

import statistics
import subprocess
import sys
import time

import jax
import jax.numpy as jnp

LANES = 1 << 17
NPX = NPY = 64
NBINS = 1
SIZE = NBINS * NPY * NPX
PAGE = 128 * 128
REPEATS = 50


@jax.jit
def at_add(idx, val):
    return jnp.zeros((SIZE,), jnp.float32).at[idx].add(val)


@jax.jit
def onehot_matmul(idx, val):
    pages = -(-SIZE // PAGE)
    sub = jnp.arange(128, dtype=jnp.int32)[:, None]
    col = jnp.where(sub == (idx & 127)[None, :], 1.0, 0.0)       # (128, n)
    out = []
    for p in range(pages):
        vp = jnp.where((idx >> 14) == p, val, 0.0)
        row = jnp.where(sub == ((idx >> 7) & 127)[None, :], vp[None, :],
                        0.0)                                      # (128, n)
        out.append(jnp.dot(row, col.T,
                           precision=jax.lax.Precision.HIGHEST).reshape(-1))
    return jnp.concatenate(out)[:SIZE]


def _median_ms(fn, *args):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), min(ts), max(ts)


def main() -> int:
    if jax.default_backend() != "gpu":
        sys.exit(f"bench_scatter: needs a GPU, JAX's default backend is "
                 f"{jax.default_backend()!r}")
    d = jax.devices()[0]
    print(f"device: platform={d.platform} kind={d.device_kind}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    key = jax.random.PRNGKey(0)
    # a centred point source: most lanes land near the frame centre
    xy = jnp.clip(jnp.round(jax.random.normal(key, (LANES, 2)) * 8 + 32),
                  0, 63).astype(jnp.int32)
    idx = xy[:, 1] * NPX + xy[:, 0]
    val = jax.random.uniform(jax.random.PRNGKey(1), (LANES,), jnp.float32)
    a, b = at_add(idx, val), onehot_matmul(idx, val)
    err = float(jnp.max(jnp.abs(a - b)) / jnp.max(jnp.abs(a)))
    for name, fn in (("at_add", at_add), ("onehot_matmul_highest",
                                          onehot_matmul)):
        med, lo, hi = _median_ms(fn, idx, val)
        print(f"{name}: median_ms={med:.4f} min_ms={lo:.4f} max_ms={hi:.4f} "
              f"lanes={LANES} bins={SIZE} repeats={REPEATS}")
    print(f"max_rel_diff_between_forms={err:.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
