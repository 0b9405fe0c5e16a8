"""GPU smoke run of the ski path, through the command-line entry point.

    python chip_smoke.py          # one GPU: goldens, 256^3 state, determinism
    python chip_smoke.py --four   # four GPUs: packet DP and domain
                                  # decomposition against their references

The script refuses to run without a GPU; it has no CPU fallback. It runs
in one process, because a JAX process reserves most of a card's memory.
It first prints the device as JAX reports it and the card's name and power
limit as nvidia-smi reports them. Then each phase prints one line: its
wall time, its compile time, the device's peak bytes in use so far, and
every check with its measured value beside its limit. The last line of
standard output is one JSON object, printed only when every phase passed:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Any failed phase exits with code 1 and prints no JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import xml.etree.ElementTree as ET

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden")

# (packets, batch, extra CLI arguments) per golden: at least the packet
# count of the matching test in tests/test_reference_parity.py
GOLDEN_RUNS = {
    "bench1": (1 << 20, 1 << 16, []),
    "bench1h": (1 << 20, 1 << 16, []),
    "bench2": (1 << 18, 1 << 16, []),
    "bench3": (1 << 17, 1 << 16, []),
    "bench4": (1 << 17, 1 << 16, []),
    "bench5": (1 << 20, 1 << 16, []),
    # resonant Lya histories outlive the default event bound; the parity
    # test runs them with 128 events too
    "bench6": (1 << 16, 1 << 16, ["--max-events", "128"]),
    "bench7": (1 << 20, 1 << 16, []),
}
# real-sized state: bench1 on CUBE^3 cells
CUBE, CUBE_PACKETS, CUBE_BATCH = 256, 1 << 17, 1 << 16
# the four-card comparisons
FOUR_PACKETS, FOUR_BATCH = 1 << 18, 1 << 16

_COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                   "/jax/core/compile/jaxpr_to_mlir_module_duration",
                   "/jax/core/compile/backend_compile_duration")
_compile_s = [0.0]


def require_gpu(n_devices: int = 1):
    """Return the JAX module when its default backend is a GPU with at
    least n_devices devices; otherwise exit with a message naming what is
    missing (never falls back to the CPU)."""
    try:
        import jax
    except ImportError as e:
        sys.exit(f"chip_smoke: JAX is not importable ({e})")
    try:
        backend = jax.default_backend()
    except RuntimeError as e:
        sys.exit(f"chip_smoke: JAX found no accelerator ({e})")
    if backend != "gpu":
        sys.exit(f"chip_smoke: needs a GPU, but JAX's default backend is "
                 f"{backend!r}")
    if len(jax.devices()) < n_devices:
        sys.exit(f"chip_smoke: needs {n_devices} GPUs, found "
                 f"{len(jax.devices())}")
    return jax


def _card_lines() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def _peak_bytes(jax, device_index: int = 0):
    stats = jax.devices()[device_index].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


class Phase:
    """Collects one phase's checks; `ok` is False when a check failed or
    the phase raised."""

    def __init__(self, name: str):
        self.name = name
        self.checks = []
        self.notes = []
        self.ok = True

    def add(self, checks):
        self.checks += list(checks)


@contextlib.contextmanager
def phase(jax, name: str, results: list):
    ph = Phase(name)
    t0 = time.perf_counter()
    c0 = _compile_s[0]
    try:
        yield ph
    except Exception:
        ph.ok = False
        ph.notes.append("raised " + traceback.format_exc(limit=3)
                        .strip().splitlines()[-1])
        traceback.print_exc(file=sys.stderr)
    ph.ok = ph.ok and all(c.ok for c in ph.checks)
    wall = time.perf_counter() - t0
    parts = [f"phase {name}: {'PASS' if ph.ok else 'FAIL'}",
             f"wall_s={wall:.1f}", f"compile_s={_compile_s[0] - c0:.1f}",
             f"peak_bytes_in_use={_peak_bytes(jax)}"]
    parts += [str(c) for c in ph.checks] + ph.notes
    print(" | ".join(parts), flush=True)
    results.append(ph)


def _cli(cli, ski, outdir, packets, batch, extra=()):
    """One ski file through the CLI's own run(); returns its RunResult."""
    argv = [ski, "-o", outdir, "-s", "0", "-p", str(packets),
            "-b", str(batch), *extra]
    (res,) = cli.run(argv)
    return res


def _sed_path(outdir, ski):
    prefix = os.path.splitext(os.path.basename(ski))[0]
    return os.path.join(outdir, f"{prefix}_i0_sed.dat")


def _write_resized_bench1(workdir: str, n: int) -> str:
    """bench1.ski with its Cartesian grid set to n^3 cells."""
    tree = ET.parse(os.path.join(GOLDEN, "bench1.ski"))
    for mesh in tree.iter("LinMesh"):
        mesh.attrib["numBins"] = str(n)
    path = os.path.join(workdir, f"bench1_{n}.ski")
    tree.write(path)
    return path


def _segment_memory(jax, sim) -> str:
    """compiled.memory_analysis() of the primary segment step."""
    import jax.numpy as jnp

    from skirt9_tpu import simulation as simmod

    step = sim._seg_cache[("prim", 0)]
    B = sim.batch_size
    accs = [simmod._inst_accumulators(c) for c in sim.instruments]
    lowered = step.lower(sim.num_packets, 1.0, jax.random.PRNGKey(sim.seed),
                         jnp.arange(B, dtype=jnp.int32),
                         jnp.int32(sim.num_packets), sim._src_tabs[0],
                         sim._init_rf(), accs)
    ma = lowered.compile().memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return "segment_memory_analysis " + " ".join(
        f"{k}={getattr(ma, k, None)}" for k in keys)


def run_single(jax, cli, parity, work: str) -> list:
    import numpy as np

    results = []
    runs = {}
    # 1. the eight goldens through the CLI
    for bench, (packets, batch, extra) in GOLDEN_RUNS.items():
        with phase(jax, f"golden_{bench}", results) as ph:
            ski = os.path.join(GOLDEN, f"{bench}.ski")
            out = os.path.join(work, bench)
            res = _cli(cli, ski, out, packets, batch, extra)
            runs[bench] = (out, packets, batch, extra)
            ph.notes.append(f"packets={packets} batch={batch}")
            ph.add(parity.sed_checks(bench,
                                     parity.read_sed(_sed_path(out, ski))))
            ph.add(parity.rf_checks(bench, res.sim, res.rf))
            ph.add(parity.temperature_checks(bench, res.sim, res.rf))

    # 2. real-sized state: bench1 on 256^3 cells
    with phase(jax, f"bench1_{CUBE}cube", results) as ph:
        ski = _write_resized_bench1(work, CUBE)
        out = os.path.join(work, f"bench1_{CUBE}")
        res = _cli(cli, ski, out, CUBE_PACKETS, CUBE_BATCH)
        ours = parity.read_sed(_sed_path(out, ski))
        ref = parity.golden_sed("bench1")
        ph.notes.append(f"cells={res.sim.grid.ncells} "
                        f"max_steps={res.sim.options.max_steps}")
        ph.add([parity.rel_dev("transparent", ours["transparent"][0],
                               ref["transparent"][0], 2e-3),
                # tau_radial = 1 (OpticalDepthMaterialNormalization: tau 2
                # along the full Z axis). Cell-centre sampling misplaces
                # the sphere's edge by at most half a cell along the ray:
                # |dtau| <= h/(2R) = 2.4/256/2 = 0.0047 at 256^3, so the
                # ratio is within 0.5% of exp(-1); the limit doubles that.
                parity.rel_dev("direct_over_transparent",
                               ours["primarydirect"][0]
                               / ours["transparent"][0], np.exp(-1.0),
                               1e-2)])
        ph.notes.append(_segment_memory(jax, res.sim))

    # 3. determinism: bench1 again with the same seed (reports, never fails)
    with phase(jax, "determinism_bench1", results) as ph:
        out0, packets, batch, extra = runs["bench1"]
        ski = os.path.join(GOLDEN, "bench1.ski")
        out = os.path.join(work, "bench1_again")
        _cli(cli, ski, out, packets, batch, extra)
        a = np.loadtxt(_sed_path(out0, ski), ndmin=2)
        b = np.loadtxt(_sed_path(out, ski), ndmin=2)
        same = bool(np.array_equal(a, b))
        rel = float(np.max(np.abs(b - a) / np.maximum(np.abs(a), 1e-300)))
        ph.notes.append(f"bit_identical={'yes' if same else 'no'} "
                        f"max_rel_diff={rel:.3g}")
    return results


def run_four(jax, cli, parity, work: str) -> list:
    import numpy as np

    results = []
    # packet DP: the same histories split over 4 cards vs one card
    with phase(jax, "dp_bench2_d4_vs_d1", results) as ph:
        ski = os.path.join(GOLDEN, "bench2.ski")
        packets, batch = FOUR_PACKETS, FOUR_BATCH
        r1 = _cli(cli, ski, os.path.join(work, "dp1"), packets, batch,
                  ["-d", "1"])
        r4 = _cli(cli, ski, os.path.join(work, "dp4"), packets, batch,
                  ["-d", "4"])
        s1 = parity.read_sed(_sed_path(os.path.join(work, "dp1"), ski))
        s4 = parity.read_sed(_sed_path(os.path.join(work, "dp4"), ski))
        lam = s1["wavelength"]
        hi = s1["total"] > 0.01 * s1["total"].max()
        t1 = np.asarray(r1.sim.dust_temperature(r1.rf))[:, 0]
        t4 = np.asarray(r4.sim.dust_temperature(r4.rf))[:, 0]
        lit = t1 > 1.0
        # the primary segment runs identical histories, so its sums differ
        # only in f32 summation order (~1e-6); the secondary launch cdf
        # inherits that noise and can move a few per mille of secondary
        # packets to a neighbouring cell: 1e-3 on integrals and medians
        ph.add([parity.rel_dev("sed_total_integral",
                               np.trapezoid(s4["total"], lam),
                               np.trapezoid(s1["total"], lam), 1e-3),
                parity.below("sed_bin_median_ratio_dev",
                             np.median(np.abs(s4["total"][hi]
                                              / s1["total"][hi] - 1)), 1e-3),
                parity.below("T_median_ratio_dev",
                             np.median(np.abs(t4[lit] / t1[lit] - 1)), 1e-3)])
    # spatial domain decomposition vs replicated, both on 4 cards
    with phase(jax, "dd_bench1_d4dd_vs_d4", results) as ph:
        ski = os.path.join(GOLDEN, "bench1.ski")
        packets, batch = FOUR_PACKETS, FOUR_BATCH
        _cli(cli, ski, os.path.join(work, "rep4"), packets, batch,
             ["-d", "4"])
        _cli(cli, ski, os.path.join(work, "dd4"), packets, batch,
             ["-d", "4", "--dd"])
        a = parity.read_sed(_sed_path(os.path.join(work, "rep4"), ski))
        b = parity.read_sed(_sed_path(os.path.join(work, "dd4"), ski))
        cols = ("total", "transparent", "primarydirect", "primaryscattered")
        scale = max(float(np.max(np.abs(a[k]))) for k in cols)
        dev = max(float(np.max(np.abs(b[k] - a[k]))) for k in cols) / scale
        # tests/test_domain.py's draw-for-draw multi-event tolerance
        ph.add([parity.below("sed_max_abs_dev_over_peak", dev, 3e-3)])
        used = []
        for i, d in enumerate(jax.devices()[:4]):
            st = d.memory_stats() or {}
            used.append(st.get("peak_bytes_in_use") or 0)
            ph.notes.append(f"device{i} bytes_in_use={st.get('bytes_in_use')}"
                            f" peak_bytes_in_use={st.get('peak_bytes_in_use')}")
        ph.add([parity.above("min_device_peak_bytes", min(used), 0)])
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card path and its comparisons")
    args = ap.parse_args(argv)
    n_dev = 4 if args.four else 1
    jax = require_gpu(n_dev)
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    try:
        from skirt9_tpu import __main__ as cli
        from skirt9_tpu.utils import parity
        from skirt9_tpu.utils.compile_cache import enable_compile_cache
    except ImportError as e:
        sys.exit(f"chip_smoke: the skirt9_tpu package is not beside this "
                 f"script ({e})")
    enable_compile_cache()
    devs = jax.devices()[:n_dev]
    print(f"device: platform={devs[0].platform} kind={devs[0].device_kind} "
          f"count={len(devs)}", flush=True)
    cards = _card_lines()
    for line in cards[:n_dev]:
        print(line, flush=True)
    jax.monitoring.register_event_duration_secs_listener(
        lambda event, duration, **kw: _compile_s.__setitem__(
            0, _compile_s[0] + (duration if event in _COMPILE_EVENTS
                                else 0.0)))
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        results = (run_four if args.four else run_single)(jax, cli, parity,
                                                          work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    failed = [r.name for r in results if not r.ok]
    if failed:
        print(f"failed phases: {', '.join(failed)}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
