"""Command-line entry point: run a ski file.

Counterpart of the reference's CLI (ref: SKIRT/main/SkirtMain.cpp:15,
SkirtCommandLineHandler.cpp:31 flags). Usage:

    python -m skirt9_tpu model.ski [more.ski ...] [-o outdir] [-s seed]
        [-p packets] [-b batch] [--max-events N] [-e]

Accepted-for-compatibility but inert flags: -t (thread count — the
engine parallelizes by batch), -m/-v/-d (memory/verbose/data-parallel
logging modes).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time


@dataclasses.dataclass
class RunResult:
    """One ski file's run: the simulation, its radiation field (None
    without a stored field) and the files it wrote."""

    sim: object
    rf: object
    paths: list


def main(argv=None) -> int:
    run(argv)
    return 0


def run(argv=None) -> list[RunResult]:
    """Parse the command line and run each ski file; returns one
    RunResult per simulated ski file (main() is this plus exit code 0)."""
    ap = argparse.ArgumentParser(
        prog="skirt9_tpu",
        description="Monte Carlo radiative transfer in JAX (SKIRT 9 "
                    "capability set)")
    ap.add_argument("skifiles", nargs="*",
                    help=".ski parameter files (none: interactive wizard, "
                    "like the reference's no-argument mode)")
    ap.add_argument("-o", "--outdir", default=".", help="output directory")
    ap.add_argument("-s", "--seed", type=int, default=0, help="RNG seed")
    ap.add_argument("-p", "--packets", type=int, default=None,
                    help="override number of photon packets")
    ap.add_argument("-b", "--batch", type=int, default=16384,
                    help="packet batch size per device")
    ap.add_argument("-e", "--emulate", action="store_true",
                    help="setup only, zero packets (ref: emulation mode)")
    ap.add_argument("--max-events", type=int, default=64,
                    help="bound on scattering events per packet history "
                    "(resonant-line media need more than the default)")
    ap.add_argument("-t", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("-m", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("-v", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("-d", "--devices", type=int, default=1,
                    help="devices for packet data-parallelism (0 = all); "
                    "the reference's -d throws 'not supported' "
                    "(SkirtCommandLineHandler.cpp:329) — here it works")
    ap.add_argument("--export-schema", metavar="FILE", default=None,
                    help="write a SMILE-style schema XML describing the "
                    "supported item surface and exit (ref: smiletool)")
    ap.add_argument("--dd", action="store_true",
                    help="spatial domain decomposition: shard the per-cell "
                    "density/radiation-field tables into x-slabs over the "
                    "-d devices (for grids too large for one device); "
                    "non-Cartesian grids decompose through a voxel raster")
    args = ap.parse_args(argv)

    from .config.ski import load_ski
    from .utils import log as logmod
    from .utils.compile_cache import enable_compile_cache

    if args.export_schema:
        from .config.schema import export_smile
        export_smile(args.export_schema)
        print(f"Schema written to {args.export_schema}")
        return []

    os.makedirs(args.outdir, exist_ok=True)

    if not args.skifiles:
        # interactive ski creation (ref: SkirtCommandLineHandler::
        # doInteractive — `skirt` with no arguments walks a Q&A session
        # and writes the ski file)
        from .config.wizard import run_wizard
        name = input("Enter a name for the new ski file (wizard): "
                     ).strip() or "wizard"
        path = os.path.join(args.outdir, name + ".ski")
        run_wizard(path)
        print(f"Created {path}. Run it with: python -m skirt9_tpu {path}")
        return []
    import jax
    enable_compile_cache()
    results = []
    for ski in args.skifiles:
        prefix = os.path.splitext(os.path.basename(ski))[0]
        # file log next to the outputs (ref: FileLog; <prefix>_log.txt)
        log = logmod.configure(prefix, args.outdir,
                               level="info" if not args.m else "info")
        t0 = time.perf_counter()
        devs = jax.devices()
        log.info(f"device: {devs[0].platform} {devs[0].device_kind} "
                 f"x{len(devs)}")
        log.info(f"Constructing a simulation from ski file {ski}...")
        with log.timed("setup"):
            sim = load_ski(ski, num_packets=args.packets,
                           batch_size=args.batch, seed=args.seed,
                           max_events=args.max_events)
        if args.devices != 1:
            import numpy as np
            from jax.sharding import Mesh
            n = len(devs) if args.devices == 0 else args.devices
            if n > len(devs):
                log.warning(f"requested {n} devices, found {len(devs)}")
                n = len(devs)
            if n > 1:
                sim.mesh = Mesh(np.array(devs[:n]), (sim.mesh_axis,))
                if args.dd:
                    sim.dd = True
                    log.info(f"spatial domain decomposition over {n} "
                             f"devices (sharded per-cell tables)")
                else:
                    log.info(f"packet DP over {n} devices")
        if args.emulate:
            log.success(f"emulation: setup OK, {sim.grid.ncells} cells, "
                        f"{len(sim.sources)} sources, "
                        f"{len(sim.instruments)} instruments")
            continue
        from .probes.probes import run_probe_system
        # per-iteration hooks (Primary/Secondary) fire from inside the
        # flows; give them the output coordinates
        sim.probe_prefix = prefix
        sim.probe_outdir = args.outdir
        probe_paths = run_probe_system(sim, "Setup", prefix, args.outdir)
        with log.timed(f"simulation {prefix}"):
            if sim.iterate_primary:
                sim.run_primary_iterations()
            if sim.ems_borders is not None:
                rf, accs, info = sim.run_with_dust_emission()
            else:
                rf, accs = sim.run_primary()
        with log.timed("final output"):
            paths = sim.write_outputs(accs, prefix, args.outdir)
            paths += run_probe_system(sim, "Run", prefix, args.outdir,
                                      rf=rf)
            paths += probe_paths
        log.success(f"finished {ski} in {time.perf_counter() - t0:.1f} s")
        for p in paths:
            log.info(f"  wrote {p}")
        log.memory()
        results.append(RunResult(sim=sim, rf=rf, paths=paths))
    return results


if __name__ == "__main__":
    sys.exit(main())
