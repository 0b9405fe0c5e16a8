"""Real multi-process run: the DP + DD production flows across an actual
process boundary (2 CPU processes x 4 virtual devices, gloo collectives).

This executes the MULTIHOST.md design instead of describing it — the
counterpart of the reference's MPI stack (ref: ProcessManager.cpp:45
MPI_Init_thread; :206 per-segment MPI_Allreduce == our one reduction per
segment riding the outer mesh axis between the two processes).

Usage:
    python tools/multiproc_run.py            # parent: spawns 2 workers +
                                             # 1 replicated baseline, writes
                                             # MULTIPROC_r05.json
    python tools/multiproc_run.py --proc I --nprocs N --port P   # worker
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLD = os.path.join(REPO, "tests", "golden")

N_PACKETS = 4096
BATCH = 2048
MAX_EVENTS = 6


def _build_sim(mesh=None, mesh_axis="pp", dd=False):
    from skirt9_tpu.config.ski import load_ski

    sim = load_ski(os.path.join(GOLD, "bench2.ski"), batch_size=BATCH,
                   max_events=MAX_EVENTS, num_packets=N_PACKETS)
    sim.seed = 0
    sim.max_iterations = 2
    if mesh is not None:
        sim.mesh = mesh
        sim.mesh_axis = mesh_axis
        sim.dd = dd
    return sim


def _result(sim):
    import numpy as np
    rf, accs, info = sim.run_with_dust_emission(verbose=False)
    sed = np.asarray(accs[0]["sed"], np.float64)
    return {"sed_sum": float(sed.sum()),
            "sed_head": [float(x) for x in sed.ravel()[:8]],
            "L_dust": float(info["L_dust"]),
            "iterations": int(info["iterations"])}


def worker(proc_id: int, nprocs: int, port: int):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(f"localhost:{port}", num_processes=nprocs,
                               process_id=proc_id)
    import numpy as np
    from jax.sharding import Mesh

    assert jax.process_count() == nprocs
    assert len(jax.devices()) == 4 * nprocs       # global devices
    assert len(jax.local_devices()) == 4

    out = {"procs": nprocs, "devices": len(jax.devices())}

    # --- sanity: a psum across the process boundary -----------------------
    from jax.sharding import PartitionSpec as P
    flat = Mesh(np.array(jax.devices()), ("pp",))
    ones = jax.jit(
        lambda: jax.shard_map(
            lambda: jax.lax.psum(jax.lax.axis_index("pp") + 1, "pp")
            * jax.numpy.ones((1,)),
            mesh=flat, in_specs=(), out_specs=P("pp"), check_vma=False)())()
    from jax.experimental import multihost_utils
    s = float(np.asarray(multihost_utils.process_allgather(
        ones, tiled=True))[0])
    assert s == sum(range(1, 4 * nprocs + 1)), s
    out["psum_over_procs"] = s

    # --- production bench2, packet DP over the 2-level mesh ---------------
    # (MULTIHOST.md: histories shard over BOTH axes — the inner axis spans
    # the devices of a process, the outer the processes)
    devs = np.array(jax.devices()).reshape(nprocs, 4)
    hybrid = Mesh(devs, ("pp_host", "pp_dev"))
    sim = _build_sim(mesh=hybrid, mesh_axis=("pp_host", "pp_dev"))
    out["dp"] = _result(sim)

    # --- production bench2, spatial domain decomposition ------------------
    # (grid slabs shard across ALL 8 devices, spanning the process
    # boundary: the all_to_all owner exchange rides gloo between processes)
    sim_dd = _build_sim(mesh=flat, dd=True)
    out["dd"] = _result(sim_dd)

    if proc_id == 0:
        print("RESULT " + json.dumps(out), flush=True)


def baseline():
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    sim = _build_sim()
    print("RESULT " + json.dumps(_result(sim)), flush=True)


def _extract(txt: str):
    for line in reversed(txt.strip().splitlines()):
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    return None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--proc", type=int, default=None)
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--port", type=int, default=19781)
    ap.add_argument("--baseline", action="store_true")
    args = ap.parse_args()
    if args.baseline:
        return baseline()
    if args.proc is not None:
        return worker(args.proc, args.nprocs, args.port)

    me = os.path.abspath(__file__)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, me, "--proc", str(i), "--nprocs",
         str(args.nprocs), "--port", str(args.port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(args.nprocs)]
    outs = [p.communicate(timeout=1800) for p in procs]
    for i, (p, (so, se)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(f"# worker {i} rc={p.returncode}\n{se[-3000:]}",
                  file=sys.stderr)
            sys.exit(1)
    multi = _extract(outs[0][0])

    base = subprocess.run(
        [sys.executable, me, "--baseline"], capture_output=True, text=True,
        env=env, timeout=1800)
    if base.returncode != 0:
        print(f"# baseline rc={base.returncode}\n{base.stderr[-3000:]}",
              file=sys.stderr)
        sys.exit(1)
    rep = _extract(base.stdout)

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-300)

    record = {
        "procs": multi["procs"],
        "devices": multi["devices"],
        "collective_backend": "gloo (CPU); NCCL on GPU hosts",
        "psum_over_procs": multi["psum_over_procs"],
        "dp": multi["dp"], "dd": multi["dd"], "replicated": rep,
        "rel_diff_dp_sed": rel(multi["dp"]["sed_sum"], rep["sed_sum"]),
        "rel_diff_dp_Ldust": rel(multi["dp"]["L_dust"], rep["L_dust"]),
        "rel_diff_dd_sed": rel(multi["dd"]["sed_sum"], rep["sed_sum"]),
        "rel_diff_dd_Ldust": rel(multi["dd"]["L_dust"], rep["L_dust"]),
        "ok": True,
    }
    record["ok"] = (record["rel_diff_dp_sed"] < 1e-3
                    and record["rel_diff_dd_sed"] < 1e-3)
    path = os.path.join(REPO, "MULTIPROC_r05.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record, indent=1))


if __name__ == "__main__":
    main()
