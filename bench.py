"""Benchmark: photon packets/s, headline = panchromatic dust emission.

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline"} for the
north-star metric (BASELINE.json: packets/s on a panchromatic dust-emission
run), with the other configs as extra diagnostic fields.

The baseline denominators are SKIRT9's measured multi-core CPU packets/s on
the equivalent problems (BASELINE.md / BENCH_BASELINE.json), using the same
MRN mean dust table exported by tools/export_dustmix.py on both sides.

Fault isolation: every config runs in its OWN subprocess with a timeout
(`python bench.py --config N` prints that config's JSON on stdout). A
kernel fault, hang, or OOM in one config can therefore never erase the
other configs' numbers (round-2 lesson: one device fault zeroed the whole
record).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# generous per-config wall clock: first-ever compile on a cold cache can
# take minutes; a warm-cache run finishes in well under a minute
CONFIG_TIMEOUT_S = float(os.environ.get("SKIRT9_BENCH_TIMEOUT", "2400"))


def bench_config1():
    """Monochromatic scattering uniform sphere (BASELINE.md config 1)."""
    from skirt9_tpu.grids.cartesian import make_cartesian
    from skirt9_tpu.instruments import distant as dinst
    from skirt9_tpu.media import system as msys
    from skirt9_tpu.simulation import Simulation
    from skirt9_tpu.sources.base import PointSource
    from skirt9_tpu.transport import lifecycle as lc

    PC = 3.0857e16
    R = PC
    box = 1.2 * R
    n = 32
    grid = make_cartesian(((-box, box),) * 3, (n,) * 3)
    sigma = 1e-24
    nd = msys.uniform_density_sphere(grid, 1.0, sigma, R)
    med = msys.make_medium(grid, nd, np.array([0.4e-6, 0.7e-6]),
                           sigma_ext=np.array([[sigma, sigma]]),
                           albedo=np.full((1, 2), 0.6),
                           g=np.full((1, 2), 0.5))
    inst = dinst.DistantInstrumentCfg(
        name="i0", wave_borders=(0.5e-6, 0.6e-6), distance=100 * PC,
        npx=64, npy=64, fovx=4 * PC, fovy=4 * PC)
    # ExtinctionOnly semantics: bench1.ski stores no radiation field
    # (ref: Configuration.cpp ExtinctionOnly => !hasRadiationField)
    opts = lc.TransportOptions(max_steps=grid.max_steps(), max_events=24,
                               store_rf=False)
    sim = Simulation(grid=grid, medium=med,
                     sources=[PointSource(luminosity=1.0, lam0=0.55e-6)],
                     instruments=[inst], options=opts,
                     num_packets=1 << 20, batch_size=1 << 17, seed=0)
    # warmup (compile) at the same packet count as the timed run: the
    # per-source launch count is a static jit argument
    sim.run_primary(verbose=False)
    t0 = time.perf_counter()
    sim.run_primary(verbose=False)
    dt = time.perf_counter() - t0
    return {"rate": sim.num_packets / dt}


def bench_config2():
    """Panchromatic MRN dust emission (the north-star workload): the exact
    bench2.ski the reference binary runs (tests/golden/bench2.ski), through
    the ski loader -> scan-march transport -> secondary emission."""
    from skirt9_tpu.config.ski import load_ski

    ski = os.path.join(HERE, "tests", "golden", "bench2.ski")
    n_pk = 1 << 20

    def build():
        sim = load_ski(ski, batch_size=1 << 17, max_events=24,
                       num_packets=n_pk)
        sim.seed = 0
        return sim

    # warmup/compile run, then a timed run on the SAME object: the jit
    # caches and emission tables it retains are config-derived (the
    # reference likewise builds them once at setup), while everything
    # data-dependent (RF, secondary source, spectra) is recomputed
    sim = build()
    rf, accs, info = sim.run_with_dust_emission(verbose=False)
    t0 = time.perf_counter()
    rf, accs, info = sim.run_with_dust_emission(verbose=False)
    dt = time.perf_counter() - t0
    total_packets = n_pk * (1 + info["iterations"]
                            + (1 if info["L_dust"] > 0 else 0))
    return {"rate": total_packets / dt, "iterations": info["iterations"]}


def bench_config1h():
    """High optical depth (radial tau=10, albedo 0.9) with lane refill —
    packet lifetimes ~90 events (BASELINE.md config 1h)."""
    from skirt9_tpu.config.ski import load_ski

    ski = os.path.join(HERE, "tests", "golden", "bench1h.ski")
    n_pk = 1 << 19

    def build():
        sim = load_ski(ski, batch_size=1 << 17, max_events=16,
                       num_packets=n_pk)
        sim.seed = 0
        sim.refill_events = 16
        return sim

    sim = build()
    sim.run_primary(verbose=False)      # warmup/compile
    t0 = time.perf_counter()
    sim.run_primary(verbose=False)
    return {"rate": n_pk / (time.perf_counter() - t0)}


def bench_config3():
    """Octree + dust self-absorption iterations (BASELINE.md config 3)."""
    from skirt9_tpu.config.ski import load_ski

    ski = os.path.join(HERE, "tests", "golden", "bench3.ski")
    n_pk = 1 << 18

    def build():
        sim = load_ski(ski, batch_size=1 << 16, max_events=24,
                       num_packets=n_pk)
        sim.seed = 0
        return sim

    sim = build()
    rf, accs, info = sim.run_with_dust_emission(verbose=False)
    t0 = time.perf_counter()
    rf, accs, info = sim.run_with_dust_emission(verbose=False)
    dt = time.perf_counter() - t0
    total = n_pk * (1 + info["iterations"] + (1 if info["L_dust"] > 0 else 0))
    return {"rate": total / dt}


def bench_config4():
    """Imported SSP particles + clumpy-disk Voronoi medium with dust
    emission (BASELINE.md config 4) — the fallback-path stress test."""
    from skirt9_tpu.config.ski import load_ski

    ski = os.path.join(HERE, "tests", "golden", "bench4.ski")
    n_pk = 1 << 19

    def build():
        sim = load_ski(ski, batch_size=1 << 16, max_events=24,
                       num_packets=n_pk)
        sim.seed = 0
        return sim

    sim = build()
    rf, accs, info = sim.run_with_dust_emission(verbose=False)
    t0 = time.perf_counter()
    rf, accs, info = sim.run_with_dust_emission(verbose=False)
    dt = time.perf_counter() - t0
    total = n_pk * (1 + info["iterations"] + (1 if info["L_dust"] > 0 else 0))
    return {"rate": total / dt}


def bench_config5():
    """Polarized electron disk + 2000 km/s kinematic outflow
    (BASELINE.md config 5)."""
    from skirt9_tpu.config.ski import load_ski

    ski = os.path.join(HERE, "tests", "golden", "bench5.ski")
    n_pk = 1 << 20

    def build():
        sim = load_ski(ski, batch_size=1 << 17, max_events=24,
                       num_packets=n_pk)
        sim.seed = 0
        return sim

    sim = build()
    sim.run_primary(verbose=False)      # warmup/compile
    t0 = time.perf_counter()
    sim.run_primary(verbose=False)
    return {"rate": n_pk / (time.perf_counter() - t0)}


def bench_config6():
    """Lyman-alpha resonant line transfer (BASELINE.md config 6): tau0=1e5
    uniform HI sphere at 1e4 K, LyaGaussianSED point source, Constant
    acceleration scheme (xcrit=3) — the exact bench6.ski the reference
    binary ran (ref: LyaNeutralHydrogenGasMix, LyaUtils.cpp)."""
    from skirt9_tpu.config.ski import load_ski

    ski = os.path.join(HERE, "tests", "golden", "bench6.ski")
    n_pk = 1 << 17

    sim = load_ski(ski, batch_size=1 << 16, max_events=128,
                   num_packets=n_pk)
    sim.seed = 0
    sim.run_primary(verbose=False)      # warmup/compile
    t0 = time.perf_counter()
    sim.run_primary(verbose=False)
    return {"rate": n_pk / (time.perf_counter() - t0)}


def bench_config7():
    """X-ray atomic gas (BASELINE.md config 7): Verner photo-absorption +
    Fe K fluorescence + free-electron Compton, N_H = 2e23 cm^-2 sphere,
    flat 0.3-10 keV source — the exact bench7.ski the reference binary ran
    (identical atomic data via tools/export_xray.py on both sides)."""
    from skirt9_tpu.config.ski import load_ski

    ski = os.path.join(HERE, "tests", "golden", "bench7.ski")
    n_pk = 1 << 18

    sim = load_ski(ski, batch_size=1 << 16, max_events=16,
                   num_packets=n_pk)
    sim.seed = 0
    sim.run_primary(verbose=False)      # warmup/compile
    t0 = time.perf_counter()
    sim.run_primary(verbose=False)
    return {"rate": n_pk / (time.perf_counter() - t0)}


def _bench_config1_at(n: int, n_pk: int, batch: int = 1 << 16):
    """bench1 scaled to an n^3 uniform grid (the large-grid capability
    benchmark)."""
    from skirt9_tpu.grids.cartesian import make_cartesian
    from skirt9_tpu.instruments import distant as dinst
    from skirt9_tpu.media import system as msys
    from skirt9_tpu.simulation import Simulation
    from skirt9_tpu.sources.base import PointSource
    from skirt9_tpu.transport import lifecycle as lc

    PC = 3.0857e16
    R = PC
    box = 1.2 * R
    grid = make_cartesian(((-box, box),) * 3, (n,) * 3)
    sigma = 1e-24
    nd = msys.uniform_density_sphere(grid, 1.0, sigma, R)
    med = msys.make_medium(grid, nd, np.array([0.4e-6, 0.7e-6]),
                           sigma_ext=np.array([[sigma, sigma]]),
                           albedo=np.full((1, 2), 0.6),
                           g=np.full((1, 2), 0.5))
    inst = dinst.DistantInstrumentCfg(
        name="i0", wave_borders=(0.5e-6, 0.6e-6), distance=100 * PC,
        npx=64, npy=64, fovx=4 * PC, fovy=4 * PC)
    # ExtinctionOnly semantics (see bench_config1): no stored RF
    opts = lc.TransportOptions(max_steps=grid.max_steps(), max_events=24,
                               store_rf=False)
    sim = Simulation(grid=grid, medium=med,
                     sources=[PointSource(luminosity=1.0, lam0=0.55e-6)],
                     instruments=[inst], options=opts,
                     num_packets=n_pk, batch_size=batch, seed=0)
    sim.run_primary(verbose=False)
    t0 = time.perf_counter()
    sim.run_primary(verbose=False)
    return {"rate": n_pk / (time.perf_counter() - t0)}


def bench_config1x128():
    return _bench_config1_at(128, 1 << 18)


def bench_config1x256():
    return _bench_config1_at(256, 1 << 17, batch=1 << 17)


def bench_config3d9():
    """bench3's octree refined to maxLevel 9 (59k cells) — the deep-tree
    capability benchmark."""
    import shutil
    import tempfile
    import xml.etree.ElementTree as ET

    from skirt9_tpu.config.ski import load_ski

    t = ET.parse(os.path.join(HERE, "tests", "golden", "bench3.ski"))
    for el in t.iter("DensityTreePolicy"):
        el.attrib["maxLevel"] = "9"
        el.attrib["maxDustFraction"] = str(
            float(el.attrib.get("maxDustFraction", "1e-6")) / 4)
    d = tempfile.mkdtemp()
    shutil.copy(os.path.join(HERE, "tests", "golden", "mrn_mean.txt"), d)
    ski = os.path.join(d, "b3deep.ski")
    t.write(ski)
    n_pk = 1 << 17
    sim = load_ski(ski, batch_size=1 << 16, max_events=24,
                   num_packets=n_pk)
    sim.seed = 0
    rf, accs, info = sim.run_with_dust_emission(verbose=False)
    t0 = time.perf_counter()
    rf, accs, info = sim.run_with_dust_emission(verbose=False)
    dt = time.perf_counter() - t0
    total = n_pk * (1 + info["iterations"] + (1 if info["L_dust"] > 0
                                              else 0))
    return {"rate": total / dt}


def bench_config3ism():
    """Clumpy ISM box on a SiteListTreePolicy octree (ref:
    SiteListTreePolicy.hpp — the tree refines around imported sites so
    each site ends up alone in a leaf): 46 clumps x 26 sites, maxLevel 7,
    ~5k leaves scattered over the whole box — the refinement-everywhere
    regime."""
    import numpy as np

    from skirt9_tpu.grids.octree import build_octree, site_list_refine_fn
    from skirt9_tpu.instruments import distant as dinst
    from skirt9_tpu.media import system as msys
    from skirt9_tpu.simulation import Simulation
    from skirt9_tpu.sources.base import PointSource
    from skirt9_tpu.transport import lifecycle as lc

    PC = 3.0857e16
    SIG = 1e-25
    rs = np.random.default_rng(9)
    cc = rs.uniform(-0.85, 0.85, size=(46, 3)) * PC
    sites = np.concatenate(
        [c + rs.normal(scale=0.04 * PC, size=(26, 3)) for c in cc])
    grid = build_octree(((-PC, PC),) * 3, lambda p: np.ones(len(p)),
                        max_level=7, min_level=2,
                        refine_fn=site_list_refine_fn(sites, 1))
    nd = (1.0 / (SIG * 2 * PC)) * np.ones(grid.ncells, np.float32)
    med = msys.make_medium(grid, nd, np.array([0.4e-6, 0.7e-6]),
                           sigma_ext=np.full((1, 2), SIG),
                           albedo=np.full((1, 2), 0.5),
                           g=np.full((1, 2), 0.3))
    inst = dinst.DistantInstrumentCfg(
        name="i0", wave_borders=(0.5e-6, 0.6e-6), distance=100 * PC,
        npx=64, npy=64, fovx=4 * PC, fovy=4 * PC)
    # ExtinctionOnly semantics (see bench_config1): no stored RF
    opts = lc.TransportOptions(max_steps=grid.max_steps(), max_events=16,
                               store_rf=False)
    n_pk = 1 << 17
    sim = Simulation(grid=grid, medium=med,
                     sources=[PointSource(luminosity=1.0, lam0=0.55e-6)],
                     instruments=[inst], options=opts,
                     num_packets=n_pk, batch_size=1 << 16, seed=0)
    sim.run_primary(verbose=False)
    t0 = time.perf_counter()
    sim.run_primary(verbose=False)
    return {"rate": n_pk / (time.perf_counter() - t0)}


def bench_config3ismxl():
    """Refinement-everywhere at scale: 400 clumps x 96 sites on a
    SiteListTreePolicy octree at maxLevel 8 -> ~1.4e5 leaves (ref
    capability: SKIRT/core/TreeSpatialGrid.cpp:37-90 routinely runs
    1e5-1e6 leaves)."""
    import numpy as np

    from skirt9_tpu.grids.octree import build_octree, site_list_refine_fn
    from skirt9_tpu.instruments import distant as dinst
    from skirt9_tpu.media import system as msys
    from skirt9_tpu.simulation import Simulation
    from skirt9_tpu.sources.base import PointSource
    from skirt9_tpu.transport import lifecycle as lc

    PC = 3.0857e16
    SIG = 1e-25
    rs = np.random.default_rng(9)
    cc = rs.uniform(-0.85, 0.85, size=(400, 3)) * PC
    sites = np.concatenate(
        [c + rs.normal(scale=0.03 * PC, size=(96, 3)) for c in cc])
    grid = build_octree(((-PC, PC),) * 3, lambda p: np.ones(len(p)),
                        max_level=8, min_level=2,
                        refine_fn=site_list_refine_fn(sites, 1))
    assert grid.ncells > 100_000, f"want >=1e5 leaves, got {grid.ncells}"
    nd = (1.0 / (SIG * 2 * PC)) * np.ones(grid.ncells, np.float32)
    med = msys.make_medium(grid, nd, np.array([0.4e-6, 0.7e-6]),
                           sigma_ext=np.full((1, 2), SIG),
                           albedo=np.full((1, 2), 0.5),
                           g=np.full((1, 2), 0.3))
    inst = dinst.DistantInstrumentCfg(
        name="i0", wave_borders=(0.5e-6, 0.6e-6), distance=100 * PC,
        npx=64, npy=64, fovx=4 * PC, fovy=4 * PC)
    # ExtinctionOnly semantics (see bench_config1): no stored RF
    opts = lc.TransportOptions(max_steps=grid.max_steps(), max_events=16,
                               store_rf=False)
    n_pk = 1 << 17
    sim = Simulation(grid=grid, medium=med,
                     sources=[PointSource(luminosity=1.0, lam0=0.55e-6)],
                     instruments=[inst], options=opts,
                     num_packets=n_pk, batch_size=1 << 16, seed=0)
    sim.run_primary(verbose=False)
    t0 = time.perf_counter()
    sim.run_primary(verbose=False)
    return {"rate": n_pk / (time.perf_counter() - t0)}


CONFIGS = {
    "1": bench_config1,
    "2": bench_config2,
    "1h": bench_config1h,
    "3": bench_config3,
    "4": bench_config4,
    "5": bench_config5,
    "6": bench_config6,
    "7": bench_config7,
    "1x128": bench_config1x128,
    "1x256": bench_config1x256,
    "3d9": bench_config3d9,
    "3ism": bench_config3ism,
    "3ismxl": bench_config3ismxl,
}


def _run_isolated(name: str) -> dict | None:
    """Run one config in a subprocess; None on crash/hang/parse failure."""
    try:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--config", name],
            capture_output=True, text=True, timeout=CONFIG_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        print(f"# config {name}: TIMED OUT after {CONFIG_TIMEOUT_S}s",
              file=sys.stderr)
        return None
    if res.returncode != 0:
        tail = (res.stderr or "")[-2000:]
        print(f"# config {name}: rc={res.returncode}\n{tail}",
              file=sys.stderr)
        return None
    for line in reversed(res.stdout.strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                continue
    print(f"# config {name}: no JSON in output", file=sys.stderr)
    return None


def main():
    if len(sys.argv) >= 3 and sys.argv[1] == "--config":
        from skirt9_tpu.utils.compile_cache import enable_compile_cache
        enable_compile_cache()
        out = CONFIGS[sys.argv[2]]()
        print(json.dumps(out))
        return

    results = {name: _run_isolated(name)
               for name in ("2", "1", "1h", "3", "4", "5", "6", "7",
                            "1x128", "1x256", "3d9", "3ism", "3ismxl")}

    base = {}
    bp = os.path.join(HERE, "BENCH_BASELINE.json")
    if os.path.exists(bp):
        with open(bp) as f:
            b = json.load(f)
        base = {"1": b.get("packets_per_s"),
                "2": b.get("config2_packets_per_s"),
                "1h": b.get("config1h_packets_per_s"),
                "3": b.get("config3_packets_per_s"),
                "4": b.get("config4_packets_per_s"),
                "5": b.get("config5_packets_per_s"),
                "6": b.get("config6_packets_per_s"),
                "7": b.get("config7_packets_per_s"),
                "1x128": b.get("config1x128_packets_per_s"),
                "1x256": b.get("config1x256_packets_per_s")}

    def rate(name):
        r = results.get(name)
        return r["rate"] if r else None

    def vs(name):
        r, b = rate(name), base.get(name)
        return round(r / b, 3) if (r and b) else None

    r2 = rate("2")
    print(json.dumps({
        "metric": "photon packets/s, panchromatic MRN dust-emission "
                  "(BB source, tau_V=2 sphere, 32^3 grid, 25-bin RF, "
                  "64x64 imaging + 40-bin SED, self-absorption iterations)",
        "value": round(r2, 1) if r2 else None,
        "unit": "packets/s",
        "vs_baseline": vs("2") or 0.0,
        "config1_packets_per_s": round(rate("1"), 1) if rate("1") else None,
        "config1_vs_baseline": vs("1"),
        "config1h_tau10_packets_per_s":
            round(rate("1h"), 1) if rate("1h") else None,
        "config1h_vs_baseline": vs("1h"),
        "config3_octree_packets_per_s":
            round(rate("3"), 1) if rate("3") else None,
        "config3_vs_baseline": vs("3"),
        "config4_voronoi_packets_per_s":
            round(rate("4"), 1) if rate("4") else None,
        "config4_vs_baseline": vs("4"),
        "config5_polarized_kinematic_packets_per_s":
            round(rate("5"), 1) if rate("5") else None,
        "config5_vs_baseline": vs("5"),
        "config6_lya_packets_per_s":
            round(rate("6"), 1) if rate("6") else None,
        "config6_vs_baseline": vs("6"),
        "config7_xray_packets_per_s":
            round(rate("7"), 1) if rate("7") else None,
        "config7_vs_baseline": vs("7"),
        # large-grid runs (2-core baselines measured round 5: the
        # reference's primary-emission-phase rate at 128^3/256^3)
        "config1_128cube_packets_per_s":
            round(rate("1x128"), 1) if rate("1x128") else None,
        "config1_128cube_vs_baseline": vs("1x128"),
        "config1_256cube_packets_per_s":
            round(rate("1x256"), 1) if rate("1x256") else None,
        "config1_256cube_vs_baseline": vs("1x256"),
        "config3_maxlevel9_packets_per_s":
            round(rate("3d9"), 1) if rate("3d9") else None,
        # SiteListTreePolicy refinement-everywhere regimes: ~5k and
        # 1.4e5 leaves
        "config3_ism_sitelist_packets_per_s":
            round(rate("3ism"), 1) if rate("3ism") else None,
        "config3_ismxl_140kleaf_packets_per_s":
            round(rate("3ismxl"), 1) if rate("3ismxl") else None,
        "iterations": (results.get("2") or {}).get("iterations"),
    }))


if __name__ == "__main__":
    main()
