"""Golden-file parity against the built reference SKIRT 9.

tests/golden/bench1.ski was run through the actual reference binary
(built from /root/reference at Release) and its SED output archived as
tests/golden/bench1_i0_sed.dat. Loading the SAME ski file through our
importer and engine must reproduce the fluxes:

  * transparent and direct components are deterministic per packet ->
    sub-percent agreement (limited only by grid discretization diffs),
  * scattered flux agrees within Monte Carlo noise of both codes.

This is the fixed-seed A/B harness of SURVEY.md §4 item 7. The
comparisons and their tolerances live in skirt9_tpu.utils.parity, which
chip_smoke.py runs on the GPU as well.
"""

import os

import numpy as np
import jax
import pytest

from skirt9_tpu.config.ski import load_ski
from skirt9_tpu.instruments import distant as dinst
from skirt9_tpu.utils import parity

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _assert_ok(checks):
    assert checks and all(c.ok for c in checks), \
        [str(c) for c in checks if not c.ok]


def _written_sed(sim, accs, outdir, prefix):
    """The SED as the engine writes it (the file chip_smoke.py compares)."""
    sim.write_outputs(accs, prefix, str(outdir))
    return parity.read_sed(os.path.join(str(outdir), f"{prefix}_i0_sed.dat"))


def test_bench1_parity_with_reference(tmp_path):
    sim = load_ski(os.path.join(GOLDEN, "bench1.ski"),
                   num_packets=100_000, batch_size=1 << 14, max_events=24)
    _, accs = sim.run_primary(verbose=False)
    # transparent: geometry + luminosity bookkeeping; direct: deterministic
    # extinction; scattered: Monte Carlo noise of both runs
    _assert_ok(parity.sed_checks("bench1",
                                 _written_sed(sim, accs, tmp_path, "b1")))


# ---------------------------------------------------------------- config 2
# Panchromatic MRN dust emission vs the reference binary (BASELINE.md
# config 2): both sides use the same exported mean dust table
# (tests/golden/mrn_mean.txt via tools/export_dustmix.py) so the physics is
# pinned; goldens generated by /tmp/skirt_build SKIRT at seed 0, 1e6
# packets (tests/golden/bench2_*).

def _run_bench2(n_pk=1 << 15):
    from skirt9_tpu.config.ski import load_ski
    sim = load_ski(os.path.join(GOLDEN, "bench2.ski"), batch_size=8192,
                   max_events=16, num_packets=n_pk)
    rf, accs, info = sim.run_with_dust_emission(verbose=False)
    return sim, rf, accs, info


@pytest.fixture(scope="module")
def bench2():
    return _run_bench2()


def test_bench2_sed_parity(bench2, tmp_path):
    sim, rf, accs, info = bench2
    sim.write_outputs(accs, "b2", str(tmp_path))
    _assert_ok(parity.sed_checks("bench2",
                                 parity.read_sed(tmp_path / "b2_i0_sed.dat")))


def test_bench2_radiation_field_parity(bench2):
    """Per-cell mean intensity vs the reference's RadiationFieldProbe
    (the north-star 'mean radiation field per cell' parity)."""
    sim, rf, accs, info = bench2
    assert np.asarray(rf).shape[0] == sim.grid.ncells
    _assert_ok(parity.rf_checks("bench2", sim, rf))


def test_bench2_dust_temperature_parity(bench2):
    sim, rf, accs, info = bench2
    _assert_ok(parity.temperature_checks("bench2", sim, rf))


# ---------------------------------------------------------------- config 1h
# High-optical-depth robustness (TRUST regime): radial tau=10, albedo 0.9
# uniform sphere. Packet lifetimes reach ~90 scattering events, so the run
# exercises lane refill (no hard event cap). Golden: seed 0, 1e6 packets.

def test_bench1h_high_tau_parity(tmp_path):
    sim = load_ski(os.path.join(GOLDEN, "bench1h.ski"),
                   num_packets=100_000, batch_size=1 << 14, max_events=16)
    sim.refill_events = 16  # generations of 16 events, no lifetime cap
    _, accs = sim.run_primary(verbose=False)
    _assert_ok(parity.sed_checks("bench1h",
                                 _written_sed(sim, accs, tmp_path, "b1h")))


# ---------------------------------------------------------------- config 3
# Octree (PolicyTreeSpatialGrid, r^-2 shell) + dust self-absorption
# iterations. The two codes build DIFFERENT octrees (both density-policy
# driven), so per-cell comparisons go through the reference's cell centers:
# tests interpolate our fields at the golden cell positions.

def _run_bench3(n_pk=1 << 15):
    sim = load_ski(os.path.join(GOLDEN, "bench3.ski"), batch_size=8192,
                   max_events=16, num_packets=n_pk)
    rf, accs, info = sim.run_with_dust_emission(verbose=False)
    return sim, rf, accs, info


@pytest.fixture(scope="module")
def bench3():
    return _run_bench3()


def test_bench3_iterates(bench3):
    sim, rf, accs, info = bench3
    assert sim.iterate_secondary
    assert info["iterations"] >= 1


def test_bench3_sed_parity(bench3, tmp_path):
    sim, rf, accs, info = bench3
    sim.write_outputs(accs, "b3", str(tmp_path))
    _assert_ok(parity.sed_checks("bench3",
                                 parity.read_sed(tmp_path / "b3_i0_sed.dat")))


def test_bench3_temperature_at_reference_cells(bench3):
    """Interpolate our octree dust temperature at the REFERENCE octree's
    cell centers: mass-weighted parity despite different tree topologies."""
    sim, rf, accs, info = bench3
    _assert_ok(parity.temperature_checks("bench3", sim, rf))


def test_bench3_radiation_field_volume_integral(bench3):
    """Grid-independent RF parity: integral of J over volume per RF bin
    (uses the reference's per-cell volumes from the cell-properties probe)."""
    sim, rf, accs, info = bench3
    _assert_ok(parity.rf_checks("bench3", sim, rf))


# ---------------------------------------------------------------- config 5
# Polarized electron scattering + kinematic (moving-medium) transfer vs the
# reference binary (BASELINE.md config 5): edge-on electron disk with a
# 2000 km/s radial outflow around a blackbody point source; ElectronMix
# includePolarization (exact Thomson Mueller matrix, no resource packs
# needed on either side). Goldens at seed 0, 2e6 packets.

@pytest.fixture(scope="module")
def bench5(tmp_path_factory):
    sim = load_ski(os.path.join(GOLDEN, "bench5.ski"), num_packets=200_000)
    _, accs = sim.run_primary(verbose=False)
    sed = dinst.calibrate_sed(sim.instruments[0], jax.device_get(accs[0]))
    ours = _written_sed(sim, accs, tmp_path_factory.mktemp("b5"), "b5")
    return sim, sed, ours


def _bench5_checks(bench5, prefix):
    sim, sed, ours = bench5
    return [c for c in parity.sed_checks("bench5", ours)
            if c.name.startswith(prefix)]


def test_bench5_flux_parity(bench5):
    """Total/transparent/direct/scattered F_lambda within 2% median; the
    scattered column carries the Doppler redistribution of the 2000 km/s
    outflow (pathLengthBias forced to 0 on both sides,
    ref: Configuration.cpp:493-497)."""
    sim, sed, ours = bench5
    assert sim.options.kinematics and sim.options.polarization
    _assert_ok(_bench5_checks(bench5, ("transparent", "primary", "total")))


def test_bench5_stokes_parity(bench5):
    """Net Stokes Q of the edge-on disk matches the reference in sign and
    magnitude (instrument-frame reference direction = cross(kobs, ky),
    ref: StokesVector::rotateIntoPlane, MonteCarloSimulation.cpp:629);
    U and V are zero by symmetry within MC noise."""
    _assert_ok(_bench5_checks(bench5, ("stokesQ", "polarization", "U_",
                                       "max_abs_V")))


def test_bench5_kinematic_doppler_signature(bench5):
    """The scattered SED is redistributed in wavelength by the outflow:
    switching the velocity off must change the scattered spectrum shape
    more than MC noise, and our moving-medium spectrum must match the
    reference's (already covered by flux parity at 5%). Here: check the
    scattered-to-direct ratio trend differs between static and moving
    runs of OUR engine (regression guard for the kinematics wiring)."""
    sim, sed, ours = bench5
    import xml.etree.ElementTree as ET
    import tempfile
    tree = ET.parse(os.path.join(GOLDEN, "bench5.ski"))
    for m in tree.iter("GeometricMedium"):
        m.attrib["velocityMagnitude"] = "0 km/s"
    with tempfile.NamedTemporaryFile("wb", suffix=".ski",
                                     delete=False) as f:
        tree.write(f)
        path = f.name
    sim0 = load_ski(path, num_packets=200_000)
    assert not sim0.options.kinematics
    _, accs0 = sim0.run_primary(verbose=False)
    sed0 = dinst.calibrate_sed(sim0.instruments[0], jax.device_get(accs0[0]))
    os.remove(path)
    s_mov = sed["primaryscattered"]
    s_sta = sed0["primaryscattered"]
    # same energy to ~1%, different shape: the bluest/reddest bins gain
    # from Doppler redistribution of the thermal-peak photons
    assert np.sum(s_mov) == pytest.approx(np.sum(s_sta), rel=0.02)
    shape = np.abs(s_mov / s_mov.sum() - s_sta / s_sta.sum())
    assert shape.max() > 5e-4


# ---------------------------------------------------------------- config 4
# Imported "hydro" snapshot: star particles with a user-provided SSP SED
# family (synthetic bench4_ssp.stab read by BOTH codes) + a clumpy-disk
# VoronoiMeshMedium whose sites define the spatial grid (policy
# ImportedMesh), MRN mean dust via the exported table, dust emission.
# Both codes tessellate the SAME 2895 sites, so per-cell fields compare
# one-to-one through a nearest-site match.

def _run_bench4(n_pk=100_000):
    sim = load_ski(os.path.join(GOLDEN, "bench4.ski"), batch_size=8192,
                   max_events=16, num_packets=n_pk)
    rf, accs, info = sim.run_with_dust_emission(verbose=False)
    return sim, rf, accs, info


@pytest.fixture(scope="module")
def bench4():
    return _run_bench4()


def test_bench4_source_luminosity_matches_family_integral(bench4):
    """The imported stellar population's luminosity integrates the
    geometric (log-interpolated) SSP mixture exactly like the reference
    (ref: FileSSPSEDFamily.cpp:44-47 parameter scaling; StoredTable log
    value interpolation). The reference run reports 9.0e7 Lsun of dust
    luminosity from these stars; our stellar total must exceed that."""
    sim, rf, accs, info = bench4
    L = sim.sources[0].luminosity / 3.846e26
    assert 0.9e8 < L < 1.2e8, L


def test_bench4_sed_parity(bench4, tmp_path):
    sim, rf, accs, info = bench4
    sim.write_outputs(accs, "b4", str(tmp_path))
    _assert_ok(parity.sed_checks("bench4",
                                 parity.read_sed(tmp_path / "b4_i0_sed.dat")))


def test_bench4_temperature_per_cell(bench4):
    """Same Voronoi sites on both sides: per-cell indicative dust
    temperature compares one-to-one (nearest-site match of the golden
    cell centers)."""
    sim, rf, accs, info = bench4
    _assert_ok(parity.temperature_checks("bench4", sim, rf))


def test_bench4_cell_volumes_match_reference(bench4):
    """Exact clipped-polyhedron volumes vs the reference's Voro++ volumes
    (cell-properties probe column 5, pc^3): same tessellation, so the
    volumes must agree to f32/qhull tolerance cell by cell."""
    import gzip
    sim, rf, accs, info = bench4
    with gzip.open(os.path.join(GOLDEN, "bench4_cellprops.dat.gz"),
                   "rt") as f:
        props = np.loadtxt(f)
    PC = 3.0857e16
    centers = props[:, 1:4] * PC
    v_ref = props[:, 4] * PC ** 3
    from scipy.spatial import cKDTree
    sites = np.asarray(sim.grid.sites, np.float64)
    _, idx = cKDTree(sites).query(centers)
    v_ours = sim.grid.volumes()[idx]
    ratio = v_ours / v_ref
    assert np.median(np.abs(ratio - 1.0)) < 1e-3
    assert (np.abs(ratio - 1.0) < 0.02).mean() > 0.99


# ---------------------------------------------------------------- config 6
# Lyman-alpha resonant line transfer vs the reference binary (BASELINE.md
# config 6): tau0=1e5 uniform HI sphere at 1e4 K around a LyaGaussianSED
# point source, Constant acceleration scheme (xcrit=3) on both sides — no
# resource packs needed on either side. Golden at seed 0, 1e6 packets.

@pytest.fixture(scope="module")
def bench6(tmp_path_factory):
    sim = load_ski(os.path.join(GOLDEN, "bench6.ski"), num_packets=20_000,
                   max_events=128)
    _, accs = sim.run_primary(verbose=False)
    return _written_sed(sim, accs, tmp_path_factory.mktemp("b6"), "b6")


def test_bench6_lya_profile_parity(bench6):
    """Double-peaked emergent Lya profile vs the reference: dark core,
    symmetric peaks at the same wavelengths, escaped energy within a few
    per cent (MC noise at 2e4 vs 1e6 packets + redistribution-shape
    differences keep the peak heights within ~10%)."""
    ours = bench6
    assert ours["wavelength"].shape == parity.golden_sed("bench6")[
        "wavelength"].shape
    _assert_ok(parity.sed_checks("bench6", ours))


# ---------------------------------------------------------------- config 7
# X-ray atomic gas vs the reference binary (BASELINE.md config 7): uniform
# gas sphere N_H(full axis) = 2e23 cm^-2 around a flat-F_lambda point
# source over 0.3-10 keV; XRayAtomicGasMix with scatterBoundElectrons=Free
# and temperature=0 on both sides, with IDENTICAL atomic data exported by
# tools/export_xray.py (Verner H/He + approximate Fe K with K-alpha/beta
# fluorescence) into the reference's resource directory and next to the
# ski. Golden at seed 0, 1e6 packets.

@pytest.fixture(scope="module")
def bench7(tmp_path_factory):
    sim = load_ski(os.path.join(GOLDEN, "bench7.ski"), num_packets=100_000,
                   max_events=16)
    _, accs = sim.run_primary(verbose=False)
    return _written_sed(sim, accs, tmp_path_factory.mktemp("b7"), "b7")


def test_bench7_xray_parity(bench7):
    """Transparent/direct/scattered parity incl. the Verner photo-
    absorption edge structure and the Fe K fluorescence line. The
    reference tags fluorescence as SECONDARY components
    (XRayAtomicGasMix::scatteringEmulatesSecondaryEmission); we record it
    as primary scattered, so the comparison sums the reference's primary
    scattered + secondary direct + secondary scattered."""
    _assert_ok(parity.sed_checks("bench7", bench7))
