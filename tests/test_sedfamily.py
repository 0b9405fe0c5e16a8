"""SED families: stored-table loading, multilinear mixtures, sampling.

(ref: SEDFamily.hpp:20, FileSSPSEDFamily.hpp:20-43, FileIndexedSEDFamily.hpp)
"""

import numpy as np
import jax.numpy as jnp
import pytest

from skirt9_tpu.spectral import sedfamily as sf
from skirt9_tpu.utils.storedtable import write_stored_table
from skirt9_tpu.ops import rng


def make_ssp_stab(path):
    """Synthetic SSP table: axes lambda(m), Z(1), t(yr); Llambda(W/m).
    L(lam, Z, t) = (1+Z) * t_yr * lam-independent ramp * gaussian(lam)."""
    lam = np.geomspace(1e-7, 1e-5, 64)
    Z = np.array([0.004, 0.02, 0.05])
    t = np.array([1e6, 1e8, 1e10])
    # values shape (nN,...,n1,nq) = (nt, nZ, nlam, 1)
    L = np.zeros((len(t), len(Z), len(lam), 1))
    shape = np.exp(-0.5 * ((np.log(lam) - np.log(1e-6)) / 0.5) ** 2)
    for i, ti in enumerate(t):
        for j, zj in enumerate(Z):
            L[i, j, :, 0] = (1 + 10 * zj) * (ti / 1e8) * shape
    write_stored_table(
        str(path),
        axes=[("lambda", "m", "log", lam), ("Z", "1", "lin", Z),
              ("t", "yr", "log", t)],
        quantities=[("Llambda", "W/m", "log")],
        values=L)
    return lam, Z, t, L


def test_ssp_family_loads_and_interpolates(tmp_path):
    p = tmp_path / "ssp.stab"
    lam, Z, t, L = make_ssp_stab(p)
    fam = sf.load_ssp_family(str(p))
    assert fam.nparams == 2
    np.testing.assert_allclose(fam.lam, lam)
    # node value recovery: params exactly on a grid node
    spec = fam.specific_luminosity(np.array([[0.02, 1e8]]))
    np.testing.assert_allclose(spec[0], L[1, 1, :, 0], rtol=1e-12)
    # midpoint in Z is the average of neighbors (lin axis)
    mid = fam.specific_luminosity(np.array([[0.012, 1e8]]))
    want = 0.5 * (L[1, 0, :, 0] + L[1, 1, :, 0])
    np.testing.assert_allclose(mid[0], want, rtol=1e-10)
    # out-of-range clamps
    lo = fam.specific_luminosity(np.array([[1e-5, 1e6]]))
    np.testing.assert_allclose(lo[0], L[0, 0, :, 0], rtol=1e-10)


def test_family_tables_luminosity_and_sampling(tmp_path):
    p = tmp_path / "ssp.stab"
    lam, Z, t, L = make_ssp_stab(p)
    fam = sf.load_ssp_family(str(p))
    tabs = sf.FamilyTables(fam, lam_range=(2e-7, 5e-6))
    params = np.array([[0.02, 1e8], [0.004, 1e6], [0.035, 1e9]])
    scales = np.array([1.0, 2.0, 0.5])
    lums = tabs.entity_luminosities(scales, params)
    # node 1,1: integral of L(lam) over clip range
    lam_c = tabs.lam_np
    want = np.trapezoid(np.interp(lam_c, lam, L[1, 1, :, 0]), lam_c)
    assert lums[0] == pytest.approx(want, rel=1e-6)
    assert (lums > 0).all()

    # sampled wavelengths follow the mixture spectrum
    cidx, ccdf, cw, ratio = tabs.corner_tables(params)
    # on an exact grid node the geometric and linear mixtures coincide
    assert float(ratio[0]) == pytest.approx(1.0, rel=1e-5)
    B = 20000
    import jax
    keys = rng.event_keys(rng.history_keys(jax.random.PRNGKey(0),
                                           jnp.arange(B)), rng.LAUNCH_EVENT)
    entity = jnp.full((B,), 0, jnp.int32)
    lams = np.asarray(tabs.sample_wavelength(keys, entity, cidx, ccdf))
    assert (lams >= 2e-7 - 1e-12).all() and (lams <= 5e-6 + 1e-12).all()
    # histogram vs analytic pdf: peak near 1e-6 (the gaussian center)
    med = np.median(lams)
    assert 5e-7 < med < 2e-6


def test_indexed_family(tmp_path):
    lam = np.geomspace(1e-7, 1e-5, 32)
    idx = np.array([0.0, 1.0])
    L = np.zeros((2, 32, 1))
    L[0, :, 0] = np.exp(-((np.log(lam / 3e-7)) ** 2) / 0.08)
    L[1, :, 0] = np.exp(-((np.log(lam / 3e-6)) ** 2) / 0.08)
    p = str(f"{lam.size}")
    import os
    path = os.path.join(os.path.dirname(__file__), "_tmp_indexed.stab")
    try:
        write_stored_table(
            path,
            axes=[("lambda", "m", "log", lam), ("index", "1", "lin", idx)],
            quantities=[("Llambda", "W/m", "log")],
            values=L)
        fam = sf.load_indexed_family(path)
        assert fam.L.shape == (2, 32)
        s0 = fam.specific_luminosity(np.array([[0.0]]))
        np.testing.assert_allclose(s0[0], L[0, :, 0], rtol=1e-12)
    finally:
        os.remove(path)


def test_blackbody_family_mixture_matches_planck():
    lam = np.geomspace(2e-7, 5e-5, 200)
    fam = sf.blackbody_family(np.geomspace(2000, 20000, 16), lam)
    from skirt9_tpu.ops.planck import b_lambda_np
    got = fam.specific_luminosity(np.array([[5000.0]]))[0]
    want = np.pi * b_lambda_np(lam, 5000.0)
    # 5000 K is not a grid node -> log-interp error only
    np.testing.assert_allclose(got, want, rtol=0.1)
    i = np.argmax(got)
    assert lam[i] == pytest.approx(2.898e-3 / 5000, rel=0.1)  # Wien
