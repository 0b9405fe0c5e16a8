"""The shared golden comparison (skirt9_tpu.utils.parity) that the
reference-parity tests and chip_smoke.py both use."""

import numpy as np
import pytest

from skirt9_tpu.utils import parity

# bench1 as this engine wrote it (CLI, seed 0, 16384 packets, CPU)
RECORDED_BENCH1 = """\
# skirt9_tpu SED output
# column 1: wavelength; lambda (micron)
# column 2: total flux; F_lambda (W/m2/micron)
# column 3: transparent flux; F_lambda (W/m2/micron)
# column 4: direct primary flux; F_lambda (W/m2/micron)
# column 5: scattered primary flux; F_lambda (W/m2/micron)
# column 6: direct secondary flux; F_lambda (W/m2/micron)
# column 7: scattered secondary flux; F_lambda (W/m2/micron)
# column 8: relative error R (1)
# column 9: variance of the variance VOV (1)
5.499997249999313276e-01 1.865549772316044962e-09 2.917204111451943640e-09 \
1.059707526221657350e-09 8.058422460943874054e-10 0.000000000000000000e+00 \
0.000000000000000000e+00 4.561522626761755489e-03 2.534828095699768284e-05
"""


def _recorded(tmp_path):
    p = tmp_path / "bench1_i0_sed.dat"
    p.write_text(RECORDED_BENCH1)
    return parity.read_sed(str(p))


def test_read_sed_keys_columns_by_header(tmp_path):
    ours = _recorded(tmp_path)
    assert ours["transparent"][0] == pytest.approx(2.917204111451943640e-09)
    assert ours["primaryscattered"][0] == pytest.approx(8.0584224609e-10)
    assert "R" not in ours
    ref = parity.golden_sed("bench5")     # reference layout with Stokes
    assert set(ref) >= {"Q", "U", "V", "secondaryscattered"}
    assert ref["Q"].shape == ref["wavelength"].shape


def test_recorded_bench1_passes(tmp_path):
    checks = parity.sed_checks("bench1", _recorded(tmp_path))
    assert [c.name for c in checks] == ["transparent", "primarydirect",
                                        "primaryscattered"]
    assert all(c.ok for c in checks), [str(c) for c in checks]


def test_recorded_bench1_with_wrong_transparent_fails(tmp_path):
    ours = _recorded(tmp_path)
    ours["transparent"] = ours["transparent"] * 1.01
    checks = {c.name: c for c in parity.sed_checks("bench1", ours)}
    assert not checks["transparent"].ok
    assert checks["transparent"].value == pytest.approx(0.01, rel=0.05)
    assert checks["primarydirect"].ok and checks["primaryscattered"].ok


@pytest.mark.parametrize("bench", parity.BENCHES)
def test_golden_against_itself(bench):
    """Every comparison accepts the reference's own SED (for bench7 in
    this engine's layout, which records fluorescence as primary
    scattered flux where the reference tags it secondary)."""
    ours = dict(parity.golden_sed(bench))
    if bench == "bench7":
        ours["primaryscattered"] = (ours["primaryscattered"]
                                    + ours["secondarydirect"]
                                    + ours["secondaryscattered"])
    checks = parity.sed_checks(bench, ours)
    assert checks and all(c.ok for c in checks), \
        [str(c) for c in checks if not c.ok]


def test_check_formatting():
    c = parity.rel_dev("x", 1.02, 1.0, 0.05)
    assert c.ok and c.limit == 0.05
    assert str(c) == "x=0.02 (limit 0.05) ok"
    assert not parity.above("y", 0.5, 0.9).ok
    np.testing.assert_allclose(parity.below("z", 3, 2).value, 3.0)
