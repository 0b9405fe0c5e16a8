"""chip_smoke.py refuses to run where JAX finds no GPU: it names what is
missing, prints no result and never falls back to the CPU."""

import importlib.util
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        _load().require_gpu()
    msg = str(e.value.code)
    assert "GPU" in msg and "'cpu'" in msg


def test_main_prints_no_result_without_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        _load().main(["--four"])
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_script_exits_nonzero_on_cpu(tmp_path):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, env=env,
                       cwd=str(tmp_path), timeout=300)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "GPU" in r.stderr
