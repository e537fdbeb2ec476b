"""``chip_smoke.py`` on the CPU: it refuses to run without a GPU, and its
comparison helper holds results to their tolerance. (Its phases run on
the card; see the README.)"""
import os
import shutil
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_require_gpu_refuses_cpu_devices():
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        cs.require_gpu(jax.devices())
    cs.require_gpu([types.SimpleNamespace(platform="gpu")])
    with pytest.raises(RuntimeError, match="needs 4 GPUs"):
        cs.require_gpu([types.SimpleNamespace(platform="gpu")] * 2, count=4)


def test_compare_passes_within_tolerance():
    ref = {"u": np.array([1.0, -2.0, 4.0]), "z": np.zeros(3)}
    got = {"u": ref["u"] * (1 + 1e-6), "z": np.zeros(3)}
    errs = cs.compare("within", got, ref, 1e-5)
    assert errs["u"] == pytest.approx(1e-6, rel=1e-3) and errs["z"] == 0.0


@pytest.mark.parametrize("bad", [1e-3, np.nan])
def test_compare_fails_outside_tolerance(bad):
    ref = {"u": np.array([1.0, -2.0, 4.0])}
    got = {"u": ref["u"] + np.array([0.0, 0.0, 4.0 * bad])}
    with pytest.raises(AssertionError, match="beyond tolerance"):
        cs.compare("outside", got, ref, 1e-5)


def _run(script, env_platforms):
    env = dict(os.environ, JAX_PLATFORMS=env_platforms)
    return subprocess.run([sys.executable, script], capture_output=True,
                          text=True, env=env, timeout=120)


def test_refuses_cpu_platform_without_an_ok_line():
    out = _run(os.path.join(REPO, "chip_smoke.py"), "cpu")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs an NVIDIA GPU" in out.stderr


def test_refuses_to_run_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(str(tmp_path / "chip_smoke.py"), "cuda")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no package beside chip_smoke.py" in out.stderr
