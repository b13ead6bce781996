"""chip_smoke.py refuses to report without a GPU: on the CPU, and from a
directory that holds the script but not the package, it exits non-zero
and prints no "ok" line."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _run(script: Path, cwd: Path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_refuses_cpu():
    res = _run(ROOT / "chip_smoke.py", ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "needs a GPU" in res.stderr + res.stdout


def test_chip_smoke_needs_the_package(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    res = _run(tmp_path / "chip_smoke.py", tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


@pytest.mark.parametrize("flag", ["--four", "--bogus"])
def test_chip_smoke_cli(flag):
    """--four asks for four GPUs (and so also fails here); an unknown
    option is a usage error."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), flag], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
