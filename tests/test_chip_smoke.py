"""The parts of chip_smoke.py and of the compile-cache setup that run
without a GPU."""
import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

import lora_sdr_lightweight_standalone_library_clean as L

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402


def test_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr()
    assert out.out == ""
    assert "no GPU found" in out.err


def test_last_line_format():
    card = types.SimpleNamespace(platform="gpu",
                                 device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.result_line([card])
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(chip_smoke.result_line([card] * 4))["device"][
        "count"] == 4


def test_fails_outside_the_repository(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert L.compile_cache_dir() == str(tmp_path)


def test_compile_cache_defaults_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert Path(L.compile_cache_dir()) == REPO / ".jax_cache"
