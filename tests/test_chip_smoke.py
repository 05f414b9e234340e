"""chip_smoke.py at tiny sizes on the CPU: each phase's route, timing and
checks, and the script's refusals (no GPU; not in a checkout)."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import chip_smoke
from minilp_tpu import routes


def test_phase_cold_single_tiny():
    out = chip_smoke.phase_cold_single(shape=(30, 60, 0.2), backend="cpu")
    assert out["route"] == "cold_solve@cpu"
    assert out["wall_s"] > 0 and out["pivots"] > 0
    assert "certified" in out["check"]


def test_phase_warm_chain_tiny():
    out = chip_smoke.phase_warm_chain(shape=(40, 90, 0.1), nodes=3)
    assert out["route"].startswith("cold:cold_solve ")
    assert out["route"].count("node ") >= 1
    assert "certified" in out["check"]


@pytest.mark.parametrize("route", ["xla", None])
def test_phase_batched_tiny(route):
    out = chip_smoke.phase_batched(batch=16, m=8, nv=16, n_batches=2,
                                   sample=4, route=route)
    assert out["route"] == "xla"          # the CPU's route, forced or not
    assert out["check"].startswith("32/32 certified")


def test_phase_crossover_tiny(monkeypatch):
    """A small instance forced through the crossover route (the size
    threshold lowered): certified, host PDHG stage on the CPU."""
    monkeypatch.setattr(routes, "CROSSOVER_MIN_ROWS", 16)
    out = chip_smoke.phase_crossover(shape=(40, 90, 0.1), backend="cpu")
    assert out["route"] == "cold_solve_crossover@cpu"
    assert "crossover_pdhg_s" in out["stages"]
    assert "crossover_pdhg_device_s" in out["stages"]   # timed, declined


def test_main_refuses_without_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_script_fails_outside_checkout(tmp_path):
    shutil.copy(Path(chip_smoke.__file__), tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
