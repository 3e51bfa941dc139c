"""chip_smoke.py's contract, checked without a card: it refuses a CPU
device, its last line has the agreed shape, ``--four-cards`` selects only
the mesh phase, and a failing phase suppresses the ok line."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture
def smoke(monkeypatch):
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke
    return chip_smoke


def _fake_gpu(smoke, monkeypatch, count=1):
    monkeypatch.setattr(smoke, "device_record", lambda: {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
        "count": count, "nvidia_smi": "NVIDIA H100 80GB HBM3, 700.00 W"})


def _stub_phases(smoke, monkeypatch, fail=None):
    ran = []
    for name in ("auto", "methods", "cg", "mesh"):
        def fn(chk, _name=name):
            ran.append(_name)
            if _name == fail:
                raise RuntimeError("phase failed")
            return 0.0
        monkeypatch.setattr(smoke, f"phase_{name}", fn)
    return ran


def test_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "GPU is required" in r.stderr


def test_smoke_last_line_shape(smoke, monkeypatch, capsys):
    _fake_gpu(smoke, monkeypatch)
    ran = _stub_phases(smoke, monkeypatch)
    assert smoke.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert ran == ["auto", "methods", "cg"]
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    # the card's name and power limit come on a line before the last
    assert any("NVIDIA H100 80GB HBM3, 700.00 W" in ln for ln in lines[:-1])


def test_smoke_four_cards_runs_only_mesh(smoke, monkeypatch, capsys):
    _fake_gpu(smoke, monkeypatch, count=4)
    ran = _stub_phases(smoke, monkeypatch)
    assert smoke.main(["--four-cards"]) == 0
    assert ran == ["mesh"]
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["device"]["count"] == 4


def test_smoke_failing_phase_has_no_ok_line(smoke, monkeypatch, capsys):
    _fake_gpu(smoke, monkeypatch)
    ran = _stub_phases(smoke, monkeypatch, fail="methods")
    assert smoke.main([]) == 1
    assert ran == ["auto", "methods", "cg"]      # later phases still report
    assert '"ok"' not in capsys.readouterr().out


def test_smoke_checker_tolerance(smoke):
    import numpy as np
    chk = smoke.Checker()
    g = np.array([10.0, -3.0])
    chk.close("p", "within", g + 5e-4, g, smoke.F32_TOL)    # 5e-4 <= 1e-3
    assert not chk.failures
    chk.close("p", "outside", g + 2e-3, g, smoke.F32_TOL)
    chk.close("p", "nan", np.array([np.nan, 0.0]), g, smoke.F32_TOL)
    chk.exact("p", "bits", g + 1e-12, g)
    assert chk.failures == ["p/outside", "p/nan", "p/bits"]
