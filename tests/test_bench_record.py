"""bench.py's last stdout line must parse whole from a 2000-char tail of
its log, carry every family with the pack/transfer split, and name the
device; the run must refuse to measure without a GPU."""
import importlib.util
import json
import os
import sys

import pytest


def _load_bench():
    root = os.path.join(os.path.dirname(__file__), "..")
    spec = importlib.util.spec_from_file_location(
        "bench_mod", os.path.join(root, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bench():
    return _load_bench()


#: a device record as bench.main builds it on the card
DEVICE = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
          "nvidia_smi": "NVIDIA H100 80GB HBM3, 700.00 W"}


def _fake_configs(bench, fail=()):
    names = list(bench.REFS)
    configs = {}
    for name in names:
        ref_label, ref = bench.REFS[name]
        if name in fail:
            configs[name] = {"error": "Traceback (most recent call "
                                      "last)\n" + "x" * 400,
                             "ref_gflops": ref, "ref": ref_label}
            continue
        configs[name] = {
            "gflops": 123.45, "gflops_marginal": 234.56, "ms": 12.345,
            "sync_bubble_ms": 2.987, "nnz": 32_000_000,
            "method": "Method_SellCSigma", "value_mode": "palette_df",
            "predeal_ms": 75123.4, "pack_ms": 60123.4,
            "transfer_ms": 15000.0, "ref_gflops": ref, "ref": ref_label,
            "vs_ref": 12.34,
        }
    return names, configs


def test_compact_line_survives_tail(bench, tmp_path, capsys):
    names, configs = _fake_configs(bench)
    head = configs["banded4m"]
    line = bench.emit_records("banded4m", head, DEVICE, names, configs,
                              out_dir=str(tmp_path))
    # widest realistic field values still fit the driver's tail window
    assert len(line) < 1900
    tail = line[-2000:]          # what the driver keeps
    rec = json.loads(tail)       # the whole line survived
    assert rec["vs_baseline"] == head["vs_ref"]
    assert set(rec["families"]) == set(names)   # ALL 9 families present
    for fam in rec["families"].values():
        assert {"g", "vr", "pk", "tx"} <= set(fam)
    assert rec["device"] == DEVICE
    # stdout is exactly the one line
    out = capsys.readouterr().out.strip().splitlines()
    assert out == [line]


def test_full_record_on_disk(bench, tmp_path):
    names, configs = _fake_configs(bench, fail=("webbase1m",))
    head = configs["banded4m"]
    line = bench.emit_records("banded4m", head, DEVICE, names, configs,
                              out_dir=str(tmp_path))
    rec = json.loads(line)
    assert rec["families"]["webbase1m"] == {"e": 1}
    full = json.load(open(tmp_path / "bench_latest.json"))
    assert full["configs"]["uniform100k"]["pack_ms"] == 60123.4
    assert full["configs"]["uniform100k"]["transfer_ms"] == 15000.0
    assert "error" in full["configs"]["webbase1m"]
    assert "timing_protocol" in full


def test_compact_even_with_errors(bench, tmp_path, capsys):
    names, configs = _fake_configs(
        bench, fail=tuple(n for n in bench.REFS if n != "banded4m"))
    head = configs["banded4m"]
    line = bench.emit_records("banded4m", head, DEVICE, names, configs,
                              out_dir=str(tmp_path))
    capsys.readouterr()
    assert len(line) < 1900
    json.loads(line[-2000:])


def test_bench_refuses_without_gpu(bench):
    """On the CPU backend the benchmark raises before measuring anything."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    with pytest.raises(RuntimeError, match="GPU is required"):
        bench.main()
