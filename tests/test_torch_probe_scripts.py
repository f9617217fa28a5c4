"""The port's probe scripts (`prot2text_tpu_torch/scripts/`): each `main()`
runs on the CPU at tiny shapes through the plain versions and returns its
rows (host time only: a CPU run has no device time, rate or share); the
shared bounds and L2 rotation; a requested card that is missing is an
error.  On the card, every script at tiny shapes: rows with device times,
every K15 kernel launched."""

import importlib

import pytest
import torch

from prot2text_tpu_torch.kernels import launch_counts, reset_launch_counts
from prot2text_tpu_torch.scripts import _timing as tm

# each probe's shape constants, shrunk for the CPU
TINY = {
    "bench_lmhead3": {"R": 4, "SHAPES": ((64, 128), (128, 64)),
                      "CHUNK_ROWS": (32, 256)},
    "bench_int4_unpack": {"R": 4, "H": 64, "M": 128, "L": 2},
    "bench_int4_planes": {"R": 4, "H": 64, "M": 128, "L": 2},
    "bench_int4_single": {"R": 4, "K": 64, "N": 128, "S": 2},
    "bench_int8_mxu": {"R": 32, "K": 64, "N": 128, "L": 2},
    "probe_int8_kv": {},
}
KERNELS = {"bench_lmhead3": {"K14", "K15a", "library"},
           "bench_int4_unpack": {"K11a", "K15b", "K15c", "K14", "library"},
           "bench_int4_planes": {"K11a", "K10", "K15d", "library"},
           "bench_int4_single": {"K11a", "K15e", "K14", "library"},
           "bench_int8_mxu": {"K15f", "K15g", "K14", "library"},
           "probe_int8_kv": {"K15h", "K15i", "K15j", "K15k", "K15l"}}


def tiny(name, monkeypatch):
    mod = importlib.import_module(f"prot2text_tpu_torch.scripts.{name}")
    for attr, value in TINY[name].items():
        monkeypatch.setattr(mod, attr, value)
    return mod


@pytest.mark.parametrize("name", sorted(TINY))
def test_probe_main_on_cpu(name, capsys, monkeypatch):
    out = tiny(name, monkeypatch).main(["--device", "cpu", "--reps", "1"])
    rows = out["rows"]
    assert {r["kernel"] for r in rows} == KERNELS[name]
    for r in rows:
        assert r["ms"] is None and r["share"] is None and r["gb_s"] is None
        assert r["host_ms"] > 0 and r["bound_ms"] > 0
        assert r["bound_by"] in ("bytes", "operations")
    if name == "probe_int8_kv":
        assert out["ok"] and all(r["ok"] for r in rows)
    printed = capsys.readouterr().out
    assert "cpu (plain versions; host time only)" in printed
    assert len([line for line in printed.splitlines()
                if "(plain version)" in line]) == len(rows)


def test_bounds_and_l2_rotation():
    cuda = torch.device("cuda")
    # K15f at R 128: 58.7 MB of weight, 0.5 MB of x, 7.3 MB of int32 out
    R, K, N = 128, 4096, 14336
    b = tm.bound(2.0 * R * K * N, K * N + R * K + 4 * R * N, tm.PEAK_INT8)
    assert b["bound_by"] == "bytes"
    assert abs(b["bytes_ms"] - 0.0199) < 5e-4
    assert abs(b["ops_ms"] - 0.0076) < 5e-4
    # q/o int8 (16.8 MB) rotates through 7 copies, the vocab through 1
    assert tm.copies(4096 * 4096, cuda) == 7
    assert tm.copies(4096 * 128256, cuda) == 1
    assert tm.copies(4096 * 4096, torch.device("cpu")) == 1


def test_probe_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from prot2text_tpu_torch.scripts import bench_int8_mxu

    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        bench_int8_mxu.main([])


@pytest.mark.cuda
def test_probes_on_cuda_launch_every_k15_kernel(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    reset_launch_counts()
    for name in sorted(TINY):
        out = tiny(name, monkeypatch).main(["--reps", "2"])
        assert all(r["ms"] > 0 for r in out["rows"])
        if name == "probe_int8_kv":
            assert out["ok"]
    counts = launch_counts()
    assert all(counts[k] > 0 for k in counts if k.startswith("K15"))
