"""The port never imports JAX nor the JAX package: a fresh interpreter
imports the package, every module of the ported slice and chip_smoke.py,
and neither `jax` nor `prot2text_tpu` (or any of their submodules) may be
in sys.modules afterwards."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "prot2text_tpu_torch",
    "prot2text_tpu_torch.core.checkpoint",
    "prot2text_tpu_torch.core.device",
    "prot2text_tpu_torch.core.dtypes",
    "prot2text_tpu_torch.core.observe",
    "prot2text_tpu_torch.data",
    "prot2text_tpu_torch.data.chat",
    "prot2text_tpu_torch.data.collate",
    "prot2text_tpu_torch.data.dataloaders",
    "prot2text_tpu_torch.data.dataset",
    "prot2text_tpu_torch.data.sampler",
    "prot2text_tpu_torch.data.tokenization",
    "prot2text_tpu_torch.eval_metrics",
    "prot2text_tpu_torch.eval_metrics.metrics",
    "prot2text_tpu_torch.kernels",
    "prot2text_tpu_torch.kernels._build",
    "prot2text_tpu_torch.kernels.attention",
    "prot2text_tpu_torch.kernels.cache_update",
    "prot2text_tpu_torch.kernels.decode_attention",
    "prot2text_tpu_torch.kernels.flash_attention",
    "prot2text_tpu_torch.kernels.probe_int8_kv",
    "prot2text_tpu_torch.kernels.probe_quant_matmul",
    "prot2text_tpu_torch.kernels.quant_matmul",
    "prot2text_tpu_torch.models",
    "prot2text_tpu_torch.models.adapters",
    "prot2text_tpu_torch.models.composed",
    "prot2text_tpu_torch.models.decoder",
    "prot2text_tpu_torch.models.esm2",
    "prot2text_tpu_torch.models.esmc",
    "prot2text_tpu_torch.models.fusion",
    "prot2text_tpu_torch.models.hf_import",
    "prot2text_tpu_torch.models.llama",
    "prot2text_tpu_torch.models.lora",
    "prot2text_tpu_torch.models.medusa",
    "prot2text_tpu_torch.models.peft_interop",
    "prot2text_tpu_torch.models.quant",
    "prot2text_tpu_torch.models.qwen3",
    "prot2text_tpu_torch.models.transformer",
    "prot2text_tpu_torch.models.weights",
    "prot2text_tpu_torch.infer",
    "prot2text_tpu_torch.infer.generate",
    "prot2text_tpu_torch.infer.kvcache",
    "prot2text_tpu_torch.infer.serving",
    "prot2text_tpu_torch.infer.speculative",
    "prot2text_tpu_torch.infer.beam_search",
    "prot2text_tpu_torch.train",
    "prot2text_tpu_torch.train.contrastive",
    "prot2text_tpu_torch.train.draft",
    "prot2text_tpu_torch.train.legacy",
    "prot2text_tpu_torch.train.optim",
    "prot2text_tpu_torch.train.sft",
    "prot2text_tpu_torch.cli.benchmark",
    "prot2text_tpu_torch.cli.common",
    "prot2text_tpu_torch.cli.convert_checkpoint",
    "prot2text_tpu_torch.cli.generate_instruct",
    "prot2text_tpu_torch.cli.generate_instruct_light",
    "prot2text_tpu_torch.cli.generate_legacy",
    "prot2text_tpu_torch.cli.serve",
    "prot2text_tpu_torch.cli.train_contrast",
    "prot2text_tpu_torch.cli.train_draft",
    "prot2text_tpu_torch.cli.train_instruct",
    "prot2text_tpu_torch.cli.train_legacy",
    "prot2text_tpu_torch.scripts",
    "prot2text_tpu_torch.scripts._timing",
    "prot2text_tpu_torch.scripts.bench_int4_planes",
    "prot2text_tpu_torch.scripts.bench_int4_single",
    "prot2text_tpu_torch.scripts.bench_int4_unpack",
    "prot2text_tpu_torch.scripts.bench_int8_mxu",
    "prot2text_tpu_torch.scripts.bench_lmhead3",
    "prot2text_tpu_torch.scripts.probe_int8_kv",
    "prot2text_tpu_torch.scripts.sweep_decode_split",
    "prot2text_tpu_torch.scripts.sweep_quant_rows",
    "prot2text_tpu_torch.scripts.time_slab_write",
    "chip_smoke",
]

SCRIPT = """
import importlib, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "prot2text_tpu")
             or m.startswith(("jax.", "prot2text_tpu.")))
assert not bad, bad
print("ok", len(sys.argv) - 1)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", SCRIPT, *MODULES], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == f"ok {len(MODULES)}"


def test_chip_smoke_refuses_without_gpu_and_prints_no_result():
    """Without a card the smoke test fails and prints no contract line."""
    import torch

    if torch.cuda.is_available():
        import pytest

        pytest.skip("a GPU is present")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
