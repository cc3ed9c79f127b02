"""The port stands alone: importing every module of `ullava_tpu_torch` and
`chip_smoke` pulls in neither `jax` nor the JAX package, entry points
called without a device refuse to run on a machine without CUDA, and
`chip_smoke.py` fails without a card."""

import ast
import json
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import ullava_tpu_torch

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, sys
import torch
mods = sorted(m for m in json.loads(sys.argv[1]))
for m in mods:
    importlib.import_module(m)
import chip_smoke  # noqa: F401
leaked = sorted(m for m in sys.modules
                if m in ("jax", "ullava_tpu") or m.startswith(("jax.", "ullava_tpu.")))
raised = {}
if not torch.cuda.is_available():
    from ullava_tpu_torch import train
    from ullava_tpu_torch.microbench import mlp_variants
    from ullava_tpu_torch.models import llama, ullava, ullava_core
    from ullava_tpu_torch.models.sam import image_encoder
    from ullava_tpu_torch.serve import serve
    cfg = ullava.UllavaConfig.tiny()
    int8 = llama.LlamaConfig.tiny(a8_prefill=True, kv_quant=True)
    sam8 = image_encoder.SamVisionConfig.tiny(mlp_w8a8=True)
    for name, call in (
        ("ullava.init_params", lambda: ullava.init_params(cfg)),
        ("image_encoder.init_params int8", lambda: image_encoder.init_params(sam8)),
        ("llama.init_kv_cache", lambda: llama.init_kv_cache(cfg.core.llm, 1, 4)),
        ("llama.init_kv_cache int8", lambda: llama.init_kv_cache(int8, 1, 4)),
        ("serve", lambda: serve((cfg, None), [])),
        ("train.make_batch", lambda: train.make_batch(ullava_core.UllavaCoreConfig.tiny(), 1, 8)),
        ("train.train_stage1", lambda: train.train_stage1(cfg.core, None, [], {})),
        ("train.make_stage2_batch", lambda: train.make_stage2_batch(cfg, 1, 8)),
        ("train.build_stage2", lambda: train.build_stage2(cfg, None)),
        ("train.train_stage2", lambda: train.train_stage2(cfg, None, [], {})),
        ("mlp_variants.main", lambda: mlp_variants.main()),
    ):
        try:
            call()
            raised[name] = None
        except RuntimeError as e:
            raised[name] = str(e)
print(json.dumps({"modules": len(mods), "leaked": leaked, "raised": raised}))
"""


def _modules():
    names = [ullava_tpu_torch.__name__]
    for info in pkgutil.walk_packages(ullava_tpu_torch.__path__, "ullava_tpu_torch."):
        names.append(info.name)
    return names


def test_port_imports_no_jax_and_entry_points_need_cuda():
    mods = _modules()
    assert "ullava_tpu_torch.models.sam.image_encoder" in mods
    for new in ("ops.quant", "ops.mlp_kernel", "ops.decode_attention", "ops.sam_attention",
                "models.clip_vit", "kernels", "train", "training.optim", "training.train_step",
                "training.checkpoint", "training.trainer", "models.loss",
                "microbench.mlp_variants", "microbench.stage2_grads", "microbench.stage2_ab"):
        assert f"ullava_tpu_torch.{new}" in mods
    res = subprocess.run(
        [sys.executable, "-c", _PROBE, json.dumps(mods)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "CUDA_VISIBLE_DEVICES": ""},
    )
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["modules"] == len(mods)
    assert out["leaked"] == []
    for name, msg in out["raised"].items():
        assert msg and "CUDA" in msg, (name, msg)
    assert set(out["raised"]) == {
        "ullava.init_params", "image_encoder.init_params int8", "llama.init_kv_cache",
        "llama.init_kv_cache int8", "serve", "train.make_batch", "train.train_stage1",
        "train.make_stage2_batch", "train.build_stage2", "train.train_stage2",
        "mlp_variants.main"}


@pytest.mark.parametrize("name", ["test_torch_cuda_bf16.py", "test_torch_cuda_int8.py",
                                  "test_torch_cuda_sam_int8.py", "test_torch_cuda_sam_resident.py",
                                  "test_torch_cuda_train.py", "test_torch_cuda_weight_only.py",
                                  "test_torch_cuda_dots_i8.py", "test_torch_cuda_packed.py",
                                  "test_torch_cuda_mlp_v2.py"])
def test_card_test_files_import_torch_only(name):
    """The tests that run on the card must run on a machine without JAX."""
    tree = ast.parse((REPO / "tests" / name).read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert roots <= {"pytest", "torch", "ullava_tpu_torch", "dataclasses", "math"}, roots


_AB_ROOTS = {"__future__", "argparse", "dataclasses", "importlib", "json", "subprocess", "sys",
             "pathlib", "torch", "ullava_tpu_torch"}


@pytest.mark.parametrize("name", ["flash_bwd_ab", "serve_ab", "stream_ab", "stage2_ab",
                                  "mlp_v2_ab"])
def test_ab_microbenchmarks_import_torch_only_and_need_a_card(name):
    """The parent-against-change microbenchmarks import torch, the port and
    the standard library only (chip_smoke.py by path, at run time), and
    refuse to run without a card."""
    path = REPO / "ullava_tpu_torch" / "microbench" / f"{name}.py"
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert roots <= _AB_ROOTS, roots
    res = subprocess.run(
        [sys.executable, str(path)], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "CUDA_VISIBLE_DEVICES": ""},
    )
    assert res.returncode != 0 and "needs a card" in res.stderr, (res.returncode, res.stderr[-500:])
    assert res.stdout.strip() == ""


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={**env, "PYTHONPATH": str(REPO)},
    )
    assert res.returncode != 0 and '"ok"' not in res.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120, env=env,
    )
    assert res.returncode != 0 and '"ok"' not in res.stdout
