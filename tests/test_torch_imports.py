"""The port stands alone: importing every module of `ullava_tpu_torch` and
`chip_smoke` pulls in neither `jax` nor the JAX package, no module of the
port names a path into `ullava_tpu/`, entry points called without a
device (the model build, both inference CLIs and the training and eval
CLIs among them) refuse to run on a machine without CUDA, and
`chip_smoke.py` fails without a card."""

import ast
import json
import pkgutil
import re
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
    from ullava_tpu_torch import eval_ullava, train, train_ullava, train_ullava_core
    from ullava_tpu_torch.config import Config
    from ullava_tpu_torch.inference_ullava import run_once
    from ullava_tpu_torch.inference_ullava_core import CoreChat
    from ullava_tpu_torch.microbench import mlp_variants
    from ullava_tpu_torch.models import build
    from ullava_tpu_torch.models import llama, ullava, ullava_core
    from ullava_tpu_torch.models.sam import automatic, build as sam_build, image_encoder, predictor
    from ullava_tpu_torch.serve import serve
    cfg = ullava.UllavaConfig.tiny()
    int8 = llama.LlamaConfig.tiny(a8_prefill=True, kv_quant=True)
    sam8 = image_encoder.SamVisionConfig.tiny(mlp_w8a8=True)
    cli_cfg = Config(cfg_dict={"model": {"arch": "ullava"}, "task": {}, "processor": {},
                               "training": {}})
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
        ("build.build_ullava", lambda: build.build_ullava({}, None)),
        ("run_once", lambda: run_once(cli_cfg, None, "Segment it .", tokenizer=object())),
        ("CoreChat", lambda: CoreChat(cli_cfg, tokenizer=object())),
        ("train_ullava.train", lambda: train_ullava.train(cli_cfg, tokenizer=object())),
        ("train_ullava_core.train", lambda: train_ullava_core.train(cli_cfg, tokenizer=object())),
        ("eval_ullava.evaluate", lambda: eval_ullava.evaluate(cli_cfg, tokenizer=object())),
        ("SamPredictor", lambda: predictor.SamPredictor(None, sam_build.sam_vit_l())),
        ("SamAutomaticMaskGenerator",
         lambda: automatic.SamAutomaticMaskGenerator(None, sam_build.sam_vit_b())),
        ("sam_build.init_sam_params", lambda: sam_build.init_sam_params(sam_build.sam_vit_b())),
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
                "microbench.mlp_variants", "microbench.stage2_grads", "microbench.stage2_ab",
                "models.build", "models.weights", "models.tools", "models.sam.convert",
                "ops.image_ops", "config", "registry", "conversation", "tokenization",
                "data.processors.clip_processor", "data.tools.mask_toolbox",
                "inference_ullava", "inference_ullava_core",
                "data.tools.image_io", "data.tools.native", "data.tools.rle",
                "data.processors.base_processor", "data.datasets.base_dataset",
                "data.datasets.llava_dataset", "data.datasets.res_dataset",
                "data.datasets.concat_dataset", "data.datasets.salient_seg_dataset",
                "data.datasets.sem_seg_dataset", "data.collators.collators",
                "data.builders.base_builder", "data.builders.plain_type_builder",
                "data.builders.template_type_builder", "data.loader", "tasks",
                "tasks.base_task", "tasks.image_text_pretrain", "tasks.image_text_evaluate",
                "evaluation", "evaluation.tools", "evaluation.harness",
                "train_ullava", "train_ullava_core", "eval_ullava", "models.sam.predictor",
                "models.sam.automatic", "models.sam.export", "models.sam.prompt_encoder"):
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
        "mlp_variants.main", "build.build_ullava", "run_once", "CoreChat",
        "train_ullava.train", "train_ullava_core.train", "eval_ullava.evaluate", "SamPredictor",
        "SamAutomaticMaskGenerator", "sam_build.init_sam_params"}


def _code_strings(tree):
    """The string constants of a module that are not docstrings."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]


_OPENS = r"""
import json, os, sys
opened = []
sys.addaudithook(lambda event, args: opened.append(str(args[0]))
                 if event == "open" and isinstance(args[0], (str, bytes, os.PathLike)) else None)
import numpy as np
import chip_smoke
from toy_tokenizer import ToyLlamaTokenizer
from ullava_tpu_torch import eval_ullava, train_ullava
from ullava_tpu_torch.config import Config
root = sys.argv[1]
os.makedirs(os.path.join(root, "images"))
rng = np.random.default_rng(0)
items = []
for i in range(2):
    with open(os.path.join(root, "images", f"{i}.png"), "wb") as f:
        f.write(chip_smoke.png_bytes(rng.integers(0, 256, (28, 64, 3), dtype=np.uint8)))
    items.append({"image_path": f"{i}.png", "segmentation": [[2, 2, 40, 2, 40, 20, 2, 20]],
                  "category": "box", "bbox": [2, 2, 38, 18], "height": 28, "width": 64,
                  "sentences": ["the box"]})
with open(os.path.join(root, "res.jsonl"), "w") as f:
    f.writelines(json.dumps(a) + "\n" for a in items)
ds = {"image_token_len": 4, "sam_image_size": 64, "vis_processor": "clip_image",
      "build_info": {"anno_dir": os.path.join(root, "res.jsonl"),
                     "image_dir": os.path.join(root, "images"),
                     "template_root": os.path.join("ullava_tpu_torch", "data", "templates",
                                                   "SEG.json")}}
cfg = {"model": {"arch": "ullava", "conv_type": "conv_sep2"},
       "task": {"type": "image_text_pretrain", "collator_type": "grounding_collator"},
       "processor": {"clip_image": {"image_size": 28}}, "dataset": {"refcoco": ds},
       "eval_dataset": {"refcoco_val": ds},
       "training": {"output_dir": os.path.join(root, "out"), "per_device_train_batch_size": 2,
                    "num_train_epochs": 1, "evaluation_strategy": "epoch",
                    "dataloader_num_workers": 1}}
import ullava_tpu_torch.models.build  # noqa: F401
tok = ToyLlamaTokenizer(model_max_length=128)
train_ullava.train(Config(cfg_dict=cfg), tokenizer=tok, device="cpu")
eval_ullava.evaluate(Config(cfg_dict=cfg), tokenizer=tok, device="cpu")
jax_dir = os.path.join(os.getcwd(), "ullava_tpu") + os.sep
print(json.dumps({"opened": len(opened),
                  "jax_package": [p for p in opened if os.path.abspath(p).startswith(jax_dir)],
                  "templates": [p for p in opened if p.endswith("SEG.json")]}))
"""


def test_port_reads_no_file_of_the_jax_package(tmp_path):
    """No string of the port's code (docstrings and `file:line` references
    aside) names `ullava_tpu` or a path under it, and a stage-2
    training run with its per-epoch eval and `eval_ullava` on the CPU, from
    files and the port's own template bank, opens no file under
    `ullava_tpu/` (an audit hook records every open)."""
    pattern = re.compile(r"(?<![\w.])ullava_tpu(?!_torch)")
    citation = re.compile(r"ullava_tpu/[\w/]+\.py:\d+")  # a file:line reference
    files = sorted((REPO / "ullava_tpu_torch").rglob("*.py"))
    assert len(files) > 60
    for path in files:
        for text in _code_strings(ast.parse(path.read_text())):
            assert not pattern.search(citation.sub("", text)), (path, text)
    res = subprocess.run(
        [sys.executable, "-c", _OPENS, str(tmp_path)], cwd=REPO, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": f"{REPO}:{REPO / 'tests'}",
                          "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["opened"] > 0 and out["templates"] and out["jax_package"] == []


@pytest.mark.parametrize("name", ["test_torch_cuda_bf16.py", "test_torch_cuda_int8.py",
                                  "test_torch_cuda_sam_int8.py", "test_torch_cuda_sam_resident.py",
                                  "test_torch_cuda_train.py", "test_torch_cuda_weight_only.py",
                                  "test_torch_cuda_dots_i8.py", "test_torch_cuda_packed.py",
                                  "test_torch_cuda_mlp_v2.py", "test_torch_cuda_sam_hd64.py"])
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
