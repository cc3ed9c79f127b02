"""The port's training and eval CLIs against the JAX package's
(`train_ullava_core.train`, `train_ullava.train`, `eval_ullava.evaluate`)
at tiny sizes on the CPU, from the same files.

Both packages read one set of files the test writes (PNG and JPEG images
of 28 x 64, so that CLIP's and SAM's resizes are identities and the two
image pipelines agree exactly; RES polygons; a LLaVA chat set) and start
from the same parameters: one JAX-built tree in fp32, saved by orbax for
the JAX CLI and in the port's layout (`bridge.params_from_jax`) for the
port's, named by `pretrained_core` / `pretrained_ullava` as
`tests/test_torch_build.py` does. Both builds are run in fp32 (the
`dtype` their CLIs leave at bf16), the one draw the two make apart, the
LoRA A factors, is replaced by a numpy draw on both sides, and the JAX
`STAGE2_LORA`, which names no adapter, is handed the port's pattern, so
that both train the same leaves. The JAX CLIs run on a mesh of one device,
as the port's on one card, and one loader worker keeps the toy
tokenizers' ids in step. Tolerances: each step's loss and gradient norm
within 1e-5 (the stage-2 step's in `tests/test_torch_stage2_steps.py`),
the eval metrics within 1e-4.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import eval_ullava as jeval_cli
import train_ullava as jtrain_cli
import train_ullava_core as jcore_cli
from toy_tokenizer import ToyLlamaTokenizer
from ullava_tpu.config import Config as JConfig
from ullava_tpu.constants import MM_TOKENS
from ullava_tpu.models import build as jbuild
from ullava_tpu.models import llama as jllama
from ullava_tpu import parallel as jparallel
from ullava_tpu.training import checkpoint as jckpt
from ullava_tpu.training import optim as joptim
from ullava_tpu.training import trainer as jtrainer
from ullava_tpu_torch import eval_ullava, train_ullava, train_ullava_core
from ullava_tpu_torch.bridge import params_from_jax
from ullava_tpu_torch.config import Config
from ullava_tpu_torch.models import build
from ullava_tpu_torch.models import llama
from ullava_tpu_torch.parallel.sharding import unshard
from ullava_tpu_torch.training import checkpoint, optim
from ullava_tpu_torch.training import trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 28, 64  # short side = CLIP's 28, long side = the tiny SAM's 64


def setup_module():
    torch.set_num_threads(1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _save_image(path, rng):
    Image.fromarray(rng.integers(0, 256, (H, W, 3), np.uint8)).save(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("clis")
    img = root / "images"
    img.mkdir()
    rng = np.random.default_rng(0)
    for i in range(6):
        _save_image(img / f"r{i}.{'png' if i % 2 else 'jpg'}", rng)
        _save_image(img / f"c{i}.png", rng)
    res = [{"image_path": f"r{i}.{'png' if i % 2 else 'jpg'}",
            "segmentation": [[3, 2, 40, 4, 44, 20, 6, 24]] if i % 3 else
                            [[2, 2, 20, 2, 20, 12, 2, 12], [30, 10, 60, 10, 60, 26, 30, 26]],
            "category": "Widget", "bbox": [3, 2, 41, 22], "height": H, "width": W,
            "sentences": [f"widget {i}", f"the thing {i}"][: 1 + i % 2]} for i in range(6)]
    with open(root / "res.jsonl", "w") as f:
        for a in res:
            f.write(json.dumps(a) + "\n")
    (root / "SEG.json").write_text(json.dumps(
        ["<image> Where is the <class> ?", "<image> Segment the <class> .",
         "<image> Find <class> here ."]))
    chat = [{"image": f"c{i}.png", "conversations": [
        {"from": "human", "value": "<image>\nDescribe ."},
        {"from": "gpt", "value": f"Thing {i} is here ."}]} for i in range(6)]
    (root / "chat.json").write_text(json.dumps(chat))

    # One JAX-built stage-2 tree in fp32, saved in both layouts.
    _, params = jbuild.build_ullava({"conv_type": "conv_sep2"}, _tokenizer(),
                                    dtype=jnp.float32, rng=jax.random.PRNGKey(5))
    params = _np(params)
    jckpt.save_checkpoint(str(root / "jax"), 1, params)
    tree = params_from_jax(params, device="cpu")
    checkpoint.save_checkpoint(str(root / "port"), 1, tree)
    # The stage-1 tree: the core of the same build.
    jckpt.save_checkpoint(str(root / "jax_core"), 1, params["core"])
    checkpoint.save_checkpoint(str(root / "port_core"), 1, tree["core"])
    return root


def _tokenizer():
    tok = ToyLlamaTokenizer(model_max_length=128)
    tok.add_tokens(MM_TOKENS)
    return tok


def _res_set(root):
    return {"data_type": "image", "image_token_len": 4, "sam_image_size": 64,
            "vis_processor": "clip_image",
            "build_info": {"anno_dir": str(root / "res.jsonl"), "image_dir": str(root / "images"),
                           "template_root": str(root / "SEG.json")}}


def _training(out_dir, **kw):
    return {"output_dir": str(out_dir), "learning_rate": 1e-3, "model_max_length": 128,
            "per_device_train_batch_size": 2, "num_train_epochs": 1, "logging_steps": 1,
            "save_steps": 100, "dataloader_num_workers": 1, "warmup_ratio": 0.0, **kw}


def _stage2_dict(root, ckpt, out_dir, lora):
    model = {"arch": "ullava", "conv_type": "conv_sep2", "projector_from_scratch": False,
             "quantize": "int8_towers", "pretrained_ullava": str(ckpt)}
    if lora:
        model.update(lora_r=4, lora_alpha=8)
    return {"model": model,
            "task": {"type": "image_text_pretrain", "collator_type": "grounding_collator"},
            "processor": {"clip_image": {"image_size": 28}},
            "dataset": {"refcoco": _res_set(root)},
            "eval_dataset": {"refcoco_val": _res_set(root)},
            "training": _training(out_dir, evaluation_strategy="epoch")}


def _lora_a(shape_l_d_r):
    return (0.2 * np.random.default_rng(17).standard_normal(shape_l_d_r)).astype(np.float32)


def _default_dtype(fn, dtype):
    @functools.wraps(fn)
    def wrapped(model_cfg, tokenizer, dt=dtype, *args, **kw):
        return fn(model_cfg, tokenizer, kw.pop("dtype", dt), *args, **kw)
    return wrapped


@pytest.fixture
def same_start(monkeypatch):
    """fp32 builds, numpy LoRA A factors and the port's adapter pattern
    on both sides; each package's Trainer records its steps' losses and
    gradient norms and its per-epoch evals."""
    for module, dtype in ((jbuild, jnp.float32), (build, torch.float32)):
        for name in ("build_ullava", "build_ullava_core"):
            monkeypatch.setattr(module, name, _default_dtype(getattr(module, name), dtype))
    # The JAX CLIs on one device, as the port's on one card.
    monkeypatch.setattr(jparallel, "make_mesh",
                        functools.partial(jparallel.make_mesh, devices=jax.devices()[:1]))

    j_add, p_add = jllama.add_lora, llama.add_lora

    def jax_lora(params, cfg, rng, r=8, targets=("q_proj", "v_proj")):
        out = j_add(params, cfg, rng, r=r, targets=targets)
        for name in targets:
            a = out["layers"][f"{name}_lora_a"]
            out["layers"][f"{name}_lora_a"] = jnp.asarray(_lora_a(a.shape), a.dtype)
        return out

    def port_lora(params, cfg, generator=None, r=8, targets=("q_proj", "v_proj")):
        out = p_add(params, cfg, generator, r=r, targets=targets)
        for name in targets:
            k = f"{name}_lora_a"
            draw = _lora_a((len(out["layers"]),) + tuple(out["layers"][0][k].shape))
            for i, lp in enumerate(out["layers"]):
                lp[k] = torch.as_tensor(draw[i], dtype=lp[k].dtype)
        return out

    monkeypatch.setattr(jllama, "add_lora", jax_lora)
    monkeypatch.setattr(llama, "add_lora", port_lora)
    monkeypatch.setattr(joptim, "STAGE2_LORA", optim.STAGE2_LORA)

    logs = {"jax": {"loss": [], "grad_norm": [], "eval": []},
            "port": {"loss": [], "grad_norm": [], "eval": []}}

    def recording(base, log):
        class Recording(base):
            def __init__(self, *, step_fn, eval_fn=None, **kw):
                def step(state, batch):
                    state, m = step_fn(state, batch)
                    log["loss"].append(float(np.asarray(m["loss"])))
                    log["grad_norm"].append(float(np.asarray(m["grad_norm"])))
                    return state, m

                def evaluate(params):
                    res = eval_fn(params)
                    log["eval"].append(res)
                    return res

                super().__init__(step_fn=step, eval_fn=eval_fn and evaluate, **kw)
        return Recording

    monkeypatch.setattr(jtrainer, "Trainer", recording(jtrainer.Trainer, logs["jax"]))
    monkeypatch.setattr(trainer, "Trainer", recording(trainer.Trainer, logs["port"]))
    return logs


def _metrics_close(got, ref):
    assert set(got) == set(ref)
    for name in ref:
        for k in ("ciou", "giou", "prec@0.5"):
            np.testing.assert_allclose(got[name][k], ref[name][k], rtol=0, atol=1e-4, err_msg=k)
        assert got[name]["n_masks"] == ref[name]["n_masks"] > 0
        assert got[name]["n_boxes"] == ref[name]["n_boxes"] > 0


@pytest.mark.parametrize("lora", [True, False], ids=["lora", "full_llm"])
def test_train_ullava_matches_jax(files, same_start, tmp_path, lora):
    """Three stage-2 steps (6 RES items at B=2) and the per-epoch eval."""
    jstate = jtrain_cli.train(
        JConfig(cfg_dict=_stage2_dict(files, files / "jax/checkpoint-1", tmp_path / "j", lora)),
        tokenizer=_tokenizer())
    state = train_ullava.train(
        Config(cfg_dict=_stage2_dict(files, files / "port/checkpoint-1", tmp_path / "p", lora)),
        tokenizer=_tokenizer(), device="cpu")
    assert int(jstate.step) == state.step == 3
    j, p = same_start["jax"], same_start["port"]
    np.testing.assert_allclose(p["loss"], j["loss"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(p["grad_norm"], j["grad_norm"], rtol=1e-5, atol=1e-5)
    assert len(j["eval"]) == len(p["eval"]) == 1
    _metrics_close(p["eval"][0], j["eval"][0])
    assert os.path.isdir(tmp_path / "p" / "checkpoint-3")


def test_eval_ullava_matches_jax_and_reads_a_training_checkpoint(files, same_start, tmp_path):
    """`evaluate` from the shared starting parameters; then the port's
    from a checkpoint its own trainer wrote (int8 towers and adapters),
    which gives the trainer's own per-epoch eval exactly."""
    ref = jeval_cli.evaluate(
        JConfig(cfg_dict=_stage2_dict(files, files / "jax/checkpoint-1", tmp_path / "je", True)),
        tokenizer=_tokenizer(), max_samples=4)
    got = eval_ullava.evaluate(
        Config(cfg_dict=_stage2_dict(files, files / "port/checkpoint-1", tmp_path / "pe", True)),
        tokenizer=_tokenizer(), max_samples=4, device="cpu")
    _metrics_close(got, ref)
    assert json.loads((tmp_path / "pe" / "refcoco_val.json").read_text()) == got["refcoco_val"]

    tok = _tokenizer()
    cfg = _stage2_dict(files, files / "port/checkpoint-1", tmp_path / "pt", True)
    train_ullava.train(Config(cfg_dict=cfg), tokenizer=tok, device="cpu")
    cfg["model"]["pretrained_ullava"] = str(tmp_path / "pt" / "checkpoint-3")
    again = eval_ullava.evaluate(Config(cfg_dict=cfg), tokenizer=tok, device="cpu")
    assert again == same_start["port"]["eval"][-1]


def _stage1_dict(files, ckpt, out, **training):
    return {"model": {"arch": "ullava_core", "conv_type": "conv_simple",
                      "projector_from_scratch": True, "pretrained_core": str(ckpt)},
            "task": {"type": "image_text_pretrain", "collator_type": "image_video_collator"},
            "processor": {"clip_image": {"image_size": 28}},
            "dataset": {"llava_cc3m": {
                "data_type": "image", "image_token_len": 4, "vis_processor": "clip_image",
                "build_info": {"anno_dir": str(files / "chat.json"),
                               "image_dir": str(files / "images")}}},
            "training": _training(out, **training)}


def test_train_ullava_core_matches_jax(files, same_start, tmp_path):
    """Three stage-1 pretraining steps on the chat set (6 items at B=2)."""
    def cfg(ckpt, out):
        return _stage1_dict(files, ckpt, out)

    jstate = jcore_cli.train(JConfig(cfg_dict=cfg(files / "jax_core/checkpoint-1", tmp_path / "j")),
                             tokenizer=_tokenizer())
    state = train_ullava_core.train(Config(cfg_dict=cfg(files / "port_core/checkpoint-1",
                                                        tmp_path / "p")),
                                    tokenizer=_tokenizer(), device="cpu")
    assert int(jstate.step) == state.step == 3
    j, p = same_start["jax"], same_start["port"]
    np.testing.assert_allclose(p["loss"], j["loss"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(p["grad_norm"], j["grad_norm"], rtol=1e-5, atol=1e-5)
    # The trainer's checkpoint as `pretrained_core`: the trained params
    # (the CLI's state is sharded over its mesh of one rank).
    _, params = build.build_ullava_core(
        {**cfg("", "")["model"], "pretrained_core": str(tmp_path / "p" / "checkpoint-3")},
        _tokenizer(), device="cpu")
    for (name, t), (_, ref) in zip(optim.named_leaves(params),
                                   optim.named_leaves(unshard(state.params["core"])),
                                   strict=True):
        assert torch.equal(t, ref), name


class _Events(trainer.TrainerCallback):
    def __init__(self):
        self.events = []

    def on_train_begin(self, state):
        self.events.append(("train", state.step))

    def on_epoch_begin(self, epoch, start_batch):
        self.events.append(("epoch", epoch, start_batch))

    def on_step_begin(self, state, batch):
        self.events.append(("step", state.step, tuple(batch["input_ids"].shape)))

    def on_step_end(self, state, batch, metrics):
        self.events.append(("stepped", state.step, float(metrics["loss"])))


def test_cli_callbacks_see_the_loop_and_the_resume(files, same_start, tmp_path):
    """`train_ullava_core.train(..., callbacks=)`: the trainer's events in
    order, one epoch of 3 steps, then the same output dir for two epochs:
    the resumed loop begins at step 3 and asks for epoch 1 from batch 0
    only (fp32 builds, as `same_start` makes them)."""
    runs = []
    for epochs in (1, 2):
        cb = _Events()
        state = train_ullava_core.train(
            Config(cfg_dict=_stage1_dict(files, files / "port_core/checkpoint-1",
                                         tmp_path / "p", num_train_epochs=epochs)),
            tokenizer=_tokenizer(), device="cpu", callbacks=[cb])
        assert state.step == 3 * epochs
        runs.append(cb.events)
    for events, first in zip(runs, (0, 3)):
        steps = [e for e in events if e[0] == "step"]
        stepped = [e for e in events if e[0] == "stepped"]
        assert events[:2] == [("train", first), ("epoch", first // 3, 0)]
        assert [e[1] for e in steps] == [first, first + 1, first + 2]
        assert [e[1] for e in stepped] == [first + 1, first + 2, first + 3]
        assert all(e[2][0] == 2 for e in steps) and all(np.isfinite(e[2]) for e in stepped)
        assert [e[0] for e in events[2:]] == ["step", "stepped"] * 3


def test_train_ullava_cli_subprocess(files, tmp_path):
    """`python -m ullava_tpu_torch.train_ullava --device cpu` as a user runs
    it: a fast tokenizer and a tiny LLaMA and CLIP in HF checkpoint dirs
    (SAM random), the YAML, the whole entry path."""
    transformers = pytest.importorskip("transformers")
    from tokenizers import Tokenizer, models, pre_tokenizers

    torch.manual_seed(0)
    llm_dir, vis_dir = tmp_path / "llm", tmp_path / "vis"
    transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=64, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=256,
    )).save_pretrained(llm_dir)
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2, "[PAD]": 3}
    for w in ("Where", "is", "the", "widget", "thing", "?", "Sure", ".", "Mask", ":", ";",
              "Location", "0", "1", "2", "3", "4", "5"):
        vocab[w] = len(vocab)
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, unk_token="<unk>", bos_token="<s>", eos_token="</s>",
        pad_token="[PAD]").save_pretrained(llm_dir)
    transformers.CLIPVisionModel(transformers.CLIPVisionConfig(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
        image_size=28, patch_size=14)).save_pretrained(vis_dir)

    cfg = _stage2_dict(files, "", tmp_path / "exp", True)
    cfg["model"].update(llm_path=str(llm_dir), vision_encoder=str(vis_dir))
    del cfg["model"]["pretrained_ullava"]
    cfg["training"]["evaluation_strategy"] = "no"
    import yaml

    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    env = {**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run(
        [sys.executable, "-m", "ullava_tpu_torch.train_ullava", "--cfg_path", str(cfg_path),
         "--device", "cpu"],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "training complete at step 3" in res.stderr
    assert os.path.isdir(tmp_path / "exp" / "checkpoint-3")
    # Without --device the CLI asks for the card, which this machine lacks.
    res = subprocess.run(
        [sys.executable, "-m", "ullava_tpu_torch.train_ullava", "--cfg_path", str(cfg_path)],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert res.returncode != 0 and "CUDA" in res.stderr
