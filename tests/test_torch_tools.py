"""The port's host tools (`ullava_tpu_torch.tools`) on the CPU.

- `convert_checkpoint` for `llama`, `clip` and `sam`, on checkpoints the
  test writes (`transformers`' `save_pretrained` dirs, a Meta-named SAM
  `.pth` of the tiny SAM, which stands in for the variant it names): the
  saved leaves bit-equal to the port's direct converter and to the JAX
  package's `load_state_dict` + `convert_*` as numpy; the output restores
  through `training.checkpoint` and, assembled into the core's tree,
  through `model.pretrained_core`.
- `trace_summary` on a `torch.profiler` trace of the CPU: per-op self-times
  sum to the top-level events' total, a nested child is subtracted from
  its parent, `--by-shape`, `-n`, `.gz` and the newest trace of a
  directory, and the JSON line.
"""

import gzip
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toy_tokenizer import ToyLlamaTokenizer
from ullava_tpu.models import weights as jweights
from ullava_tpu.models.sam import build as jsam_build
from ullava_tpu.models.sam import convert as jconvert
from ullava_tpu_torch.bridge import params_from_jax
from ullava_tpu_torch.constants import MM_TOKENS
from ullava_tpu_torch.models import build, tools, weights
from ullava_tpu_torch.models.sam import build as sam_build
from ullava_tpu_torch.models.sam import convert
from ullava_tpu_torch.tools import convert_checkpoint, trace_summary
from ullava_tpu_torch.training import checkpoint

transformers = pytest.importorskip("transformers")


def setup_module():
    torch.set_num_threads(1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_tree_equal(got, ref, path="root"):
    if isinstance(ref, dict):
        assert set(got) == set(ref), (path, sorted(got), sorted(ref))
        for k in ref:
            _assert_tree_equal(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_tree_equal(g, r, f"{path}/{i}")
    else:
        assert got.dtype == ref.dtype and got.shape == ref.shape, (path, got.dtype, ref.dtype)
        assert torch.equal(got, ref), path


@pytest.fixture(scope="module")
def released(tmp_path_factory):
    """The released files: HF LLaMA and CLIP dirs, a Meta-named tiny SAM."""
    root = tmp_path_factory.mktemp("released")
    torch.manual_seed(0)
    transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=128,
    )).save_pretrained(root / "llm")
    transformers.CLIPVisionModel(transformers.CLIPVisionConfig(
        hidden_size=64, intermediate_size=128, num_hidden_layers=3, num_attention_heads=4,
        image_size=28, patch_size=14)).save_pretrained(root / "clip")
    # A Meta-named state dict of the tiny SAM: the HF model of its shapes,
    # renamed by the converter's own key map.
    hf_cfg = transformers.SamConfig(
        vision_config=dict(
            hidden_size=32, num_hidden_layers=4, num_attention_heads=2, image_size=64,
            patch_size=16, window_size=2, global_attn_indexes=[1, 3], output_channels=16,
            mlp_dim=128, num_pos_feats=8),
        prompt_encoder_config=dict(hidden_size=16, image_embedding_size=4, image_size=64,
                                   mask_input_channels=4),
        mask_decoder_config=dict(hidden_size=16, num_attention_heads=2, mlp_dim=32,
                                 iou_head_hidden_dim=16))
    torch.manual_seed(2)
    sd = {k: v.detach().clone() for k, v in transformers.SamModel(hf_cfg).state_dict().items()}
    torch.save(convert.normalize_sam_keys(sd), root / "sam_tiny.pth")
    return root


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_convert_checkpoint_three_kinds(released, tmp_path, monkeypatch, dtype):
    """Each kind through `main`: the saved tree equals the direct
    converter's and the JAX converter's. The SAM variant names the tiny
    SAM here (both packages' `sam_vit_b` patched to it)."""
    tdt, jdt = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    monkeypatch.setattr(sam_build, "sam_vit_b", lambda dtype: sam_build.SamConfig.tiny())
    monkeypatch.setattr(jsam_build, "sam_vit_b", lambda dtype: jsam_build.SamConfig.tiny())
    for kind, src, extra in (("llama", "llm", []), ("clip", "clip", []),
                             ("sam", "sam_tiny.pth", ["--variant", "vit_b"])):
        out = convert_checkpoint.main([kind, str(released / src), str(tmp_path / kind),
                                       "--dtype", dtype, *extra])
        saved = checkpoint.load_saved(out)
        sd = weights.load_state_dict(str(released / src))
        sd_np = jweights.load_state_dict(str(released / src))
        if kind == "llama":
            direct = weights.convert_llama(sd, 2, tdt, device="cpu")
            ref = jweights.convert_llama(sd_np, 2, jdt)
        elif kind == "clip":
            direct = weights.convert_clip_vision(sd, 3, tdt, device="cpu")
            ref = jweights.convert_clip_vision(sd_np, 3, jdt)
        else:
            sd_np = {k: v.numpy() for k, v in sd.items()}
            direct = convert.convert_sam(sd, sam_build.SamConfig.tiny(), tdt, device="cpu")
            ref = jconvert.convert_sam(sd_np, jsam_build.SamConfig.tiny(), jdt)
        _assert_tree_equal(saved, direct)
        _assert_tree_equal(saved, params_from_jax(_np(ref), device="cpu"))
        # `restore_checkpoint` copies the file into a tree of the same structure.
        zeros = jax.tree_util.tree_map(torch.zeros_like, direct)
        _assert_tree_equal(checkpoint.restore_checkpoint(out, zeros), direct)
    with pytest.raises(SystemExit):
        convert_checkpoint.main(["gpt", str(released / "llm"), str(tmp_path / "x")])


def test_converted_trees_load_through_pretrained_core(released, tmp_path):
    """The llama and clip outputs, with the multimodal tokens added as the
    build adds them and the build's projector, saved as one core tree:
    `model.pretrained_core` gives those leaves back."""
    def tok96():  # the released LLaMA's vocabulary size, as its tokenizer has
        tok = ToyLlamaTokenizer(model_max_length=64)
        tok.add_tokens([f"w{i}" for i in range(92)])
        return tok

    tok = tok96()
    llm_out = convert_checkpoint.main(["llama", str(released / "llm"), str(tmp_path / "llm"),
                                       "--dtype", "f32"])
    clip_out = convert_checkpoint.main(["clip", str(released / "clip"), str(tmp_path / "clip"),
                                        "--dtype", "f32"])
    _, params = build.build_ullava_core({}, tok, torch.float32, device="cpu")
    llm, _ = tools.multi_modal_resize_token_embedding(
        build.MM_TOKEN_MAP, tok96(), checkpoint.load_saved(llm_out))
    tree = {"llm": llm, "vision": checkpoint.load_saved(clip_out),
            "projector": params["projector"]}
    ckpt = checkpoint.save_checkpoint(str(tmp_path / "core"), 1, tree)
    _, got = build.build_ullava_core({"pretrained_core": ckpt}, tok, torch.float32,
                                     device="cpu")
    for name in ("lm_head", "norm"):
        assert torch.equal(got["llm"][name], tree["llm"][name]), name
    assert torch.equal(got["llm"]["embed_tokens"], tree["llm"]["embed_tokens"])
    assert torch.equal(got["vision"]["layers"][2]["fc1"], tree["vision"]["layers"][2]["fc1"])
    assert tree["llm"]["embed_tokens"].shape[0] == 96 + len(MM_TOKENS)


# ------------------------------------------------------------ trace_summary


@pytest.fixture(scope="module")
def cpu_trace(tmp_path_factory):
    from torch.profiler import ProfilerActivity, profile

    root = tmp_path_factory.mktemp("trace")
    x = torch.randn(32, 64)
    lin = torch.nn.Linear(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            lin(x).relu().sum()
    path = root / "cpu.json"
    prof.export_chrome_trace(str(path))
    return path


def test_trace_summary_self_times(cpu_trace, tmp_path, capsys):
    ops = trace_summary.load_ops(str(cpu_trace), ("cpu_op",))
    assert ops and not trace_summary.load_ops(str(cpu_trace))  # no device events
    # Top-level events: those inside no other event of their thread.
    top = 0.0
    for e in ops:
        inside = any(o is not e and o["tid"] == e["tid"] and o["ts"] <= e["ts"]
                     and e["ts"] + e["dur"] <= o["ts"] + o["dur"] and o["dur"] >= e["dur"]
                     for o in ops)
        top += 0.0 if inside else e["dur"]
    res = trace_summary.summarize(str(cpu_trace), n=1000, categories=("cpu_op",))
    np.testing.assert_allclose(res["total_ms"] * 1000, top, rtol=1e-9)
    np.testing.assert_allclose(sum(ms for _, ms, _ in res["ops"]), res["total_ms"], rtol=1e-9)
    by_name = {k: (ms, n) for k, ms, n in res["ops"]}
    linear = sum(e["dur"] for e in ops if e["name"] == "aten::linear") / 1000
    assert by_name["aten::linear"][1] == 3
    assert 0 <= by_name["aten::linear"][0] < linear  # its addmm child is subtracted

    # A hand-made device track: a kernel inside another on one stream is
    # nested; the same span on another stream is not.
    evs = [{"ph": "X", "cat": "kernel", "name": "outer", "pid": 0, "tid": 7, "ts": 0, "dur": 10,
            "args": {"grid": [4, 1, 1], "block": [128, 1, 1]}},
           {"ph": "X", "cat": "kernel", "name": "inner", "pid": 0, "tid": 7, "ts": 2, "dur": 3,
            "args": {"grid": [1, 1, 1], "block": [64, 1, 1]}},
           {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0, "tid": 8, "ts": 1,
            "dur": 4},
           {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 1, "ts": 0,
            "dur": 50}]
    d = tmp_path / "dir"
    d.mkdir()
    old = d / "old.json"
    old.write_text(json.dumps({"traceEvents": evs[:1]}))
    os.utime(old, (1, 1))
    with gzip.open(d / "new.json.gz", "wt") as f:
        json.dump({"traceEvents": evs}, f)
    assert trace_summary.find_trace(str(d)) == str(d / "new.json.gz")
    res = trace_summary.main([str(d), "-n", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == res and len(res["ops"]) == 2
    assert res["total_ms"] == pytest.approx(0.014)
    assert res["ops"] == [["outer", pytest.approx(0.007), 1], ["Memcpy HtoD", 0.004, 1]]
    assert lines[1] == "total device self-time: 0.0 ms"
    shape = trace_summary.summarize(str(d / "new.json.gz"), by_shape=True)
    assert shape["ops"][0][0] == "outer: grid [4, 1, 1] block [128, 1, 1]"
    shutil.rmtree(d)
    with pytest.raises(SystemExit, match="no"):
        trace_summary.find_trace(str(tmp_path / "empty_dir_missing"))
