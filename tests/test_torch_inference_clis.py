"""The port's inference CLIs (`ullava_tpu_torch.inference_ullava_core`,
`ullava_tpu_torch.inference_ullava`) against the root scripts of the JAX
package, greedy, on tiny models built by both from the same checkpoint:
one JAX-built tree saved by orbax for the JAX build and in the port's
layout for the port's (`pretrained_core` / `pretrained_ullava`).

The stage-2 tree is set up so that greedy decoding answers with [SEG] and
[LOC] in turn: two residual lanes that no layer writes carry "the current
token is [SEG]" and "it is not", and lm_head reads them. So masks and
boxes are decoded. The text is the same as JAX's; the binarized masks
agree with JAX's on at least 99% of pixels (the CLIP and SAM inputs
differ by the resize, `tests/test_torch_image_ops.py`); the boxes lie
within 1e-3 of the image size of JAX's.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from toy_tokenizer import ToyLlamaTokenizer
from ullava_tpu.config import Config as JConfig
from ullava_tpu.constants import MM_TOKENS, STAGE2_TOKENS
from ullava_tpu.models import build as jbuild
from ullava_tpu.training import checkpoint as jckpt
from ullava_tpu_torch import inference_ullava, inference_ullava_core
from ullava_tpu_torch.bridge import params_from_jax
from ullava_tpu_torch.config import Config
from ullava_tpu_torch.models import build  # registers the archs
from ullava_tpu_torch.training import checkpoint

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import inference_ullava as jinference_ullava  # noqa: E402
import inference_ullava_core as jinference_ullava_core  # noqa: E402

H, W = 48, 64
D0, D1, BIG = 5, 9, 30.0


def setup_module():
    torch.set_num_threads(1)


def _tok():
    tok = ToyLlamaTokenizer(model_max_length=256)
    tok.add_tokens(MM_TOKENS)
    tok.add_tokens(STAGE2_TOKENS)
    return tok


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_layout(tree):
    """`bridge` of a JAX tree: every leaf."""
    return params_from_jax(tree, device="cpu")


def _seg_loc_in_turn(params, seg, loc):
    """Greedy decoding answers [SEG] after any token but [SEG], and [LOC]
    after [SEG]: lane D0 holds BIG for every token but [SEG], lane D1 for
    [SEG]; no layer writes either lane, and lm_head maps D0 to [SEG], D1
    to [LOC]."""
    llm = params["core"]["llm"]
    emb = np.array(llm["embed_tokens"], np.float32)
    emb[:, D0], emb[:, D1] = BIG, 0.0
    emb[seg, D0], emb[seg, D1] = 0.0, BIG
    llm["embed_tokens"] = emb.astype(llm["embed_tokens"].dtype)
    head = np.array(llm["lm_head"], np.float32)
    head[[D0, D1]] = 0.0
    head[D0, seg], head[D1, loc] = 5.0, 5.0
    llm["lm_head"] = head.astype(llm["lm_head"].dtype)
    for name in ("o_proj", "down_proj"):
        w = np.array(llm["layers"][name])
        w[..., [D0, D1]] = 0
        llm["layers"][name] = w
    return params


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    _, core = jbuild.build_ullava_core({}, _tok(), rng=jax.random.PRNGKey(1))
    _, full = jbuild.build_ullava({}, _tok(), rng=jax.random.PRNGKey(2))
    tok = _tok()
    full = _seg_loc_in_turn(_np(full), tok.convert_tokens_to_ids("[SEG]"),
                            tok.convert_tokens_to_ids("[LOC]"))
    out = {}
    for name, tree in (("core", _np(core)), ("full", full)):
        jckpt.save_checkpoint(str(root / name / "jax"), 1, tree)
        checkpoint.save_checkpoint(str(root / name / "port"), 1, _port_layout(tree))
        out[name] = {pkg: str(root / name / pkg / "checkpoint-1") for pkg in ("jax", "port")}
    rng = np.random.default_rng(0)
    image = _smooth_image(rng)
    out["image"] = image
    out["image_path"] = str(root / "img.png")
    Image.fromarray(image).save(out["image_path"])
    return out


def _smooth_image(rng):
    yy, xx = np.mgrid[0:H, 0:W]
    base = np.stack([128 + 90 * np.sin(xx / 6.0 + c) * np.cos(yy / 4.0) for c in range(3)], -1)
    return np.clip(base + rng.normal(0, 8, base.shape), 0, 255).astype(np.uint8)


def _cfgs(arch, ckpt, **knobs):
    key = "pretrained_core" if arch == "ullava_core" else "pretrained_ullava"
    conv = "conv_simple" if arch == "ullava_core" else "conv_sep2"
    rest = {"task": {"type": "image_text_evaluate"}, "processor": {}, "training": {}}
    j = JConfig(cfg_dict={"model": {"arch": arch, "conv_type": conv, key: ckpt["jax"], **knobs},
                          **rest})
    t = Config(cfg_dict={"model": {"arch": arch, "conv_type": conv, key: ckpt["port"], **knobs},
                         **rest})
    return j, t


def test_core_chat_text_matches_jax(ckpts):
    jcfg, cfg = _cfgs("ullava_core", ckpts["core"])
    ref = jinference_ullava_core.eval_model(jcfg, ckpts["image_path"], "Describe the image .",
                                           temperature=0.0, max_new_tokens=8, tokenizer=_tok())
    chat = inference_ullava_core.CoreChat(cfg, tokenizer=_tok(), device="cpu")
    got = chat.ask(ckpts["image_path"], "Describe the image .", temperature=0.0, max_new_tokens=8)
    assert got == ref and len(got.split()) >= 4
    # The session answers again without a rebuild, from an array as well.
    assert chat.ask(ckpts["image"], "Describe the image .", 0.0, None, 8) == ref
    assert inference_ullava_core.eval_model(cfg, ckpts["image"], "Describe the image .",
                                            temperature=0.0, max_new_tokens=8, tokenizer=_tok(),
                                            device="cpu") == ref


@pytest.mark.parametrize("knobs", [{}, {"quantize": "int8", "kv_cache": "int8"}],
                         ids=["plain", "int8"])
def test_run_once_matches_jax(ckpts, knobs, tmp_path):
    jcfg, cfg = _cfgs("ullava", ckpts["full"], **knobs)
    ref = jinference_ullava.run_once(jcfg, ckpts["image_path"], "Segment the widget .",
                                     temperature=0.0, max_new_tokens=6, save_dir=None,
                                     tokenizer=_tok())
    save_dir = tmp_path / "vis"
    got = inference_ullava.run_once(cfg, ckpts["image_path"], "Segment the widget .",
                                    temperature=0.0, max_new_tokens=6, save_dir=str(save_dir),
                                    tokenizer=_tok(), device="cpu")
    assert got["text"] == ref["text"] == "[SEG] [LOC] [SEG] [LOC] [SEG] [LOC]"
    assert len(got["masks"]) == len(ref["masks"]) == 3
    for g, r in zip(got["masks"], ref["masks"]):
        assert g.shape == r.shape == (H, W) and g.dtype == np.uint8
        assert (g == r).mean() >= 0.99
    assert 0 < sum(int(m.sum()) for m in got["masks"]) < 3 * H * W  # not all one value
    assert len(got["boxes"]) == len(ref["boxes"]) == 3
    np.testing.assert_allclose(np.asarray(got["boxes"]), np.asarray(ref["boxes"]),
                               atol=1e-3 * max(H, W), rtol=0)
    names = sorted(p.name for p in save_dir.iterdir())
    assert names == ["bbox.png", "mask_0.png", "mask_1.png", "mask_2.png",
                     "overlay_0.png", "overlay_1.png", "overlay_2.png"]
    # The array form gives the same answer as the decoded file.
    again = inference_ullava.run_once(cfg, ckpts["image"], "Segment the widget .",
                                      temperature=0.0, max_new_tokens=6, tokenizer=_tok(),
                                      device="cpu")
    assert again["text"] == got["text"]
    for a, g in zip(again["masks"], got["masks"]):
        np.testing.assert_array_equal(a, g)


def test_cli_main_on_cpu(ckpts, tmp_path, capsys, monkeypatch):
    """`python -m ullava_tpu_torch.inference_ullava ... --device cpu`: the
    flags of the root script and the port's device flag (the toy tokenizer
    stands in for the checkpoint's)."""
    yaml = pytest.importorskip("yaml")
    monkeypatch.setattr(build, "build_tokenizer", lambda path: _tok())
    _, cfg = _cfgs("ullava", ckpts["full"])
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    inference_ullava.main(["--cfg_path", str(path), "--image", ckpts["image_path"],
                           "--query", "Segment it .", "--temperature", "0", "--max_new_tokens", "2",
                           "--save_dir", str(tmp_path / "vis"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "ASSISTANT:" in out and "1 masks, 1 boxes" in out


def test_image_must_be_uint8_rgb():
    with pytest.raises(ValueError):
        inference_ullava_core.load_image(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError):
        inference_ullava_core.load_image(np.zeros((4, 4, 3), np.float32))
