"""The port's chat backend and web demo (`ullava_tpu_torch.webui`) against
the JAX package's `webui/`, on the CPU.

`Chat.seg` of both packages on one tiny model: the JAX `Chat` builds it,
two residual lanes make greedy decoding answer [SEG] and [LOC] in turn
(`tests/test_torch_inference_clis.py`), and the port's `Chat` takes the
same tree through `bridge.params_from_jax`. At temperature 0, on both
preprocess routes (host, and the canvas through `ops/image_ops`): the
text is equal, at least 99.9% of mask pixels agree and the boxes lie
within 1e-3 of the image's size of JAX's. The demo's arguments, and the
SystemExit that names gradio where it is missing.
"""

import sys

import jax
import numpy as np
import pytest
import torch

from toy_tokenizer import ToyLlamaTokenizer
from ullava_tpu.config import Config as JConfig
from ullava_tpu.constants import MM_TOKENS, STAGE2_TOKENS
from ullava_tpu.models import build as jbuild  # noqa: F401  (registers the archs)
from ullava_tpu_torch.bridge import params_from_jax
from ullava_tpu_torch.config import Config
from ullava_tpu_torch.models import build  # noqa: F401  (registers the archs)
from ullava_tpu_torch.webui import gradio_chat, gradio_web

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parents[1]))

from webui.gradio_chat import Chat as JChat  # noqa: E402


H, W = 48, 64
D0, D1, BIG = 5, 9, 30.0


def setup_module():
    torch.set_num_threads(1)


def _tok():
    tok = ToyLlamaTokenizer(model_max_length=256)
    tok.add_tokens(MM_TOKENS)
    tok.add_tokens(STAGE2_TOKENS)
    return tok


def _seg_loc_in_turn(params, seg, loc):
    """Greedy decoding answers [SEG] after any token but [SEG], and [LOC]
    after [SEG] (`tests/test_torch_inference_clis.py`): lane D0 holds BIG
    for every token but [SEG], lane D1 for [SEG]; no layer writes either
    lane, and lm_head maps D0 to [SEG], D1 to [LOC]."""
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


def _smooth_image(rng):
    yy, xx = np.mgrid[0:H, 0:W]
    base = np.stack([128 + 90 * np.sin(xx / 6.0 + c) * np.cos(yy / 4.0) for c in range(3)], -1)
    return np.clip(base + rng.normal(0, 8, base.shape), 0, 255).astype(np.uint8)


def _cfg_dict():
    return {"model": {"arch": "ullava", "conv_type": "conv_sep2"},
            "task": {"type": "image_text_evaluate"}, "processor": {}, "training": {}}


@pytest.fixture(scope="module")
def chats():
    jchat = JChat(JConfig(cfg_dict=_cfg_dict()), tokenizer=_tok())
    tok = _tok()
    tree = _seg_loc_in_turn(jax.tree_util.tree_map(np.asarray, jchat.params),
                            tok.convert_tokens_to_ids("[SEG]"), tok.convert_tokens_to_ids("[LOC]"))
    jchat.params = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    chat = gradio_chat.Chat(Config(cfg_dict=_cfg_dict()), tokenizer=_tok(), device="cpu")
    chat.params = params_from_jax(tree, device="cpu")
    assert chat.u_cfg.seg_token_idx == jchat.u_cfg.seg_token_idx
    return jchat, chat


@pytest.mark.parametrize("device_preprocess", [False, True], ids=["host", "canvas"])
def test_chat_seg_matches_jax(chats, device_preprocess):
    jchat, chat = chats
    image = _smooth_image(np.random.default_rng(0))
    kw = dict(temperature=0.0, max_new_tokens=6, device_preprocess=device_preprocess)
    ref = jchat.seg(image, "Segment the widget .", **kw)
    got = chat.seg(image, "Segment the widget .", **kw)
    assert got["text"] == ref["text"] == "[SEG] [LOC] [SEG] [LOC] [SEG] [LOC]"
    assert len(got["masks"]) == len(ref["masks"]) == 3
    for g, r in zip(got["masks"], ref["masks"]):
        assert g.shape == r.shape == (H, W) and g.dtype == np.uint8
        assert (g == r).mean() >= 0.999
    assert 0 < sum(int(m.sum()) for m in got["masks"]) < 3 * H * W  # not all one value
    assert len(got["boxes"]) == len(ref["boxes"]) == 3
    np.testing.assert_allclose(np.asarray(got["boxes"]), np.asarray(ref["boxes"]),
                               atol=1e-3 * max(H, W), rtol=0)


def test_chat_runs_on_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the refusal shows only without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        gradio_chat.Chat(Config(cfg_dict=_cfg_dict()), tokenizer=_tok())


def test_gradio_web_arguments_and_missing_gradio(tmp_path, monkeypatch):
    args = gradio_web.parse_args(["--cfg_path", "x.yaml", "--device", "cpu",
                                  "--server_port", "7000"])
    assert (args.cfg_path, args.device, args.server_port, args.server_name) == (
        "x.yaml", "cpu", 7000, "0.0.0.0")
    assert gradio_web.parse_args(["--cfg_path", "x.yaml"]).device is None
    with pytest.raises(SystemExit):
        gradio_web.parse_args([])  # --cfg_path is required
    yaml = pytest.importorskip("yaml")
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(_cfg_dict()))
    monkeypatch.setitem(sys.modules, "gradio", None)  # an import of it fails
    with pytest.raises(SystemExit, match="gradio is not installed"):
        gradio_web.main(["--cfg_path", str(path), "--device", "cpu"])
