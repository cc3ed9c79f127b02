"""The port's model build against the JAX package's (`models/build.py`).

Both packages build from the same files: HF LLaMA and CLIP checkpoint dirs
and, for the parts a build draws at random (SAM, the heads, the
projector), a full checkpoint of one JAX-built tree, saved by orbax for
the JAX build and in the port's own layout (`bridge.params_from_jax`,
then `training/checkpoint.py`) for the port's. The configs are equal
field by field, and the parameters equal `bridge` of JAX's leaf for leaf,
through each `quantize` mode, `kv_cache`, `pad_vocab_multiple` (bf16 and
int8 lm_head) and LoRA, whose A factors are the one draw the two make
apart (same shapes and scale; B is zero in both). The LLaMA's vocabulary
of 4 grows with the tokenizer: two noise rows (numpy's generator, as in
JAX) and mean-initialized rows, exact.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from toy_tokenizer import ToyLlamaTokenizer
from ullava_tpu.models import build as jbuild
from ullava_tpu.ops import quant as jquant
from ullava_tpu.training import checkpoint as jckpt
from ullava_tpu_torch.bridge import params_from_jax
from ullava_tpu_torch.models import build
from ullava_tpu_torch.ops import quant
from ullava_tpu_torch.training import checkpoint

transformers = pytest.importorskip("transformers")


def setup_module():
    torch.set_num_threads(1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)




def port_tree(jax_params):
    """`bridge` of a JAX stage-2 (or stage-1) tree: every leaf."""
    return params_from_jax(_np(jax_params), device="cpu")


def _name(v):
    if isinstance(v, torch.dtype):
        return str(v).replace("torch.", "")
    try:
        return np.dtype(v).name
    except TypeError:
        return v


def assert_configs_equal(got, ref, path="cfg"):
    """Every field the JAX config has, the port's has with the same value."""
    for f in dataclasses.fields(ref):
        assert hasattr(got, f.name), f"{path}.{f.name}"
        r, g = getattr(ref, f.name), getattr(got, f.name)
        if dataclasses.is_dataclass(r):
            assert_configs_equal(g, r, f"{path}.{f.name}")
        else:
            assert _name(g) == _name(r), (f"{path}.{f.name}", g, r)


def assert_params_equal(got, ref, path="params", lora_a=None):
    if isinstance(ref, dict):
        assert set(got) == set(ref), (path, sorted(set(got) ^ set(ref)))
        for k in ref:
            assert_params_equal(got[k], ref[k], f"{path}/{k}", lora_a)
    elif isinstance(ref, list):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_params_equal(g, r, f"{path}/{i}", lora_a)
    else:
        assert got.dtype == ref.dtype and got.shape == ref.shape, (path, got.dtype, ref.dtype)
        if path.endswith("_lora_a"):
            lora_a.append((got, ref))
        else:
            assert torch.equal(got, ref), path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("build")
    torch.manual_seed(0)
    transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=4, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=128,
    )).save_pretrained(root / "llm")
    transformers.CLIPVisionModel(transformers.CLIPVisionConfig(
        hidden_size=64, intermediate_size=128, num_hidden_layers=3, num_attention_heads=4,
        image_size=28, patch_size=14,
    )).save_pretrained(root / "clip")
    paths = {"llm_path": str(root / "llm"), "vision_encoder": str(root / "clip")}
    # One JAX-built stage-2 tree, saved in both layouts.
    _, params = jbuild.build_ullava(paths, ToyLlamaTokenizer(), rng=jax.random.PRNGKey(5))
    params = _np(params)
    jckpt.save_checkpoint(str(root / "jax"), 3, params)
    checkpoint.save_checkpoint(str(root / "port"), 3, port_tree(params))
    return {"paths": paths, "jax": str(root / "jax" / "checkpoint-3"),
            "port": str(root / "port" / "checkpoint-3")}


def test_core_from_hf_dirs_with_resized_rows(files):
    """The stage-1 build: the LLaMA and CLIP converted, the vocabulary grown
    from 4 by the multimodal tokens (2 noise rows, then 4 mean rows)."""
    jcfg, jparams = jbuild.build_ullava_core(files["paths"], ToyLlamaTokenizer())
    cfg, params = build.build_ullava_core(files["paths"], ToyLlamaTokenizer(), device="cpu")
    assert_configs_equal(cfg, jcfg)
    assert cfg.llm.vocab_size == 10 and cfg.img_start_id == 6
    ref = params_from_jax(_np(jparams), device="cpu")
    assert_params_equal(params["llm"], ref["llm"])
    assert_params_equal(params["vision"], ref["vision"])
    noise = 0.02 * np.random.default_rng(0).standard_normal((2, 64))
    np.testing.assert_array_equal(params["llm"]["embed_tokens"][4:6].float().numpy(),
                                  torch.tensor(noise, dtype=torch.float32).bfloat16().float())


CASES = {
    "plain": {},
    "kv_cache": {"kv_cache": "int8"},
    "int8": {"quantize": "int8"},
    "int8_towers": {"quantize": "int8_towers"},
    "lora": {"lora_r": 4, "lora_alpha": 8},
    "pad_bf16_head": {"pad_vocab_multiple": 16},
    "pad_int8_head": {"quantize": "int8", "pad_vocab_multiple": 16},
    "all": {"quantize": "int8", "kv_cache": "int8", "lora_r": 4, "pad_vocab_multiple": 16},
}


@pytest.mark.parametrize("case", list(CASES))
def test_build_ullava_matches_jax(files, case):
    knobs = {**files["paths"], **CASES[case], "conv_type": "conv_sep2"}
    jcfg, jparams = jbuild.build_ullava({**knobs, "pretrained_ullava": files["jax"]},
                                        ToyLlamaTokenizer(), rng=jax.random.PRNGKey(9))
    cfg, params = build.build_ullava({**knobs, "pretrained_ullava": files["port"]},
                                     ToyLlamaTokenizer(), device="cpu",
                                     generator=torch.Generator().manual_seed(9))
    assert_configs_equal(cfg, jcfg)
    lora_a = []
    assert_params_equal(params, port_tree(jparams), lora_a=lora_a)

    llm = params["core"]["llm"]
    assert cfg.core.llm.kv_quant == (CASES[case].get("kv_cache") == "int8")
    mode = CASES[case].get("quantize")
    assert quant.is_quantized(llm["layers"][0]["q_proj"]) == (mode == "int8")
    assert quant.is_quantized(params["sam"]["image_encoder"]["window_blocks"][0]["qkv"]) == bool(mode)
    assert quant.is_quantized(params["core"]["vision"]["layers"][0]["fc1"]) == bool(mode)
    if mode:
        q = params["sam"]["image_encoder"]["global_blocks"][0]["proj"]["q"]
        assert q.stride(-2) == 1  # column-major, as the fused kernels require
    head = llm["lm_head"]["q"] if quant.is_quantized(llm["lm_head"]) else llm["lm_head"]
    if "pad_vocab_multiple" in CASES[case]:
        assert llm["embed_tokens"].shape[0] == 16 and head.shape[1] == 16
        # The core pads to 16 before the stage-2 tokens come (as in JAX), so
        # they find their rows already there: the table's size stays 16.
        assert cfg.core.llm.vocab_size == 16
        assert not llm["embed_tokens"][14:].any() and not head[:, 14:].any()
        if quant.is_quantized(llm["lm_head"]):
            assert head.stride(-2) == 1 and (llm["lm_head"]["scale"][..., 14:] == 1).all()
    if "lora_r" in CASES[case]:
        alpha = CASES[case].get("lora_alpha", 16)
        assert cfg.core.llm.lora_scale == alpha / 4 and len(lora_a) == 2 * 2
        for got, ref in lora_a:
            assert abs(got.float().std().item() / ref.float().std().item() - 1) < 0.3
        assert not llm["layers"][1]["v_proj_lora_b"].any()


def test_build_ullava_core_restores_pretrained_core(files, tmp_path):
    """`pretrained_core` restores the port's checkpoint layout over the
    random projector (JAX: the same from orbax)."""
    jcfg, jparams = jbuild.build_ullava_core(files["paths"], ToyLlamaTokenizer())
    jparams = _np(jparams)
    rng = np.random.default_rng(0)
    jparams["projector"] = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(a.dtype), jparams["projector"])
    jckpt.save_checkpoint(str(tmp_path / "j"), 1, jparams)
    checkpoint.save_checkpoint(str(tmp_path / "p"), 1, params_from_jax(jparams, device="cpu"))
    _, jp = jbuild.build_ullava_core({**files["paths"], "pretrained_core": str(tmp_path / "j/checkpoint-1")},
                                     ToyLlamaTokenizer(), rng=jax.random.PRNGKey(3))
    _, p = build.build_ullava_core({**files["paths"], "pretrained_core": str(tmp_path / "p/checkpoint-1")},
                                   ToyLlamaTokenizer(), device="cpu",
                                   generator=torch.Generator().manual_seed(3))
    assert_params_equal(p, params_from_jax(_np(jp), device="cpu"))


def test_random_init_configs_and_shapes_match_jax():
    """No checkpoint paths: tiny models drawn at random. The configs are
    equal and the trees have the same leaves, shapes and dtypes."""
    jcfg, jparams = jbuild.build_ullava({"kv_cache": "int8"}, ToyLlamaTokenizer())
    cfg, params = build.build_ullava({"kv_cache": "int8"}, ToyLlamaTokenizer(), device="cpu")
    assert_configs_equal(cfg, jcfg)
    ref = port_tree(jparams)
    shapes = jax.tree_util.tree_map(lambda t: (t.dtype, tuple(t.shape)), params)
    assert shapes == jax.tree_util.tree_map(lambda t: (t.dtype, tuple(t.shape)), ref)
    assert cfg.core.llm.attn_impl == "auto" and cfg.core.llm.vocab_size == 160
    for name in ("LLAMA_QUANT_KEYS", "SAM_ENCODER_QUANT_KEYS", "CLIP_QUANT_KEYS"):
        assert getattr(quant, name) == getattr(jquant, name)
