"""The port's checkpoint loading and converters against the JAX package's.

HF LLaMA and CLIP checkpoints are written with `transformers`'
`save_pretrained` (one safetensors file, a sharded safetensors set with
its index, and `.bin`), a tiny SAM state dict in HF naming and in Meta
naming (`.pth`). `load_state_dict` is bit-equal to JAX's (fp32 files: the
JAX loader reads safetensors through numpy, which has no bf16; a bf16
file is held to `safetensors.torch` instead). Each converter is exact
against `bridge.params_from_jax` of the JAX converter on the same state
dict, and a LLaMA built by the port from the checkpoint dirs matches the
HF model's logits at 3e-4, as the JAX package's own test holds its build.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toy_tokenizer import ToyLlamaTokenizer
from ullava_tpu.models import weights as jweights
from ullava_tpu.models.sam import SamConfig as JSamConfig
from ullava_tpu.models.sam import convert as jconvert
from ullava_tpu_torch.bridge import params_from_jax
from ullava_tpu_torch.models import build, llama, weights
from ullava_tpu_torch.models.sam import build as sam_build
from ullava_tpu_torch.models.sam import convert

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
        assert got.is_contiguous(), path
        assert torch.equal(got, ref), path


@pytest.fixture(scope="module")
def hf_llama():
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=128,
        attn_implementation="eager",
    )).eval()


@pytest.fixture(scope="module")
def hf_clip():
    torch.manual_seed(1)
    return transformers.CLIPVisionModel(transformers.CLIPVisionConfig(
        hidden_size=64, intermediate_size=128, num_hidden_layers=3, num_attention_heads=4,
        image_size=28, patch_size=14, attn_implementation="eager",
    )).eval()


@pytest.fixture(scope="module")
def ckpt_dirs(tmp_path_factory, hf_llama, hf_clip):
    root = tmp_path_factory.mktemp("ckpt")
    dirs = {
        "llm": root / "llm", "llm_sharded": root / "llm_sharded", "llm_bin": root / "llm_bin",
        "clip": root / "clip", "llm_bf16": root / "llm_bf16",
    }
    hf_llama.save_pretrained(dirs["llm"])
    hf_llama.save_pretrained(dirs["llm_sharded"], max_shard_size="100KB")
    hf_llama.save_pretrained(dirs["llm_bin"], safe_serialization=False)
    hf_clip.save_pretrained(dirs["clip"])
    copy.deepcopy(hf_llama).to(torch.bfloat16).save_pretrained(dirs["llm_bf16"])
    return dirs


def test_checkpoint_layouts_are_as_named(ckpt_dirs):
    names = {k: sorted(p.name for p in d.iterdir()) for k, d in ckpt_dirs.items()}
    assert "model.safetensors" in names["llm"]
    assert "model.safetensors.index.json" in names["llm_sharded"]
    assert sum(n.endswith(".safetensors") for n in names["llm_sharded"]) > 1
    assert any(n.endswith(".bin") for n in names["llm_bin"])


@pytest.mark.parametrize("which", ["llm", "llm_sharded", "llm_bin", "clip"])
def test_load_state_dict_bit_equal_to_jax(ckpt_dirs, which):
    got = weights.load_state_dict(str(ckpt_dirs[which]))
    ref = jweights.load_state_dict(str(ckpt_dirs[which]))
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_load_bf16_safetensors(ckpt_dirs):
    from safetensors.torch import load_file

    got = weights.load_state_dict(str(ckpt_dirs["llm_bf16"] / "model.safetensors"))
    ref = load_file(str(ckpt_dirs["llm_bf16"] / "model.safetensors"))
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].dtype == torch.bfloat16 and torch.equal(got[k], v), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_llama_and_clip_exact(ckpt_dirs, dtype):
    sd_np = jweights.load_state_dict(str(ckpt_dirs["llm"]))
    sd = weights.load_state_dict(str(ckpt_dirs["llm"]))
    ref = params_from_jax(_np(jweights.convert_llama(sd_np, 2, getattr(jnp, dtype))), device="cpu")
    _assert_tree_equal(weights.convert_llama(sd, 2, getattr(torch, dtype), device="cpu"), ref)

    sd_np = jweights.load_state_dict(str(ckpt_dirs["clip"]))
    sd = weights.load_state_dict(str(ckpt_dirs["clip"]))
    ref = params_from_jax(_np(jweights.convert_clip_vision(sd_np, 3, getattr(jnp, dtype))),
                          device="cpu")
    _assert_tree_equal(weights.convert_clip_vision(sd, 3, getattr(torch, dtype), device="cpu"), ref)


@pytest.fixture(scope="module")
def hf_sam_state_dict():
    hf_cfg = transformers.SamConfig(
        vision_config=dict(
            hidden_size=32, num_hidden_layers=4, num_attention_heads=2, image_size=64,
            patch_size=16, window_size=2, global_attn_indexes=[1, 3], output_channels=16,
            mlp_dim=128, attn_implementation="eager", num_pos_feats=8,
        ),
        prompt_encoder_config=dict(hidden_size=16, image_embedding_size=4, image_size=64,
                                   mask_input_channels=4),
        mask_decoder_config=dict(hidden_size=16, num_attention_heads=2, mlp_dim=32,
                                 iou_head_hidden_dim=16),
    )
    torch.manual_seed(2)
    return {k: v.detach().clone() for k, v in transformers.SamModel(hf_cfg).state_dict().items()}


@pytest.mark.parametrize("naming", ["hf", "meta_pth"])
def test_convert_sam_exact(hf_sam_state_dict, naming, tmp_path):
    sd = hf_sam_state_dict
    if naming == "meta_pth":
        meta = convert.normalize_sam_keys(sd)
        assert meta.keys() == jconvert.normalize_sam_keys(sd).keys()
        path = tmp_path / "sam_tiny.pth"
        torch.save(meta, path)
        sd = weights.load_state_dict(str(path))
        assert not any(k.startswith("vision_encoder.") for k in sd)
    sd_np = {k: v.numpy() for k, v in sd.items()}
    ref = params_from_jax(_np(jconvert.convert_sam(sd_np, JSamConfig.tiny(), jnp.float32)),
                          device="cpu")
    got = convert.convert_sam(sd, sam_build.SamConfig.tiny(), torch.float32, device="cpu")
    # Every prompt-encoder leaf, the point, box and mask prompts' too.
    assert {"point_embeddings", "not_a_point", "mask_conv1", "mask_conv3_bias"} <= set(
        got["prompt_encoder"])
    _assert_tree_equal(got, ref)
    # Every leaf of the port's SAM is read from the checkpoint.
    init = sam_build.init_sam_params(sam_build.SamConfig.tiny(), device="cpu")
    shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), init)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), got) == shapes


def test_built_llama_matches_hf_logits(ckpt_dirs, hf_llama):
    tok = ToyLlamaTokenizer(model_max_length=64)
    cfg, params = build.build_ullava_core(
        {"llm_path": str(ckpt_dirs["llm_sharded"]), "vision_encoder": str(ckpt_dirs["clip"]),
         "vision_hidden_layer": -2, "conv_type": "conv_simple"},
        tok, dtype=torch.float32, device="cpu",
    )
    assert cfg.llm.num_layers == 2 and cfg.vision.num_layers == 3
    assert cfg.llm.vocab_size == 128  # the toy vocabulary fits: nothing grows
    ids = torch.arange(10)[None]
    with torch.no_grad():
        ref = hf_llama(ids).logits.numpy()
        got = llama.forward(params["llm"], cfg.llm, input_ids=ids)["logits"]
    np.testing.assert_allclose(got.numpy()[..., :128], ref, atol=3e-4, rtol=3e-4)
