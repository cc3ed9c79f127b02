"""Model construction from a config and checkpoint files (counterpart of
`ullava_tpu/models/build.py`).

- tokenizer from the LLaMA/Vicuna checkpoint dir, pad token `[PAD]`
  (`transformers` is imported only there);
- LLaMA weights from the HF checkpoint (`llm_path`), the CLIP tower from
  `vision_encoder`, both converted by `models/weights.py`;
- the six multimodal tokens added with their resize rules;
- stage 2: `[SEG] [LOC] [tag] [/tag]`, SAM ViT-H from `sam_path` (Meta or
  HF naming), seg/det heads fresh or from a full checkpoint;
- the serving knobs of `model_cfg`: `kv_cache: int8`, `quantize: int8 |
  int8_towers`, `lora_r` / `lora_alpha`, `pad_vocab_multiple`.

`pretrained_core` / `pretrained_ullava` name a checkpoint directory in the
port's own layout (`checkpoint-*/state.pt`, `training/checkpoint.py`),
not an orbax one: a JAX checkpoint is carried over through `bridge.py`.
Every loader takes a missing path as random init from `generator` (tiny
configs, for tests and dry runs). Parameters are made on `device` (the
card when None).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Any, Dict, Optional, Tuple

import torch

from ullava_tpu_torch import resolve_device
from ullava_tpu_torch.constants import (
    DEFAULT_IMAGE_PATCH_TOKEN,
    DEFAULT_IMG_END_TOKEN,
    DEFAULT_IMG_START_TOKEN,
    DEFAULT_LOC_TOKEN,
    DEFAULT_PAD_TOKEN,
    DEFAULT_SEG_TOKEN,
    DEFAULT_VID_END_TOKEN,
    DEFAULT_VID_START_TOKEN,
    DEFAULT_VIDEO_PATCH_TOKEN,
    STAGE2_TOKENS,
)
from ullava_tpu_torch.models import clip_vit, llama, projector, tools, ullava, ullava_core
from ullava_tpu_torch.models.sam import build as sam_build
from ullava_tpu_torch.models.sam.convert import convert_sam
from ullava_tpu_torch.models.weights import convert_clip_vision, convert_llama, load_state_dict
from ullava_tpu_torch.ops import quant
from ullava_tpu_torch.registry import registry

logger = logging.getLogger(__name__)

MM_TOKEN_MAP = {
    "IMG_PATCH": DEFAULT_IMAGE_PATCH_TOKEN,
    "IMG_START": DEFAULT_IMG_START_TOKEN,
    "IMG_END": DEFAULT_IMG_END_TOKEN,
    "VID_PATCH": DEFAULT_VIDEO_PATCH_TOKEN,
    "VID_START": DEFAULT_VID_START_TOKEN,
    "VID_END": DEFAULT_VID_END_TOKEN,
}


def build_tokenizer(path: Optional[str], model_max_length: int = 1024):
    """HF fast tokenizer from a local checkpoint dir (needs tokenizer.json)."""
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(
        path, model_max_length=model_max_length, use_fast=True, local_files_only=True,
    )
    if tok.pad_token is None:
        tok.add_special_tokens({"pad_token": DEFAULT_PAD_TOKEN})
    return tok


def _hf_config(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def _llama_cfg_from_hf(path: str, dtype) -> llama.LlamaConfig:
    hf = _hf_config(path)
    return llama.LlamaConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        max_position_embeddings=hf.get("max_position_embeddings", 2048),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
        rope_theta=hf.get("rope_theta", 10000.0),
        dtype=dtype,
    )


def _clip_cfg_from_hf(path: str, dtype) -> clip_vit.CLIPVisionConfig:
    hf = _hf_config(path)
    hf = hf.get("vision_config", hf)  # full CLIP vs vision-only checkpoints
    return clip_vit.CLIPVisionConfig(
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        image_size=hf.get("image_size", 224),
        patch_size=hf.get("patch_size", 14),
        layer_norm_eps=hf.get("layer_norm_eps", 1e-5),
        dtype=dtype,
    )


def _restore(path: Optional[str], params: Dict[str, Any]) -> Dict[str, Any]:
    """Overwrite `params` from a checkpoint of the port's layout, if any. A
    leaf comes back at its saved shape, as orbax restores the JAX build's:
    a table that `pad_vocab_multiple` widened after the save comes back at
    its saved width and is padded again."""
    if path and os.path.isdir(path):
        from ullava_tpu_torch.training.checkpoint import restore_checkpoint

        params = restore_checkpoint(path, params, saved_shapes=True)
    return params


def _pad_vocab(model_cfg, llm_params: Dict[str, Any]) -> Dict[str, Any]:
    # model.pad_vocab_multiple (e.g. 128) zero-pads the resized tables; the
    # real vocabulary stays cfg.llm.vocab_size / len(tokenizer), which
    # callers thread into GenerateConfig.vocab_size to mask pad logits.
    pad_mult = int(model_cfg.get("pad_vocab_multiple", 0) or 0)
    if pad_mult > 1:
        llm_params, _ = tools.pad_vocab_to_multiple(llm_params, pad_mult)
    return llm_params


def build_ullava_core(
    model_cfg, tokenizer, dtype=torch.bfloat16,
    generator: Optional[torch.Generator] = None, device=None,
) -> Tuple[ullava_core.UllavaCoreConfig, Dict[str, Any]]:
    """Stage-1 model from a config: (config, params on `device`)."""
    device = resolve_device(device)
    gen = generator or torch.Generator(device=device).manual_seed(0)
    llm_path = model_cfg.get("llm_path")
    vision_path = model_cfg.get("vision_encoder")

    if llm_path and os.path.isdir(llm_path):
        llm_cfg = _llama_cfg_from_hf(llm_path, dtype)
        llm_params = convert_llama(load_state_dict(llm_path), llm_cfg.num_layers, dtype,
                                   device=device)
    else:
        logger.warning("llm_path missing; random-initializing a tiny LLaMA")
        llm_cfg = llama.LlamaConfig.tiny(vocab_size=max(len(tokenizer), 160), attn_impl="auto")
        llm_params = llama.init_params(llm_cfg, gen, device)

    if vision_path and os.path.isdir(vision_path):
        vis_cfg = _clip_cfg_from_hf(vision_path, dtype)
        vis_params = convert_clip_vision(load_state_dict(vision_path), vis_cfg.num_layers, dtype,
                                         device=device)
    else:
        logger.warning("vision_encoder missing; random-initializing a tiny CLIP")
        vis_cfg = clip_vit.CLIPVisionConfig.tiny()
        vis_params = clip_vit.init_params(vis_cfg, gen, device)

    # Multimodal tokens: patch tokens plain, start/end mean-initialized.
    llm_params, mm_ids = tools.multi_modal_resize_token_embedding(
        MM_TOKEN_MAP, tokenizer, llm_params
    )
    llm_cfg = dataclasses.replace(llm_cfg, vocab_size=llm_params["embed_tokens"].shape[0])
    # model.kv_cache: 'int8' stores the decode KV cache quantized.
    if model_cfg.get("kv_cache") == "int8":
        llm_cfg = dataclasses.replace(llm_cfg, kv_quant=True)

    cfg = ullava_core.UllavaCoreConfig(
        llm=llm_cfg,
        vision=vis_cfg,
        vision_hidden_layer=int(model_cfg.get("vision_hidden_layer", -2)),
        projector_type=model_cfg.get("projector_type", "mlp"),
        projector_from_scratch=bool(model_cfg.get("projector_from_scratch", True)),
        img_start_id=mm_ids["IMG_START"],
        img_end_id=mm_ids["IMG_END"],
        vid_start_id=mm_ids["VID_START"],
        vid_end_id=mm_ids["VID_END"],
        n_frm=int(model_cfg.get("n_frm", 8)),
    )
    proj_params = projector.init_vision_projector(
        gen, vis_cfg.hidden_size, llm_cfg.hidden_size, cfg.projector_type,
        dtype=dtype, device=device,
    )
    params = {"llm": llm_params, "vision": vis_params, "projector": proj_params}
    params = _restore(model_cfg.get("pretrained_core"), params)
    params["llm"] = _pad_vocab(model_cfg, params["llm"])
    return cfg, params


def build_ullava(
    model_cfg, tokenizer, dtype=torch.bfloat16,
    generator: Optional[torch.Generator] = None, device=None,
) -> Tuple[ullava.UllavaConfig, Dict[str, Any]]:
    """Stage-2 model from a config: (config, params on `device`)."""
    device = resolve_device(device)
    gen = generator or torch.Generator(device=device).manual_seed(0)
    core_cfg, core_params = build_ullava_core(model_cfg, tokenizer, dtype, gen, device)

    # Stage-2 tokens with mean-init embeddings.
    core_params["llm"], _ = tools.smart_resize_token_embedding(
        STAGE2_TOKENS, tokenizer, core_params["llm"]
    )
    core_cfg = dataclasses.replace(core_cfg, llm=dataclasses.replace(
        core_cfg.llm, vocab_size=core_params["llm"]["embed_tokens"].shape[0]))

    sam_path = model_cfg.get("sam_path")
    if sam_path and os.path.exists(sam_path):
        sam_cfg = sam_build.sam_vit_h(dtype=dtype)
        sam_params = convert_sam(load_state_dict(sam_path), sam_cfg, dtype, device)
    else:
        logger.warning("sam_path missing; random-initializing a tiny SAM")
        sam_cfg = sam_build.SamConfig.tiny()
        sam_params = sam_build.init_sam_params(sam_cfg, gen, device)

    out_dim = sam_cfg.decoder.embed_dim  # 256 for ViT-H
    cfg = ullava.UllavaConfig(
        core=core_cfg,
        sam=sam_cfg,
        seg_token_idx=tokenizer.convert_tokens_to_ids(DEFAULT_SEG_TOKEN),
        loc_token_idx=tokenizer.convert_tokens_to_ids(DEFAULT_LOC_TOKEN),
        out_dim=out_dim,
        ce_weight=float(model_cfg.get("ce_weight", 1.0)),
        bce_weight=float(model_cfg.get("bce_weight", 2.0)),
        dice_weight=float(model_cfg.get("dice_weight", 0.5)),
        l1_weight=float(model_cfg.get("l1_weight", 1.0)),
        giou_weight=float(model_cfg.get("iou_weight", 1.0)),
        mask_loss_frame=min(int(model_cfg.get("mask_loss_frame", 1024)), sam_cfg.vision.img_size),
    )
    D = core_cfg.llm.hidden_size
    params = {
        "core": core_params,
        "sam": sam_params,
        "seg_projector": projector.init_text_head(gen, D, out_dim, device=device),
        "det_projector": projector.init_text_head(gen, D, out_dim, device=device),
        "det_decoder": projector.init_box_decoder(gen, out_dim, device=device),
    }
    params = _restore(model_cfg.get("pretrained_ullava"), params)

    # model.quantize: 'int8' quantizes the SAM image encoder, CLIP and the
    # LLM; 'int8_towers' only the two frozen encoders. Both run
    # weight-only int8 under the config built here.
    quant_mode = model_cfg.get("quantize")
    if quant_mode in ("int8", "int8_towers"):
        params["sam"]["image_encoder"] = quant.quantize_tree(
            params["sam"]["image_encoder"], quant.SAM_ENCODER_QUANT_KEYS)
        params["core"]["vision"] = quant.quantize_tree(
            params["core"]["vision"], quant.CLIP_QUANT_KEYS)
        if quant_mode == "int8":
            params["core"]["llm"] = quant.quantize_tree(
                params["core"]["llm"], quant.LLAMA_QUANT_KEYS)

    lora_r = int(model_cfg.get("lora_r", -1))
    if lora_r > 0:
        scale = float(model_cfg.get("lora_alpha", 16)) / lora_r
        cfg = dataclasses.replace(cfg, core=dataclasses.replace(
            cfg.core, llm=dataclasses.replace(cfg.core.llm, lora_scale=scale)))
        params["core"]["llm"] = llama.add_lora(params["core"]["llm"], cfg.core.llm, gen, r=lora_r)

    params["core"]["llm"] = _pad_vocab(model_cfg, params["core"]["llm"])
    return cfg, params


# Registered arch names: the YAML `model.arch` vocabulary.
@registry.register_model("ullava_core")
class UllavaCoreArch:
    config_cls = ullava_core.UllavaCoreConfig
    build = staticmethod(build_ullava_core)


@registry.register_model("ullava")
class UllavaArch:
    config_cls = ullava.UllavaConfig
    build = staticmethod(build_ullava)
