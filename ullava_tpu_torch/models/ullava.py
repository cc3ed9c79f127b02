"""u-LLaVA stage-2 serving: core MLLM + SAM seg head + box head
(counterpart of `ullava_tpu/models/ullava.py:38-81,207-255`; the training
forward and losses wait).

`evaluate` generates greedily, reads the hidden states that produced each
[SEG]/[LOC] token (up to `max_masks`/`max_boxes` per sample, with
validity masks), projects them, encodes the SAM image and decodes one
low-res mask per [SEG] slot.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ullava_tpu_torch import resolve_device
from ullava_tpu_torch.constants import DEFAULT_LOC_TOKEN_IDX, DEFAULT_SEG_TOKEN_IDX
from ullava_tpu_torch.models import generate as gen_mod
from ullava_tpu_torch.models import projector, ullava_core
from ullava_tpu_torch.models.sam import build as sam_build
from ullava_tpu_torch.models.sam import image_encoder as sam_image_encoder
from ullava_tpu_torch.ops import quant

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class UllavaConfig:
    core: ullava_core.UllavaCoreConfig = dataclasses.field(
        default_factory=ullava_core.UllavaCoreConfig
    )
    sam: sam_build.SamConfig = dataclasses.field(default_factory=sam_build.SamConfig)
    seg_token_idx: int = DEFAULT_SEG_TOKEN_IDX
    loc_token_idx: int = DEFAULT_LOC_TOKEN_IDX
    out_dim: int = 256
    max_masks: int = 3
    max_boxes: int = 3

    @classmethod
    def tiny(cls, **kw) -> "UllavaConfig":
        defaults = dict(
            core=ullava_core.UllavaCoreConfig.tiny(),
            sam=sam_build.SamConfig.tiny(),
            seg_token_idx=154,
            loc_token_idx=155,
            out_dim=16,
        )
        defaults.update(kw)
        return cls(**defaults)


def init_params(
    cfg: UllavaConfig, generator: Optional[torch.Generator] = None, device=None
) -> Params:
    device = resolve_device(device)
    gen = generator or torch.Generator(device=device).manual_seed(0)
    D = cfg.core.llm.hidden_size
    return {
        "core": ullava_core.init_params(cfg.core, gen, device),
        "sam": sam_build.init_sam_params(cfg.sam, gen, device),
        "seg_projector": projector.init_text_head(gen, D, cfg.out_dim, device=device),
        "det_projector": projector.init_text_head(gen, D, cfg.out_dim, device=device),
        "det_decoder": projector.init_box_decoder(gen, cfg.out_dim, device=device),
    }


def quantize_llm(params: Params) -> Params:
    """Replace the LLM's linear weights (`LLAMA_QUANT_KEYS`) by int8
    leaves, in `params` itself, so that the full-precision copies can be
    freed. Serve the result with `LlamaConfig(a8_prefill=True,
    kv_quant=True)`; CLIP and SAM keep their weights (`quantize_towers`
    does theirs)."""
    params["core"]["llm"] = quant.quantize_tree(params["core"]["llm"], quant.LLAMA_QUANT_KEYS)
    return params


def quantize_towers(params: Params) -> Params:
    """Replace the linear weights of the SAM image encoder
    (`SAM_ENCODER_QUANT_KEYS`) and of the CLIP tower (`CLIP_QUANT_KEYS`)
    by int8 leaves, in `params` itself. CLIP then runs weight-only int8.
    Serve the SAM encoder with `SamVisionConfig(mlp_w8a8=True)`: its MLPs
    and its projections take the fused int8 kernels (the window blocks'
    in the resident layout). The prompt encoder and the mask decoder keep
    their weights."""
    sam = params["sam"]
    sam["image_encoder"] = quant.quantize_tree(sam["image_encoder"], quant.SAM_ENCODER_QUANT_KEYS)
    params["core"]["vision"] = quant.quantize_tree(params["core"]["vision"], quant.CLIP_QUANT_KEYS)
    return params


def precompute_window_bias_weights(params: Params, cfg: UllavaConfig) -> Params:
    """Give the SAM encoder's window blocks their composite rel-pos bias
    weights (`sam/image_encoder.precompute_window_bias_weights`), in
    `params` itself. Call it after `quantize_towers`: the resident window
    layout then emits the bias terms from its fused LN1+qkv."""
    sam = params["sam"]
    sam["image_encoder"] = sam_image_encoder.precompute_window_bias_weights(
        sam["image_encoder"], cfg.sam.vision
    )
    return params


def get_visual_embs(params: Params, cfg: UllavaConfig, images_sam: torch.Tensor) -> torch.Tensor:
    """SAM image embeddings [B, g, g, 256]."""
    return sam_image_encoder.encode(params["sam"]["image_encoder"], cfg.sam.vision, images_sam)


@torch.no_grad()
def evaluate(
    params: Params,
    cfg: UllavaConfig,
    gen_cfg: gen_mod.GenerateConfig,
    *,
    input_ids: torch.Tensor,  # [B, S] right-padded
    prompt_lens: torch.Tensor,  # [B]
    images: torch.Tensor,  # [B, 224, 224, 3] CLIP input
    images_sam: torch.Tensor,  # [B, 1024, 1024, 3] SAM input (normalized, padded)
) -> Dict[str, Any]:
    """Generation + [SEG]/[LOC] decode. Returns low-res masks; callers
    post-process to original sizes on the host."""
    gen_out = gen_mod.generate(
        params["core"], cfg.core, gen_cfg,
        input_ids=input_ids, prompt_lens=prompt_lens, images=images,
    )
    seqs, hidden, lengths = gen_out["sequences"], gen_out["hidden_last"], gen_out["lengths"]

    seg_h, seg_valid = gen_mod.readout_token_hidden(
        seqs, hidden, lengths, cfg.seg_token_idx, cfg.max_masks
    )
    loc_h, loc_valid = gen_mod.readout_token_hidden(
        seqs, hidden, lengths, cfg.loc_token_idx, cfg.max_boxes
    )
    seg_embeds = projector.apply_text_head(params["seg_projector"], seg_h.float())
    loc_embeds = projector.apply_text_head(params["det_projector"], loc_h.float())
    pred_boxes = projector.apply_box_decoder(params["det_decoder"], loc_embeds)

    image_embeddings = get_visual_embs(params, cfg, images_sam)
    low_res_masks, iou_pred = sam_build.forward_masks(
        params["sam"], cfg.sam, image_embeddings, seg_embeds, multimask_output=False
    )
    return {
        "sequences": seqs,
        "lengths": lengths,
        "low_res_masks": low_res_masks,
        "pred_boxes": pred_boxes,
        "seg_valid": seg_valid,
        "loc_valid": loc_valid,
        "iou_pred": iou_pred,
    }
