"""u-LLaVA stage-2 model: core MLLM + SAM seg head + box head
(counterpart of `ullava_tpu/models/ullava.py`).

`forward` is the multi-task training forward: the frozen SAM image
encoder under `no_grad` (the JAX `stop_gradient`), the core with the
next-token CE, a fixed-shape readout of the hidden state before each
[SEG]/[LOC] token, the seg/det text heads and the box decoder, the SAM
prompt encoder and mask decoder (differentiable), the masks upscaled to
the `mask_loss_frame` and the weighted sum of CE, mask BCE + dice and box
L1 + GIoU losses over the valid slots and pixels (`models/loss.py`).

`evaluate` generates (greedy or sampled, as its `GenerateConfig` says), reads the hidden states that produced each
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
from ullava_tpu_torch.models import loss as L
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
    ce_weight: float = 1.0
    bce_weight: float = 2.0
    dice_weight: float = 0.5
    l1_weight: float = 1.0
    giou_weight: float = 1.0
    max_masks: int = 3
    max_boxes: int = 3
    # Resolution at which the mask losses are taken (the SAM frame's scale).
    mask_loss_frame: int = 1024

    @classmethod
    def tiny(cls, **kw) -> "UllavaConfig":
        defaults = dict(
            core=ullava_core.UllavaCoreConfig.tiny(),
            sam=sam_build.SamConfig.tiny(),
            seg_token_idx=154,
            loc_token_idx=155,
            out_dim=16,
            mask_loss_frame=64,
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
    """SAM image embeddings [B, g, g, 256]; `encode` runs under `no_grad`,
    so the frozen encoder passes no gradient (the JAX `stop_gradient`)."""
    return sam_image_encoder.encode(params["sam"]["image_encoder"], cfg.sam.vision, images_sam)


def _token_readout(
    input_ids: torch.Tensor,  # [B, S]
    hidden: torch.Tensor,  # [B, S, D] final post-norm hidden states
    attn_lens: Optional[torch.Tensor],  # [B]
    token_idx: int,
    max_tokens: int,
):
    """Fixed-shape [SEG]/[LOC] readout: the first `max_tokens` occurrences
    (by position) of `token_idx` at positions 1 .. attn_len - 1 of each
    row; the token at position p reads hidden[p - 1]. Returns (h
    [B, max_tokens, D], valid [B, max_tokens]); empty slots read hidden[0]
    or a later row and are marked invalid."""
    B, S = input_ids.shape
    pos = torch.arange(S, device=input_ids.device).expand(B, S)
    valid = (input_ids == token_idx) & (pos >= 1)
    if attn_lens is not None:
        valid = valid & (pos < attn_lens[:, None])
    key = torch.where(valid, pos, torch.full_like(pos, S + 1))
    order = torch.argsort(key, dim=1, stable=True)[:, :max_tokens]
    picked_valid = torch.gather(valid, 1, order)
    idx = (order - 1).clamp_min(0)[..., None].expand(-1, -1, hidden.shape[-1])
    return torch.gather(hidden, 1, idx), picked_valid


def forward(
    params: Params,
    cfg: UllavaConfig,
    *,
    input_ids: torch.Tensor,  # [B, S]
    labels: Optional[torch.Tensor],  # [B, S] (None at inference)
    attn_lens: torch.Tensor,  # [B]
    images: torch.Tensor,  # [B, 224, 224, 3] CLIP input
    images_sam: torch.Tensor,  # [B, 1024, 1024, 3] SAM input (normalized, padded)
    gt_masks: Optional[torch.Tensor] = None,  # [B, M, F, F] at mask_loss_frame
    mask_valid: Optional[torch.Tensor] = None,  # [B, M] bool
    gt_boxes: Optional[torch.Tensor] = None,  # [B, Nb, 4] pad-normalized xyxy
    box_valid: Optional[torch.Tensor] = None,  # [B, Nb] bool
    input_hw: Optional[torch.Tensor] = None,  # [B, 2] pre-pad resized size
    inference: bool = False,
) -> Dict[str, Any]:
    """The stage-2 forward. Returns the predictions (masks at the loss
    frame and low-res, boxes, slot validity, IoU predictions, the core's
    logits) and, with labels, `loss` = ce + mask (bce + dice) + bbox (l1 +
    giou), each term weighted by the config, and those terms."""
    F = cfg.mask_loss_frame
    image_embeddings = get_visual_embs(params, cfg, images_sam)
    core_out = ullava_core.forward(
        params["core"], cfg.core,
        input_ids=input_ids, labels=labels, images=images, attn_lens=attn_lens,
    )
    hidden = core_out["hidden_states"]

    seg_h, seg_valid = _token_readout(input_ids, hidden, attn_lens, cfg.seg_token_idx,
                                      cfg.max_masks)
    loc_h, loc_valid = _token_readout(input_ids, hidden, attn_lens, cfg.loc_token_idx,
                                      cfg.max_boxes)
    seg_embeds = projector.apply_text_head(params["seg_projector"], seg_h.float())
    loc_embeds = projector.apply_text_head(params["det_projector"], loc_h.float())
    pred_boxes = projector.apply_box_decoder(params["det_decoder"], loc_embeds)

    low_res_masks, iou_pred = sam_build.forward_masks(
        params["sam"], cfg.sam, image_embeddings, seg_embeds, multimask_output=False
    )  # [B, M, 4g, 4g]
    pred_masks = sam_build.upscale_masks_to_frame(low_res_masks, F)

    # Valid-pixel region: the un-padded part of the SAM frame, scaled to F.
    pixel_valid = None
    if input_hw is not None:
        hw = input_hw.float() * (F / cfg.sam.vision.img_size)
        r = torch.arange(F, device=hw.device, dtype=torch.float32)
        pixel_valid = (r[None, :, None] < hw[:, 0, None, None]) & (r[None, None, :] < hw[:, 1, None, None])

    out: Dict[str, Any] = {
        "pred_masks": pred_masks,
        "low_res_masks": low_res_masks,
        "pred_boxes": pred_boxes,
        "seg_valid": seg_valid,
        "loc_valid": loc_valid,
        "iou_pred": iou_pred,
        "logits": core_out["logits"],
    }
    if inference or labels is None:
        return out

    ce_loss = cfg.ce_weight * core_out["loss"]
    m_valid = seg_valid if mask_valid is None else (seg_valid & mask_valid)
    b_valid = loc_valid if box_valid is None else (loc_valid & box_valid)
    gt_m = gt_masks if gt_masks is not None else torch.zeros_like(pred_masks)
    gt_b = gt_boxes if gt_boxes is not None else torch.zeros_like(pred_boxes)

    mask_bce = cfg.bce_weight * L.sigmoid_ce_loss(pred_masks, gt_m, m_valid, pixel_valid)
    mask_dice = cfg.dice_weight * L.dice_loss(pred_masks, gt_m, m_valid, pixel_valid)
    box_l1 = cfg.l1_weight * L.bbox_l1_loss(pred_boxes, gt_b, b_valid)
    box_giou = cfg.giou_weight * L.bbox_giou_loss(pred_boxes, gt_b, b_valid)
    mask_loss = mask_bce + mask_dice
    bbox_loss = box_l1 + box_giou
    out.update(
        loss=ce_loss + mask_loss + bbox_loss,
        ce_loss=ce_loss,
        mask_bce_loss=mask_bce,
        mask_dice_loss=mask_dice,
        mask_loss=mask_loss,
        bbox_loss=bbox_loss,
    )
    return out


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
    generator: Optional[torch.Generator] = None,
) -> Dict[str, Any]:
    """Generation + [SEG]/[LOC] decode. Returns low-res masks; callers
    post-process to original sizes on the host. A sampling `gen_cfg`
    draws from `generator` (the JAX `rng`)."""
    gen_out = gen_mod.generate(
        params["core"], cfg.core, gen_cfg,
        input_ids=input_ids, prompt_lens=prompt_lens, images=images, generator=generator,
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
