"""u-LLaVA stage-1 core for serving: CLIP tower + projector + LLaMA
(counterpart of `ullava_tpu/models/ullava_core.py:72-156`; the training
cross-entropy and the video path wait).

`splice_mm_features` is the fixed-shape splice: the N positions after
each sample's `<img_beg>` marker are overwritten with projected CLIP
features; rows without the marker pass through unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ullava_tpu_torch import resolve_device
from ullava_tpu_torch.models import clip_vit, llama, projector

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class UllavaCoreConfig:
    llm: llama.LlamaConfig = dataclasses.field(default_factory=llama.LlamaConfig)
    vision: clip_vit.CLIPVisionConfig = dataclasses.field(
        default_factory=clip_vit.CLIPVisionConfig
    )
    vision_hidden_layer: int = -2  # reference configs use -2
    projector_type: str = "mlp"
    img_start_id: int = -1  # set from the tokenizer vocabulary
    img_end_id: int = -1

    @classmethod
    def tiny(cls, **kw) -> "UllavaCoreConfig":
        defaults = dict(
            llm=llama.LlamaConfig.tiny(vocab_size=160),
            vision=clip_vit.CLIPVisionConfig.tiny(),
            img_start_id=150,
            img_end_id=151,
        )
        defaults.update(kw)
        return cls(**defaults)


def init_params(
    cfg: UllavaCoreConfig, generator: Optional[torch.Generator] = None, device=None
) -> Params:
    device = resolve_device(device)
    gen = generator or torch.Generator(device=device).manual_seed(0)
    return {
        "llm": llama.init_params(cfg.llm, gen, device),
        "vision": clip_vit.init_params(cfg.vision, gen, device),
        "projector": projector.init_vision_projector(
            gen, cfg.vision.hidden_size, cfg.llm.hidden_size, cfg.projector_type,
            dtype=cfg.llm.dtype, device=device,
        ),
    }


def encode_image(params: Params, cfg: UllavaCoreConfig, images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] -> CLIP patch features [B, P, Dv] at the readout layer."""
    out = clip_vit.forward(
        params["vision"], cfg.vision, images, hidden_layer=cfg.vision_hidden_layer
    )
    return out["patch_features"]


def splice_mm_features(
    inputs_embeds: torch.Tensor,  # [B, S, D]
    input_ids: torch.Tensor,  # [B, S]
    feats: torch.Tensor,  # [B, N, D] projected features
    start_id: int,
) -> torch.Tensor:
    B, S, D = inputs_embeds.shape
    N = feats.shape[1]
    is_start = input_ids == start_id
    has = is_start.any(1)
    start = is_start.int().argmax(1)  # first marker (0 if absent; gated by `has`)
    col = torch.arange(S, device=input_ids.device).expand(B, S)
    rel = col - (start[:, None] + 1)
    in_span = (rel >= 0) & (rel < N) & has[:, None]
    idx = rel.clamp(0, N - 1)
    gathered = torch.gather(feats, 1, idx[..., None].expand(B, S, D)).to(inputs_embeds.dtype)
    return torch.where(in_span[..., None], gathered, inputs_embeds)


def embed_multimodal(
    params: Params,
    cfg: UllavaCoreConfig,
    input_ids: torch.Tensor,  # [B, S]
    images: Optional[torch.Tensor] = None,  # [B, H, W, 3]
) -> torch.Tensor:
    """Token embeddings with the image features spliced in."""
    embeds = llama.embed(params["llm"], input_ids).to(cfg.llm.dtype)
    if images is not None:
        feats = projector.apply_vision_projector(
            params["projector"], encode_image(params, cfg, images)
        )
        embeds = splice_mm_features(embeds, input_ids, feats, cfg.img_start_id)
    return embeds
