"""SAM mask decoder + two-way transformer (counterpart of
`ullava_tpu/models/sam/mask_decoder.py`): iou token + 4 mask tokens,
depth-2 token<->image cross-attention with rate-2 head downsampling,
transposed-conv upscaling written as an einsum, per-token hypernetwork
MLPs and the IoU head. NHWC layout, fp32."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ullava_tpu_torch import resolve_device
from ullava_tpu_torch.models import linear_init, normal
from ullava_tpu_torch.models.projector import apply_mlp
from ullava_tpu_torch.ops.attention import attention_xla
from ullava_tpu_torch.ops.norms import layer_norm

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SamDecoderConfig:
    embed_dim: int = 256
    num_heads: int = 8
    mlp_dim: int = 2048
    depth: int = 2
    attention_downsample_rate: int = 2
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    layer_norm_eps: float = 1e-5  # torch nn.LayerNorm default in the decoder
    dtype: torch.dtype = torch.float32

    @property
    def num_mask_tokens(self) -> int:
        return self.num_multimask_outputs + 1

    @classmethod
    def tiny(cls, **kw) -> "SamDecoderConfig":
        defaults = dict(embed_dim=16, num_heads=2, mlp_dim=32, iou_head_hidden_dim=16)
        defaults.update(kw)
        return cls(**defaults)


def init_params(
    cfg: SamDecoderConfig, generator: Optional[torch.Generator] = None, device=None
) -> Params:
    device = resolve_device(device)
    gen = generator or torch.Generator(device=device).manual_seed(0)
    D, dt = cfg.embed_dim, cfg.dtype

    def lin(i, o):
        return linear_init(gen, i, o, dt, device)

    def attn(down):
        inner = D // cfg.attention_downsample_rate if down else D
        return {"q": lin(D, inner), "k": lin(D, inner), "v": lin(D, inner), "out": lin(inner, D)}

    def ln(n=D):
        return {"scale": torch.ones(n, dtype=dt, device=device),
                "bias": torch.zeros(n, dtype=dt, device=device)}

    def mlp(dims):
        return {f"fc{i}": lin(dims[i], dims[i + 1]) for i in range(len(dims) - 1)}

    return {
        "iou_token": normal(gen, (1, D), dt, device),
        "mask_tokens": normal(gen, (cfg.num_mask_tokens, D), dt, device),
        "layers": [
            {
                "self_attn": attn(False), "ln1": ln(),
                "cross_t2i": attn(True), "ln2": ln(),
                "mlp": mlp([D, cfg.mlp_dim, D]), "ln3": ln(),
                "cross_i2t": attn(True), "ln4": ln(),
            }
            for _ in range(cfg.depth)
        ],
        "final_attn": attn(True),
        "final_ln": ln(),
        "upscale_conv1": normal(gen, (2, 2, D, D // 4), dt, device),
        "upscale_conv1_bias": torch.zeros(D // 4, dtype=dt, device=device),
        "upscale_ln": ln(D // 4),
        "upscale_conv2": normal(gen, (2, 2, D // 4, D // 8), dt, device),
        "upscale_conv2_bias": torch.zeros(D // 8, dtype=dt, device=device),
        "hyper_mlps": [mlp([D, D, D, D // 8]) for _ in range(cfg.num_mask_tokens)],
        "iou_head": mlp(
            [D] + [cfg.iou_head_hidden_dim] * (cfg.iou_head_depth - 1) + [cfg.num_mask_tokens]
        ),
    }


def _apply_attn(p: Params, cfg: SamDecoderConfig, q, k, v):
    """Downsampled multi-head attention over [B, S, D] streams."""
    B, Sq, _ = q.shape
    inner = p["q"]["w"].shape[1]
    H = cfg.num_heads
    hd = inner // H
    qh = (q @ p["q"]["w"] + p["q"]["b"]).reshape(B, Sq, H, hd)
    kh = (k @ p["k"]["w"] + p["k"]["b"]).reshape(B, k.shape[1], H, hd)
    vh = (v @ p["v"]["w"] + p["v"]["b"]).reshape(B, v.shape[1], H, hd)
    out = attention_xla(qh, kh, vh, scale=hd**-0.5)
    return out.reshape(B, Sq, inner) @ p["out"]["w"] + p["out"]["b"]


def _two_way_block(p, cfg, queries, keys, query_pe, key_pe, skip_first_layer_pe: bool):
    eps = cfg.layer_norm_eps
    if skip_first_layer_pe:
        queries = _apply_attn(p["self_attn"], cfg, queries, queries, queries)
    else:
        q = queries + query_pe
        queries = queries + _apply_attn(p["self_attn"], cfg, q, q, queries)
    queries = layer_norm(queries, p["ln1"]["scale"], p["ln1"]["bias"], eps)

    q, k = queries + query_pe, keys + key_pe
    queries = queries + _apply_attn(p["cross_t2i"], cfg, q, k, keys)
    queries = layer_norm(queries, p["ln2"]["scale"], p["ln2"]["bias"], eps)

    queries = queries + apply_mlp(p["mlp"], queries)
    queries = layer_norm(queries, p["ln3"]["scale"], p["ln3"]["bias"], eps)

    q, k = queries + query_pe, keys + key_pe
    keys = keys + _apply_attn(p["cross_i2t"], cfg, k, q, queries)
    keys = layer_norm(keys, p["ln4"]["scale"], p["ln4"]["bias"], eps)
    return queries, keys


def two_way_transformer(
    params: Params,
    cfg: SamDecoderConfig,
    image_embedding: torch.Tensor,  # [B, g, g, D]
    image_pe: torch.Tensor,  # [g, g, D]
    point_embedding: torch.Tensor,  # [B, Nt, D]
):
    B, g, _, D = image_embedding.shape
    keys = image_embedding.reshape(B, g * g, D)
    key_pe = image_pe.reshape(1, g * g, D).expand(B, g * g, D)
    queries = point_embedding
    for i, lp in enumerate(params["layers"]):
        queries, keys = _two_way_block(
            lp, cfg, queries, keys, point_embedding, key_pe, skip_first_layer_pe=(i == 0)
        )
    q, k = queries + point_embedding, keys + key_pe
    queries = queries + _apply_attn(params["final_attn"], cfg, q, k, keys)
    queries = layer_norm(
        queries, params["final_ln"]["scale"], params["final_ln"]["bias"], cfg.layer_norm_eps
    )
    return queries, keys


def _upscale2x(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """ConvTranspose2d(kernel=2, stride=2) as an einsum + reshape, kernel
    [kh, kw, in, out]: out[2i+di, 2j+dj, o] = sum_c x[i, j, c] K[di, dj, c, o]."""
    B, h, w, C = x.shape
    out = torch.einsum("bhwc,ijco->bhiwjo", x, kernel)
    return out.reshape(B, 2 * h, 2 * w, kernel.shape[-1])


def decode_masks(
    params: Params,
    cfg: SamDecoderConfig,
    image_embeddings: torch.Tensor,  # [B, g, g, D]
    image_pe: torch.Tensor,  # [g, g, D]
    sparse_prompt: torch.Tensor,  # [B, Ns, D]
    dense_prompt: torch.Tensor,  # [B, g, g, D]
    multimask_output: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (low_res_masks [B, M, 4g, 4g], iou_pred [B, M])."""
    B = sparse_prompt.shape[0]
    D = cfg.embed_dim
    g = image_embeddings.shape[1]

    output_tokens = torch.cat([params["iou_token"], params["mask_tokens"]], dim=0)
    tokens = torch.cat(
        [output_tokens.expand((B,) + output_tokens.shape), sparse_prompt], dim=1
    )
    src = image_embeddings + dense_prompt
    hs, src_out = two_way_transformer(params, cfg, src, image_pe, tokens)
    iou_token_out = hs[:, 0]
    mask_tokens_out = hs[:, 1:1 + cfg.num_mask_tokens]

    x = src_out.reshape(B, g, g, D)
    x = _upscale2x(x, params["upscale_conv1"]) + params["upscale_conv1_bias"]
    x = layer_norm(x, params["upscale_ln"]["scale"], params["upscale_ln"]["bias"], 1e-6)
    x = F.gelu(x)
    x = _upscale2x(x, params["upscale_conv2"]) + params["upscale_conv2_bias"]
    x = F.gelu(x)  # [B, 4g, 4g, D//8]

    hyper = torch.stack(
        [apply_mlp(params["hyper_mlps"][i], mask_tokens_out[:, i])
         for i in range(cfg.num_mask_tokens)],
        dim=1,
    )  # [B, M, D//8]
    masks = torch.einsum("bmc,bhwc->bmhw", hyper, x)
    iou_pred = apply_mlp(params["iou_head"], iou_token_out)
    sl = slice(1, None) if multimask_output else slice(0, 1)
    return masks[:, sl], iou_pred[:, sl]
