"""CLIP ViT vision tower (counterpart of `ullava_tpu/models/clip_vit.py`;
weights in bf16 or as int8 leaves, `quant.CLIP_QUANT_KEYS`).

Patch embedding as patchify + matmul, class token + learned positions,
pre-LN transformer with quick-GELU MLPs. The intermediate-layer readout
(`hidden_layer`, -2 in the reference configs) runs only the first
`L + 1 + hidden_layer` layers.

Two serving knobs, with the JAX names and defaults. `attn_impl="flash"`
pads the token sequence with zero rows to a multiple of 8 (257 -> 264),
masks the pad keys through `kv_lens` and runs the flash kernel K2
(`flash_attention_fwd_bsh`; head_dim 64 for ViT-L/14), then drops the pad
rows; as in the JAX package only when the width H * hd is a multiple of
128. `a8` runs a layer linear with an int8 weight W8A8 (`apply_linear_a8`)
when its row count is a multiple of 8, weight-only otherwise. The JAX
package takes both knobs only on a TPU (`_on_tpu()`); the port computes
on the CPU and on the card alike what the JAX package computes on the TPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ullava_tpu_torch import resolve_device
from ullava_tpu_torch.models import normal
from ullava_tpu_torch.ops.attention import attention_xla, flash_attention_fwd_bsh
from ullava_tpu_torch.ops.norms import layer_norm
from ullava_tpu_torch.ops.quant import apply_linear, apply_linear_a8, is_quantized

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # Serving knobs (see the module docstring): W8A8 layer linears, and
    # "flash" attention over the sequence padded to a multiple of 8.
    a8: bool = False
    attn_impl: str = "xla"

    def __post_init__(self) -> None:
        if self.attn_impl not in ("xla", "flash"):
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @classmethod
    def tiny(cls, **kw) -> "CLIPVisionConfig":
        defaults = dict(
            hidden_size=64, intermediate_size=128, num_layers=3, num_heads=4,
            image_size=28, patch_size=14, dtype=torch.float32,
        )
        defaults.update(kw)
        return cls(**defaults)


def init_params(
    cfg: CLIPVisionConfig, generator: Optional[torch.Generator] = None, device=None
) -> Params:
    device = resolve_device(device)
    gen = generator or torch.Generator(device=device).manual_seed(0)
    D, F_ = cfg.hidden_size, cfg.intermediate_size
    patch_dim = 3 * cfg.patch_size * cfg.patch_size

    def w(*shape):
        return normal(gen, shape, cfg.dtype, device)

    def const(n, val):
        return torch.full((n,), val, dtype=cfg.dtype, device=device)

    return {
        "class_embedding": w(D),
        "patch_proj": w(patch_dim, D),
        "position_embedding": w(cfg.num_patches + 1, D),
        "pre_ln": {"scale": const(D, 1.0), "bias": const(D, 0.0)},
        "layers": [
            {
                "ln1_scale": const(D, 1.0), "ln1_bias": const(D, 0.0),
                "q_proj": w(D, D), "q_bias": const(D, 0.0),
                "k_proj": w(D, D), "k_bias": const(D, 0.0),
                "v_proj": w(D, D), "v_bias": const(D, 0.0),
                "out_proj": w(D, D), "out_bias": const(D, 0.0),
                "ln2_scale": const(D, 1.0), "ln2_bias": const(D, 0.0),
                "fc1": w(D, F_), "fc1_bias": const(F_, 0.0),
                "fc2": w(F_, D), "fc2_bias": const(D, 0.0),
            }
            for _ in range(cfg.num_layers)
        ],
        "post_ln": {"scale": const(D, 1.0), "bias": const(D, 0.0)},
    }


def patchify(pixel_values: torch.Tensor, patch_size: int) -> torch.Tensor:
    """NHWC image -> [B, num_patches, C*p*p] in (C, ph, pw) flatten order."""
    B, H, W, C = pixel_values.shape
    gh, gw = H // patch_size, W // patch_size
    x = pixel_values.reshape(B, gh, patch_size, gw, patch_size, C)
    x = x.permute(0, 1, 3, 5, 2, 4)
    return x.reshape(B, gh * gw, C * patch_size * patch_size)


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def forward(
    params: Params,
    cfg: CLIPVisionConfig,
    pixel_values: torch.Tensor,  # [B, H, W, 3] NHWC, CLIP-normalized
    hidden_layer: int = -1,
) -> Dict[str, torch.Tensor]:
    """Returns {"hidden_states": [B, 1+P, D] at the selected layer,
    "patch_features": [B, P, D] (CLS dropped)}."""
    B = pixel_values.shape[0]
    D, L, H, hd = cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.head_dim

    x = apply_linear(patchify(pixel_values.to(cfg.dtype), cfg.patch_size), params["patch_proj"])
    cls = params["class_embedding"].to(x.dtype).expand(B, 1, D)
    x = torch.cat([cls, x], dim=1) + params["position_embedding"][None]
    x = layer_norm(x, params["pre_ln"]["scale"], params["pre_ln"]["bias"], cfg.layer_norm_eps)

    n_layers = L + 1 + hidden_layer if hidden_layer < 0 else hidden_layer
    if not 0 <= n_layers <= L:
        raise ValueError(f"hidden_layer {hidden_layer} out of range for {L} layers")

    S_real = x.shape[1]
    use_flash = cfg.attn_impl == "flash" and D % 128 == 0
    if use_flash:
        # Zero pad rows after the pre-LN; their keys are masked, their
        # outputs dropped at the end.
        x = F.pad(x, (0, 0, 0, (-S_real) % 8))
        kv_lens = torch.full((B,), S_real, dtype=torch.int32, device=x.device)
    S = x.shape[1]

    def lin(t, w):
        if cfg.a8 and is_quantized(w) and (t.numel() // t.shape[-1]) % 8 == 0:
            return apply_linear_a8(t, w)
        return apply_linear(t, w)

    for p in params["layers"][:n_layers]:
        y = layer_norm(x, p["ln1_scale"], p["ln1_bias"], cfg.layer_norm_eps)
        q = (lin(y, p["q_proj"]) + p["q_bias"]).reshape(B, S, H, hd)
        k = (lin(y, p["k_proj"]) + p["k_bias"]).reshape(B, S, H, hd)
        v = (lin(y, p["v_proj"]) + p["v_bias"]).reshape(B, S, H, hd)
        if use_flash:
            a = flash_attention_fwd_bsh(q, k, v, kv_lens, causal=False, scale=hd**-0.5)
        else:
            a = attention_xla(q, k, v, causal=False)
        x = x + lin(a.reshape(B, S, D), p["out_proj"]) + p["out_bias"]
        y = layer_norm(x, p["ln2_scale"], p["ln2_bias"], cfg.layer_norm_eps)
        h = _quick_gelu(lin(y, p["fc1"]) + p["fc1_bias"])
        x = x + lin(h, p["fc2"]) + p["fc2_bias"]
    x = x[:, :S_real]
    return {"hidden_states": x, "patch_features": x[:, 1:]}
