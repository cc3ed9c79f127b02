"""LLaMA decoder, serving path (counterpart of `ullava_tpu/models/llama.py`:
`LlamaConfig`, `init_params`, `init_kv_cache`, `_layer` and `forward` on the
bf16, non-LoRA path).

Pre-norm RMSNorm -> rotary MHA -> RMSNorm -> SwiGLU with fp32 norm
statistics. Parameters are a dict whose `layers` entry is a list of
per-layer dicts (the JAX tree stacks them on a leading axis); linear
weights are `[in, out]`. The KV cache is a stacked `[L, B, maxS, Hkv, hd]`
pair updated IN PLACE (the JAX version threads it functionally).

Prefill (S > 1 with a cache) runs the two serving kernels: `fused_rotary`
on q and k, and the flash forward through `attention(impl=cfg.attn_impl)`.
A decode step scatters one row per sample at `write_pos` and attends over
the whole cache with the plain path, masked by `kv_lens`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ullava_tpu_torch import resolve_device
from ullava_tpu_torch.models import normal
from ullava_tpu_torch.ops.attention import attention
from ullava_tpu_torch.ops.norms import rms_norm
from ullava_tpu_torch.ops.rope import apply_rotary, fused_rotary, rope_cos_sin

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    # Prefill attention: 'flash' (the kernel) or 'xla' (the plain path).
    attn_impl: str = "flash"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        defaults = dict(
            vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=4,
            dtype=torch.float32,
        )
        defaults.update(kw)
        return cls(**defaults)


def init_params(
    cfg: LlamaConfig, generator: Optional[torch.Generator] = None, device=None
) -> Params:
    """Random-normal init (std 0.02), as the JAX `init_params`."""
    device = resolve_device(device)
    gen = generator or torch.Generator(device=device).manual_seed(0)
    D, F_, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def w(*shape):
        return normal(gen, shape, cfg.dtype, device)

    def ones(n):
        return torch.ones(n, dtype=cfg.dtype, device=device)

    layers = [
        {
            "input_norm": ones(D),
            "q_proj": w(D, H * hd),
            "k_proj": w(D, Hkv * hd),
            "v_proj": w(D, Hkv * hd),
            "o_proj": w(H * hd, D),
            "post_norm": ones(D),
            "gate_proj": w(D, F_),
            "up_proj": w(D, F_),
            "down_proj": w(F_, D),
        }
        for _ in range(cfg.num_layers)
    ]
    return {"embed_tokens": w(V, D), "layers": layers, "norm": ones(D), "lm_head": w(D, V)}


def init_kv_cache(
    cfg: LlamaConfig, batch: int, max_len: int, device=None
) -> Dict[str, torch.Tensor]:
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    device = resolve_device(device)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
    }


def _layer(
    cfg: LlamaConfig,
    h: torch.Tensor,  # [B, S, D]
    p: Params,  # one layer's params
    cos: torch.Tensor,  # [B, S, hd] fp32
    sin: torch.Tensor,
    kv_lens: Optional[torch.Tensor],
    cache: Optional[Dict[str, torch.Tensor]],  # FULL stacked cache, updated in place
    layer_idx: int,
    write_pos: Optional[torch.Tensor],  # [B] per-sample write index (S == 1)
    causal: bool,
) -> torch.Tensor:
    B, S, D = h.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    x = rms_norm(h, p["input_norm"], cfg.rms_norm_eps)
    q = (x @ p["q_proj"]).reshape(B, S, H, hd)
    k = (x @ p["k_proj"]).reshape(B, S, Hkv, hd)
    v = (x @ p["v_proj"]).reshape(B, S, Hkv, hd)
    if cache is not None and S > 1:
        # Serving prefill: one-pass rotary kernel over the flat rows.
        cos_r = cos.expand(B, S, hd).reshape(B * S, hd)
        sin_r = sin.expand(B, S, hd).reshape(B * S, hd)
        q = fused_rotary(q.reshape(B * S, H * hd), cos_r, sin_r, hd).reshape(B, S, H, hd)
        k = fused_rotary(k.reshape(B * S, Hkv * hd), cos_r, sin_r, hd).reshape(B, S, Hkv, hd)
    else:
        q, k = apply_rotary(q, k, cos, sin)

    if cache is None:
        attn = attention(q, k, v, causal=causal, kv_lens=kv_lens, impl=cfg.attn_impl)
    elif S == 1:
        b_idx = torch.arange(B, device=h.device)
        cache["k"][layer_idx, b_idx, write_pos] = k[:, 0]
        cache["v"][layer_idx, b_idx, write_pos] = v[:, 0]
        attn = attention(
            q, cache["k"][layer_idx], cache["v"][layer_idx],
            causal=False, kv_lens=kv_lens, impl="xla",
        )
    else:
        # Prefill: bulk-write positions [0, S), attend over the local k/v.
        cache["k"][layer_idx, :, :S] = k
        cache["v"][layer_idx, :, :S] = v
        attn = attention(q, k, v, causal=causal, kv_lens=kv_lens, impl=cfg.attn_impl)

    h = h + attn.reshape(B, S, H * hd) @ p["o_proj"]
    x = rms_norm(h, p["post_norm"], cfg.rms_norm_eps)
    gated = F.silu(x @ p["gate_proj"]) * (x @ p["up_proj"])
    return h + gated @ p["down_proj"]


def embed(params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    return params["embed_tokens"][input_ids]


def forward(
    params: Params,
    cfg: LlamaConfig,
    *,
    input_ids: Optional[torch.Tensor] = None,  # [B, S]
    inputs_embeds: Optional[torch.Tensor] = None,  # [B, S, D]
    positions: Optional[torch.Tensor] = None,  # [B, S]
    kv_lens: Optional[torch.Tensor] = None,  # [B]
    kv_cache: Optional[Dict[str, torch.Tensor]] = None,
    write_pos: Optional[torch.Tensor] = None,  # [B] cache write index (S == 1)
    causal: bool = True,
    compute_logits: bool = True,
) -> Dict[str, Any]:
    """Run the decoder stack. Returns {"hidden_states": [B,S,D] post-norm,
    "logits": [B,S,V] fp32 or None, "kv_cache": the cache (updated in
    place) or None}."""
    if inputs_embeds is None:
        inputs_embeds = embed(params, input_ids)
    h = inputs_embeds.to(cfg.dtype)
    B, S, _ = h.shape
    if positions is None:
        positions = torch.arange(S, device=h.device).expand(B, S)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    for i, lp in enumerate(params["layers"]):
        h = _layer(cfg, h, lp, cos, sin, kv_lens, kv_cache, i, write_pos, causal)
    h = rms_norm(h, params["norm"], cfg.rms_norm_eps)
    logits = (h @ params["lm_head"]).float() if compute_logits else None
    return {"hidden_states": h, "logits": logits, "kv_cache": kv_cache}
