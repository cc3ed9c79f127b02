"""LLaMA decoder (counterpart of `ullava_tpu/models/llama.py`:
`LlamaConfig`, `init_params`, `init_kv_cache`, `_layer` and `forward`, in
bf16 or with int8 weights, W8A8 prefill and an int8 KV cache, the
training forward, and LoRA adapters with `add_lora` / `merge_lora`).

Pre-norm RMSNorm -> rotary MHA -> RMSNorm -> SwiGLU with fp32 norm
statistics. Parameters are a dict whose `layers` entry is a list of
per-layer dicts (the JAX tree stacks them on a leading axis); linear
weights are `[in, out]` tensors or `{"q", "scale"}` int8 leaves
(`ops/quant.py`). The KV cache is stacked over layers and updated IN PLACE
(the JAX version threads it functionally): `[L, B, maxS, Hkv, hd]` in the
compute dtype, or with `kv_quant` `[L, B, maxS, Hkv*hd]` int8 plus
`[L, B, maxS, Hkv]` f32 scales.

Prefill (S > 1 with a cache) runs `fused_rotary` on q and k and the flash
forward through `attention(impl=cfg.attn_impl)`. With `a8_prefill` its
linears are W8A8, and with `fused_norm_quant` both norm sites are the
fused add + RMSNorm + quantize kernel, the MLP residual deferred one layer
(`pending`), and the MLP gate is `silu_mul_quant`; `kv_quant` writes the
cache through `prefill_quantize_write`. A decode step (S == 1) keeps
weight-only linears; it scatters one row per sample at `write_pos` and
attends with the plain path, or with `kv_quant` runs the write-and-attend
kernel. The JAX package gates these routes on the TPU and on tile
alignment; here the config alone chooses, and a shape a kernel cannot
take raises in its wrapper.

Training is the no-cache path under autograd: rotary in fp32
(`apply_rotary`; in `dtype` with `rope_f32=False`, as every `bench.py`
preset sets it, and so in decode steps), attention through the
flash Function (K15 forward, K16 + K17 backward) and both norms through
the RMSNorm Function (K9 forward, K18 backward); with `remat` each layer
runs under `torch.utils.checkpoint`, so the backward recomputes it from
its input (the JAX `jax.checkpoint` of the layer scan body). With
`remat_policy="dots"` the recompute keeps the outputs of the matmuls that
have no batch dims (`aten.mm`, `aten.addmm`, `aten._int_mm`: every
linear reaches the dispatcher as one of them) and recomputes the rest (the JAX policy
`dots_with_no_batch_dims_saveable`), through
`torch.utils.checkpoint.create_selective_checkpoint_contexts`. The
ctypes kernels (K15, K9, K18) are invisible to the dispatcher, so they
recompute under either policy, as a Pallas output is no dot in JAX.

Tensor parallelism (parameters that are `DTensor`s of a (dp, fsdp, tp)
mesh, `parallel/`): each layer takes its weights' local tensors (fsdp
shards gathered just before use, again in a remat recompute); q/k/v and
gate/up are column-parallel (H/tp heads and F/tp columns go to the
kernels, the KV cache holds the local heads), o/down row-parallel with
one all-reduce each, the embedding vocab-parallel (a masked lookup, then
an all-reduce); `lm_head` is gathered for the logits and the streamed CE,
and vocab-parallel in `generate`. The W8A8 forms need whole rows (the
per-row int8 scale spans the full width: K5, K6, `apply_linear_a8`), so
under tp > 1 a W8A8 o/down projection gathers its input over tp and runs
on its whole (replicated int8) weight, as XLA runs a Pallas call it cannot
partition on gathered operands; the column-parallel W8A8 products see
whole rows already. Row-parallel sums reorder fp additions against one
device.

LoRA: a layer holding `{name}_lora_a` [in, r] and `{name}_lora_b` [r, out]
adds `lora_scale * (x @ A) @ B` to that projection; such a layer never
takes the fused norm + quantize prefill, whose int8 rows the adapters
cannot read.

One departure from the JAX package, on purpose: under autograd (grad mode
on and the linear's input requiring grad) an int8 weight takes the
weight-only `apply_linear`, never the W8A8 `apply_linear_a8`, whatever
`a8_prefill` says. The per-row int8 rounding of the activations passes
no gradient but through the abs-max (cosine about 5e-4 to the weight-only
gradient), so a W8A8 linear would all but stop the gradient to every
adapter and every embedding below it. Serving is unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ullava_tpu_torch import resolve_device
from ullava_tpu_torch.models import normal
from ullava_tpu_torch.ops.attention import attention
from ullava_tpu_torch.ops.decode_attention import (
    decode_attention_int8_fused_write,
    prefill_quantize_write,
    quantize_kv_rows,
)
from ullava_tpu_torch.ops.mlp_kernel import silu_mul_quant
from ullava_tpu_torch.ops.norms import rms_norm, rms_norm_residual_quant
from ullava_tpu_torch.ops.quant import (
    apply_linear,
    apply_linear_a8,
    apply_linear_a8_prequant,
    is_quantized,
)
from ullava_tpu_torch.ops.rope import apply_rotary, fused_rotary, rope_cos_sin
from ullava_tpu_torch.parallel.collectives import (
    TPGroup,
    copy_to_tp,
    gather_from_tp,
    reduce_from_tp,
    tp_group,
)
from ullava_tpu_torch.parallel.sharding import local_weight

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    # Training: recompute each layer in the backward from its input:
    # 'full' saves nothing inside the layer, 'dots' keeps the outputs of
    # the matmuls without batch dims.
    remat: bool = True
    remat_policy: str = "full"
    # Attention of prefill and training: 'flash' (the kernels), 'xla' (the
    # plain path) or 'auto' (`ops.attention.attention`: flash on the card,
    # the plain path on the CPU).
    attn_impl: str = "auto"
    # Run the prefill's linears (S > 1) W8A8 where the weight is int8. A
    # decode step stays weight-only.
    a8_prefill: bool = False
    # Store the KV cache int8 with per-(position, head) scales.
    kv_quant: bool = False
    # With a8_prefill: fuse the residual add, RMSNorm and per-row int8
    # quantize at both norm sites, deferring the MLP residual one layer.
    fused_norm_quant: bool = True
    # LoRA scaling (alpha / r); active only where *_lora_a/b leaves exist.
    lora_scale: float = 2.0
    # Rotate q and k in fp32 (True) or in `dtype` (decode steps and
    # training; the serving prefill's fused rotary stays fp32 inside the
    # kernel, as the JAX package's does).
    rope_f32: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        # The test configuration holds the kernels' route: 'flash' runs
        # their plain versions on the CPU, where 'auto' takes the plain path.
        defaults = dict(attn_impl="flash",
            vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=4, max_position_embeddings=256,
            dtype=torch.float32, remat=False,
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
    cfg: LlamaConfig, batch: int, max_len: int, device=None, tp: int = 1
) -> Dict[str, torch.Tensor]:
    """The cache of `max_len` positions; under tensor parallelism (`tp`
    ranks) it holds this rank's Hkv / tp heads."""
    # The cache holds every position a sequence reaches; rotary past the
    # model's trained positions is refused here, before any work.
    if max_len > cfg.max_position_embeddings:
        raise ValueError(f"a cache of {max_len} positions exceeds "
                         f"max_position_embeddings={cfg.max_position_embeddings}")
    device = resolve_device(device)
    Hkv = cfg.num_kv_heads // tp
    if cfg.kv_quant:
        # Heads merged on the minor dim, the layout both cache kernels
        # address; the length rounds up to a multiple of 8 as the JAX
        # cache's does, so the two have the same shape.
        rows = (cfg.num_layers, batch, (max_len + 7) // 8 * 8)
        merged = rows + (Hkv * cfg.head_dim,)
        return {
            "k": torch.zeros(merged, dtype=torch.int8, device=device),
            "v": torch.zeros(merged, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(rows + (Hkv,), dtype=torch.float32, device=device),
            "v_scale": torch.zeros(rows + (Hkv,), dtype=torch.float32, device=device),
        }
    shape = (cfg.num_layers, batch, max_len, Hkv, cfg.head_dim)
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
    pending: Optional[torch.Tensor] = None,  # deferred MLP residual (fused-norm prefill)
    tp: Optional[TPGroup] = None,  # tensor parallelism: `p` holds DTensors or local_params
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One decoder layer. Returns (h, pending): with `pending` given, the
    MLP output comes back as the next `pending` and is not yet added."""
    B, S, D = h.shape
    n_tp = 1 if tp is None else tp.size
    H, Hkv, hd = cfg.num_heads // n_tp, cfg.num_kv_heads // n_tp, cfg.head_dim
    fused = pending is not None
    if tp is not None:
        p = _tp_layer_params(p)

    def a8(xin, w):
        # W8A8 for serving only: under autograd its int8 rounding would
        # cut the gradient to the input (the module docstring).
        grad = torch.is_grad_enabled() and xin.requires_grad
        return cfg.a8_prefill and S > 1 and is_quantized(w) and not grad

    def lin(xin, w):
        return apply_linear_a8(xin, w) if a8(xin, w) else apply_linear(xin, w)

    def row_lin(xin, w):
        # Row-parallel: this rank's input columns times its weight rows,
        # summed over tp; a W8A8 product at tp > 1 gathers its input and
        # runs the whole weight instead (the module docstring).
        if tp is None:
            return lin(xin, w)
        if tp.size > 1 and a8(xin, w):
            return lin(gather_from_tp(xin, tp), w)
        return reduce_from_tp(lin(xin, _tp_rows(w, xin.shape[-1], tp)), tp)

    if fused:
        # The previous layer's MLP residual add, the norm and the int8
        # activation quantize in one pass; q/k/v share the int8 rows.
        h, xq, xs = rms_norm_residual_quant(h, pending, p["input_norm"], cfg.rms_norm_eps)
        xq = xq.reshape(B * S, D)

        def proj(name, heads):
            return apply_linear_a8_prequant(xq, xs, p[name], cfg.dtype).reshape(B, S, heads, hd)
    else:
        x = rms_norm(h, p["input_norm"], cfg.rms_norm_eps)
        if tp is not None:
            x = copy_to_tp(x, tp)

        def proj(name, heads):
            y = lin(x, p[name])
            if f"{name}_lora_a" in p:
                y = y + cfg.lora_scale * ((x @ p[f"{name}_lora_a"]) @ p[f"{name}_lora_b"])
            return y.reshape(B, S, heads, hd)

    q, k, v = proj("q_proj", H), proj("k_proj", Hkv), proj("v_proj", Hkv)
    if cache is not None and S > 1:
        # Serving prefill: one-pass rotary kernel over the flat rows.
        cos_r = cos.expand(B, S, hd).reshape(B * S, hd)
        sin_r = sin.expand(B, S, hd).reshape(B * S, hd)
        q = fused_rotary(q.reshape(B * S, H * hd), cos_r, sin_r, hd).reshape(B, S, H, hd)
        k = fused_rotary(k.reshape(B * S, Hkv * hd), cos_r, sin_r, hd).reshape(B, S, Hkv, hd)
    else:
        q, k = apply_rotary(q, k, cos, sin, compute_dtype=None if cfg.rope_f32 else cfg.dtype)

    if cache is None:
        attn = attention(q, k, v, causal=causal, kv_lens=kv_lens, impl=cfg.attn_impl)
    elif S == 1 and "k_scale" in cache:
        # Write-and-attend over the int8 cache: the kernel masks rows at
        # and after write_pos and scores the current token from its new
        # row, so `kv_lens` is not consulted.
        kq, ks = quantize_kv_rows(k[:, 0])  # [B, Hkv, hd] rows
        vq, vs = quantize_kv_rows(v[:, 0])
        attn = decode_attention_int8_fused_write(
            q, kq.reshape(B, Hkv * hd), ks, vq.reshape(B, Hkv * hd), vs,
            cache["k"], cache["v"], cache["k_scale"], cache["v_scale"],
            write_pos, layer_idx, scale=hd**-0.5,
        )[0]
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
        if "k_scale" in cache:
            prefill_quantize_write(
                k, v, cache["k"], cache["v"], cache["k_scale"], cache["v_scale"], layer_idx
            )
        else:
            cache["k"][layer_idx, :, :S] = k
            cache["v"][layer_idx, :, :S] = v
        attn = attention(q, k, v, causal=causal, kv_lens=kv_lens, impl=cfg.attn_impl)

    o = row_lin(attn.reshape(B, S, H * hd), p["o_proj"])
    if fused:
        h, xq, xs = rms_norm_residual_quant(h, o, p["post_norm"], cfg.rms_norm_eps)
        xq = xq.reshape(B * S, D)
        g = apply_linear_a8_prequant(xq, xs, p["gate_proj"], cfg.dtype)
        u = apply_linear_a8_prequant(xq, xs, p["up_proj"], cfg.dtype)
    else:
        h = h + o
        x = rms_norm(h, p["post_norm"], cfg.rms_norm_eps)
        if tp is not None:
            x = copy_to_tp(x, tp)
        g, u = lin(x, p["gate_proj"]), lin(x, p["up_proj"])
    if cfg.a8_prefill and S > 1 and cache is not None and is_quantized(p["down_proj"]):
        # Fused silu * up + per-row int8 quantize feeding the W8A8 down
        # projection (serving only, as in the JAX package); its row scale
        # spans all F columns, so tp > 1 gathers them first.
        if tp is not None and tp.size > 1:
            g, u = gather_from_tp(g, tp), gather_from_tp(u, tp)
        F_ = g.shape[-1]
        gq, gs = silu_mul_quant(g.reshape(B * S, F_), u.reshape(B * S, F_))
        y = apply_linear_a8_prequant(gq, gs, p["down_proj"], cfg.dtype).reshape(B, S, D)
    else:
        y = row_lin(F.silu(g) * u, p["down_proj"]).reshape(B, S, D)
    if fused:
        return h, y  # the next layer's fused norm adds y
    return h + y, None


_COLUMN = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
_ROW = ("o_proj", "down_proj")


def _tp_layer_params(p: Params) -> Params:
    """One layer's local tensors under tensor parallelism: the
    column-parallel weights' (and LoRA B's) tp columns, the row-parallel
    bf16 weights' tp rows, int8 row weights whole (sliced at use unless a
    W8A8 product takes them whole), LoRA A whole inside the column-parallel
    region, the norms whole."""
    out = {}
    for k, w in p.items():
        if k in _COLUMN or k.endswith("_lora_b"):
            out[k] = local_weight(w, dim=-1)
        elif k in _ROW and not is_quantized(w):
            out[k] = local_weight(w, dim=-2)
        else:
            out[k] = local_weight(w, inside=k.endswith("_lora_a"))
    return out


def _tp_rows(w, n: int, tp: TPGroup):
    """This rank's `n` input rows of a row-parallel weight (already them
    when it is a local shard of n rows)."""
    if not is_quantized(w):
        return w
    q = w["q"]
    if q.shape[-2] == n:
        return w
    return {"q": q.narrow(-2, tp.rank * n, n), "scale": w["scale"]}


def _use_fused_norm_quant(cfg: LlamaConfig, layer: Params, S: int) -> bool:
    """The fused add + RMSNorm + quantize prefill: W8A8 prefill with int8
    q/gate/up weights and no LoRA adapters, which need the normed rows in
    the compute dtype (the JAX gate without its TPU and tile conditions)."""
    return (
        cfg.fused_norm_quant and cfg.a8_prefill and S > 1
        and all(is_quantized(layer.get(k)) for k in ("q_proj", "gate_proj", "up_proj"))
        and "q_proj_lora_a" not in layer and "v_proj_lora_a" not in layer
    )


def _remat_layer(cfg, h, lp, cos, sin, kv_lens, causal, tp):
    return _layer(cfg, h, lp, cos, sin, kv_lens, None, 0, None, causal, tp=tp)[0]


# The matmuls without batch dims, whose outputs the 'dots' policy keeps
# (`x @ w` and `F.linear` reach the dispatcher as mm or addmm); bmm is left
# out.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten._int_mm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return torch.utils.checkpoint.create_selective_checkpoint_contexts(_dots_policy)


def embed(params: Params, input_ids: torch.Tensor, tp: Optional[TPGroup] = None) -> torch.Tensor:
    """Token embeddings; vocab-parallel under tensor parallelism: each rank
    looks up the ids in its V / tp rows (zeros elsewhere), then one
    all-reduce over tp. `tp` is the DTensor table's group unless given
    (with `local_params`' tensors)."""
    w = params["embed_tokens"]
    tp = tp or tp_group(w)
    if tp is None:
        return w[input_ids]
    w = local_weight(w, dim=0)
    rows = w.shape[0]
    rel = input_ids - tp.rank * rows
    inside = (rel >= 0) & (rel < rows)
    found = w[rel.clamp(0, rows - 1)]
    return reduce_from_tp(torch.where(inside[..., None], found, torch.zeros_like(found)), tp)


def local_params(params: Params) -> Params:
    """This rank's tensors of a DTensor decoder tree, for many calls
    without a gradient (the decode loop): each layer's as `_layer` takes
    them, the embedding's V / tp rows, the norm whole and `lm_head`'s V /
    tp columns. Run `forward` on them with `tp=` the tree's group."""
    return {"embed_tokens": local_weight(params["embed_tokens"], dim=0),
            "layers": [_tp_layer_params(lp) for lp in params["layers"]],
            "norm": local_weight(params["norm"]),
            "lm_head": local_weight(params["lm_head"], dim=-1)}


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
    tp: Optional[TPGroup] = None,  # with `local_params`' tensors: their tp group
) -> Dict[str, Any]:
    """Run the decoder stack. Returns {"hidden_states": [B,S,D] post-norm,
    "logits": [B,S,V] fp32 or None, "kv_cache": the cache (updated in
    place) or None}."""
    tp = tp or tp_group(params["embed_tokens"])
    if inputs_embeds is None:
        inputs_embeds = embed(params, input_ids, tp)
    h = inputs_embeds.to(cfg.dtype)
    B, S, _ = h.shape
    if positions is None:
        positions = torch.arange(S, device=h.device).expand(B, S)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    layers = params["layers"]
    # Fused-norm W8A8 prefill: the MLP residual is carried to the next
    # layer's fused norm; layer 0 adds zeros and the last one is added here.
    pend = None
    if kv_cache is not None and _use_fused_norm_quant(cfg, layers[0], S):
        pend = torch.zeros_like(h)
    remat = kv_cache is None and cfg.remat and torch.is_grad_enabled()
    if cfg.remat_policy not in ("full", "dots"):
        raise ValueError(f"remat_policy {cfg.remat_policy!r}: 'full' or 'dots'")
    ctx = {"context_fn": _dots_context} if cfg.remat_policy == "dots" else {}
    for i, lp in enumerate(layers):
        if remat:
            h = torch.utils.checkpoint.checkpoint(
                _remat_layer, cfg, h, lp, cos, sin, kv_lens, causal, tp,
                use_reentrant=False, **ctx)
            continue
        h, pend = _layer(cfg, h, lp, cos, sin, kv_lens, kv_cache, i, write_pos, causal, pend,
                         tp=tp)
    if pend is not None:
        h = h + pend
    h = rms_norm(h, local_weight(params["norm"]), cfg.rms_norm_eps)
    logits = (apply_linear(h, local_weight(params["lm_head"])).float()
              if compute_logits else None)
    return {"hidden_states": h, "logits": logits, "kv_cache": kv_cache}


# ---------------------------------------------------------------------------
# LoRA (the reference's peft r=8, alpha=16 on q_proj and v_proj)
# ---------------------------------------------------------------------------


def add_lora(
    params: Params,
    cfg: LlamaConfig,
    generator: Optional[torch.Generator] = None,
    r: int = 8,
    targets: Tuple[str, ...] = ("q_proj", "v_proj"),
) -> Params:
    """Attach adapters to every layer's `targets`: A gaussian / sqrt(in),
    B zeros, so the model computes what it did. They take the weight's
    dtype (`cfg.dtype` for an int8 base). Returns a new tree sharing the
    base leaves."""
    gen = generator or torch.Generator(device=params["embed_tokens"].device).manual_seed(0)
    layers = []
    for lp in params["layers"]:
        lp = dict(lp)
        for name in targets:
            w = lp[name]
            wt = w["q"] if is_quantized(w) else w
            din, dout = wt.shape
            dtype, dev = (cfg.dtype if is_quantized(w) else w.dtype), wt.device
            lp[f"{name}_lora_a"] = normal(gen, (din, r), dtype, dev, std=din**-0.5)
            lp[f"{name}_lora_b"] = torch.zeros((r, dout), dtype=dtype, device=dev)
        layers.append(lp)
    return {**params, "layers": layers}


def merge_lora(params: Params, cfg: LlamaConfig) -> Params:
    """Fold the adapters into the base weights (`W + lora_scale * A @ B`,
    in fp32) and drop them. An int8 base is dequantized, folded and
    requantized, so quantize -> add_lora -> train -> merge serves without
    the bf16 stack."""
    from ullava_tpu_torch.ops.quant import dequantize, quantize_int8

    layers = []
    for lp in params["layers"]:
        lp = dict(lp)
        for key in [k for k in lp if k.endswith("_lora_a")]:
            base = key[: -len("_lora_a")]
            a, b = lp.pop(key), lp.pop(base + "_lora_b")
            delta = cfg.lora_scale * (a.float() @ b.float())
            w = lp[base]
            if is_quantized(w):
                lp[base] = quantize_int8(dequantize(w, torch.float32) + delta)
            else:
                lp[base] = (w.float() + delta).to(w.dtype)
        layers.append(lp)
    return {**params, "layers": layers}
