"""Where the int8 SAM encoder of `test_torch_sam_hd64_int8.py` departs from
the JAX encoder, block by block, at hd 64 and at its hd 80 twin, on the
test's own draw (parameters seed 34, std 0.1; image seed 34), with
`attn_dots_i8` off and on.

Both encoders run one block at a time from the same patch embedding (the
JAX blocks jitted one by one, as `jie.encode`'s scan runs them, with
`EXACT`'s compiler option; the whole encode also without it). At each
block's input the first int8 activation codes of the block, the LN1 rows
that its fused LN + qkv kernels quantize, are formed from each side's
input with one quantizer (`_ln_f32` and `_row_quant`) and compared:

- chain: each side runs its own chain; `codes_differ` counts the codes
  that differ at the block's input, and `max_rel`, `median_rel` give the
  block's output departure in units of its largest value;
- alone: the port's block runs on JAX's input to that block, so the
  block's own departure (`alone_max_rel`, `alone_median_rel`,
  `alone_codes_differ` at its output) shows apart from what earlier blocks
  carry in; `alone_excess_*` the same against the JAX block compiled
  without `EXACT`;
- ties: on identical inputs (JAX's block input), the LN1 codes of the
  JAX kernels' arithmetic (`jnp.var`, `_row_quant` with one division by
  the abs-max) against the port's; `tie_flips` counts those that differ
  and `tie_within` says whether each lies within 1e-4 of a rounding tie.

    JAX_PLATFORMS=cpu python tests/torch_sam_int8_departure.py

prints one JSON line per configuration. `test_torch_sam_int8_departure.py`
holds what it found.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parents[1])]
from torch_port_helpers import random_params  # noqa: E402
from ullava_tpu.models.sam import image_encoder as jie  # noqa: E402
from ullava_tpu.ops import quant as jquant  # noqa: E402
from ullava_tpu_torch.bridge import params_from_jax  # noqa: E402
from ullava_tpu_torch.models.sam import image_encoder  # noqa: E402
from ullava_tpu_torch.ops.mlp_kernel import _ln_f32, _row_quant  # noqa: E402

# XLA on the CPU may keep a bf16 value in fp32 where the program rounds it
# (`xla_allow_excess_precision`, on by default): the JAX kernels' bf16
# exponentials (`exp_bf16`) then go unrounded. Compiled with it off, the
# JAX functions round where they say they do, as the port does.
EXACT = {"xla_allow_excess_precision": False}
# The encoder of `test_torch_sam_hd64_int8.py` (`_ENC`), 4 heads.
ENC = dict(img_size=512, patch_size=16, depth=4, num_heads=4, out_chans=16, window_size=14,
           global_attn_indexes=(1, 3))


def build(hd: int, dots_i8: bool, seed: int = 34):
    """The test's two encoders at head dim `hd`: JAX's config and
    quantized params, the port's, and the image."""
    base = {**ENC, "embed_dim": 4 * hd}
    jcfg = jie.SamVisionConfig(**base, dtype=jnp.float32, attn_kernel="pallas_interpret",
                               mlp_w8a8=True, window_layout="resident", attn_dots_i8=dots_i8)
    cfg = image_encoder.SamVisionConfig(**base, dtype=torch.float32, mlp_w8a8=True,
                                        window_layout="resident", attn_dots_i8=dots_i8)
    jp = jax.tree_util.tree_map(jnp.asarray, random_params(jie.init_params, jcfg, seed, std=0.1))
    jq = jie.precompute_window_bias_weights(
        jquant.quantize_tree(jp, jquant.SAM_ENCODER_QUANT_KEYS), jcfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jq), device="cpu")
    img = np.random.default_rng(seed).standard_normal((1, 512, 512, 3)).astype(np.float32)
    return jcfg, jq, cfg, params, img


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x, np.float32)


def ln1_codes(x, p, eps: float) -> np.ndarray:
    """The int8 codes of LN1(x) rows, by the port's quantizer."""
    xf = torch.from_numpy(_np(x)).reshape(-1, _np(x).shape[-1])
    return _row_quant(_ln_f32(xf, p["ln1_scale"], p["ln1_bias"], eps))[0].numpy()


def ln1_values_jax(x, p, eps: float):
    """LN1(x) rows and their int8 codes in the JAX kernels' arithmetic."""
    xf = jnp.asarray(_np(x)).reshape(-1, _np(x).shape[-1])
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.var(xf, axis=-1, keepdims=True)
    normed = (xf - mean) * jax.lax.rsqrt(var + eps) * jnp.asarray(_np(p["ln1_scale"])) + \
        jnp.asarray(_np(p["ln1_bias"]))
    amax = jnp.maximum(jnp.max(jnp.abs(normed), axis=-1, keepdims=True), 1e-12)
    return np.asarray(normed), np.asarray(jnp.round(normed * (127.0 / amax)).astype(jnp.int8)), \
        np.asarray(amax)


def blocks(jcfg, jq, cfg, params, opts=EXACT):
    """[(kind, jax_fn, port_fn, port params)] in encode's order: one
    window block in the resident layout, then one global block, twice;
    the JAX blocks compiled with `opts`."""
    ws, g = cfg.window_size, cfg.grid
    pad_full_to = -(-ws * ws // 8) * 8 if (ws * ws) % 8 else 0
    per = cfg.group_period - 1
    out = []
    for gi in range(len(params["global_blocks"])):
        for wi in range(gi * per, (gi + 1) * per):
            jwp = jax.tree_util.tree_map(lambda a, wi=wi: a[wi], jq["window_blocks"])

            def jfn(x, jwp=jwp):
                cls = jie._partition_resident(x, ws, pad_full_to)
                return jie._unpartition_resident(jie._block_resident(cls, jwp, jcfg), 1, g, ws)

            def tfn(x, wp=params["window_blocks"][wi]):
                cls = image_encoder._partition_resident(x, ws, pad_full_to)
                return image_encoder._unpartition_resident(
                    image_encoder._block_resident(cls, wp, cfg), 1, g, ws)

            out.append(("window", jax.jit(jfn, compiler_options=opts), tfn,
                        params["window_blocks"][wi]))
        jgp = jax.tree_util.tree_map(lambda a, gi=gi: a[gi], jq["global_blocks"])
        out.append(("global", jax.jit(lambda x, jgp=jgp: jie._block(x, jgp, jcfg, window=False),
                                      compiler_options=opts),
                    lambda x, gp=params["global_blocks"][gi]: image_encoder._block(
                        x, gp, cfg, window=False), params["global_blocks"][gi]))
    return out


def alone_excess(jfn, xj, ya, nxt, eps) -> dict:
    """The port's block on JAX's input against the JAX block compiled
    with XLA's default, excess precision allowed."""
    yx = jfn(xj)
    return {"alone_excess_max_rel": rel(ya, yx)[0], "alone_excess_median_rel": rel(ya, yx)[1],
            "alone_excess_codes_differ": int((ln1_codes(ya, nxt, eps) != ln1_codes(yx, nxt,
                                                                                     eps)).sum())}


def rel(got, ref):
    err, top = np.abs(_np(got) - _np(ref)), np.abs(_np(ref)).max()
    return float(err.max() / top), float(np.median(err) / top)


@torch.no_grad()
def measure(hd: int, dots_i8: bool) -> dict:
    jcfg, jq, cfg, params, img = build(hd, dots_i8)
    eps = cfg.layer_norm_eps
    g, C, P = cfg.grid, cfg.embed_dim, cfg.patch_size
    # The patch embedding, once, on the JAX side; both chains start there.
    x = jnp.asarray(img).reshape(1, g, P, g, P, 3).transpose(0, 1, 3, 5, 2, 4).reshape(
        1, g * g, 3 * P * P)
    x = (jquant.apply_linear(x, jq["patch_proj"]) + jq["patch_bias"]).reshape(1, g, g, C)
    x0 = np.asarray(x + jq["pos_embed"][None])
    xj, xt = jnp.asarray(x0), torch.from_numpy(x0.copy())
    rows = []
    excess = blocks(jcfg, jq, cfg, params, None)
    for i, (kind, jfn, tfn, p) in enumerate(blocks(jcfg, jq, cfg, params)):
        cj, ct = ln1_codes(xj, p, eps), ln1_codes(xt, p, eps)
        normed, cjax, amax = ln1_values_jax(xj, p, eps)
        ctie = ln1_codes(xj, p, eps)
        flips = np.argwhere(cjax != ctie)
        frac = np.abs((normed * (127.0 / amax)) % 1.0 - 0.5)
        yj = jfn(xj)
        yt = tfn(xt)
        ya = tfn(torch.from_numpy(np.asarray(xj).copy()))
        nxt = params["window_blocks" if kind == "global" else "global_blocks"][0]
        rows.append({
            "block": i, "kind": kind, "codes": int(cj.size),
            "codes_differ": int((cj != ct).sum()),
            "codes_differ_by_more_than_1": int((np.abs(cj.astype(int) - ct) > 1).sum()),
            "max_rel": rel(yt, yj)[0], "median_rel": rel(yt, yj)[1],
            "alone_max_rel": rel(ya, yj)[0], "alone_median_rel": rel(ya, yj)[1],
            "alone_codes_differ": int((ln1_codes(ya, nxt, eps) != ln1_codes(yj, nxt, eps)).sum()),
            **alone_excess(excess[i][1], xj, ya, nxt, eps),
            "tie_flips": int(len(flips)),
            "tie_within": bool(all(frac[tuple(f)] < 1e-4 for f in flips)),
        })
        xj, xt = yj, yt
    got = image_encoder.encode(params, cfg, torch.from_numpy(img)).numpy()
    out = {"hd": hd, "dots_i8": dots_i8, "blocks": rows}
    for key, opts in (("", EXACT), ("_excess_precision", None)):
        ref = np.asarray(jax.jit(jie.encode, static_argnums=1, compiler_options=opts)(
            jq, jcfg, jnp.asarray(img)))
        err, top = np.abs(got - ref), np.abs(ref).max()
        out[f"encode_max_rel{key}"] = float(err.max() / top)
        out[f"encode_median_rel{key}"] = float(np.median(err) / top)
    return out


def main() -> int:
    torch.set_num_threads(1)
    for hd in (64, 80):
        for dots_i8 in (False, True):
            print(json.dumps(measure(hd, dots_i8)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
