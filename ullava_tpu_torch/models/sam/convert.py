"""SAM checkpoint conversion -> the port's SAM parameters (counterpart of
`ullava_tpu/models/sam/convert.py`).

Accepts the original Meta naming (`sam_vit_h_4b8939.pth`,
`sam_vit_l_0b3195.pth`, `sam_vit_b_01ec64.pth`) or the HF `SamModel`
naming: HF keys are first normalized to the Meta vocabulary, then
converted once, straight into the port's layout (one dict per encoder
block in `window_blocks` / `global_blocks`, as `bridge.py` gives a JAX
tree). Depth, width and the global blocks' indexes come from the
`SamConfig` passed in (`build.sam_vit_h`, `sam_vit_l`, `sam_vit_b`).

Every leaf is read: the image encoder's, the prompt encoder's
(random-Fourier matrix, the four point embeddings, `not_a_point_embed`,
`no_mask_embed` and `mask_downscaling.*`) and the mask decoder's.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import torch

from ullava_tpu_torch import resolve_device
from ullava_tpu_torch.models.sam.build import SamConfig

_HF_RULES = [
    (r"^vision_encoder\.", "image_encoder."),
    (r"^prompt_encoder\.shared_embedding\.positional_embedding$",
     "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"),
    (r"^prompt_encoder\.point_embed\.(\d)\.", r"prompt_encoder.point_embeddings.\1."),
    (r"^prompt_encoder\.mask_embed\.conv1\.", "prompt_encoder.mask_downscaling.0."),
    (r"^prompt_encoder\.mask_embed\.layer_norm1\.", "prompt_encoder.mask_downscaling.1."),
    (r"^prompt_encoder\.mask_embed\.conv2\.", "prompt_encoder.mask_downscaling.3."),
    (r"^prompt_encoder\.mask_embed\.layer_norm2\.", "prompt_encoder.mask_downscaling.4."),
    (r"^prompt_encoder\.mask_embed\.conv3\.", "prompt_encoder.mask_downscaling.6."),
    (r"^mask_decoder\.upscale_conv1\.", "mask_decoder.output_upscaling.0."),
    (r"^mask_decoder\.upscale_layer_norm\.", "mask_decoder.output_upscaling.1."),
    (r"^mask_decoder\.upscale_conv2\.", "mask_decoder.output_upscaling.3."),
    (r"\.layer_norm_final_attn\.", ".norm_final_attn."),
    (r"\.layer_norm(\d)\.", r".norm\1."),
]
# Inside image_encoder (after vision_encoder rename): layers->blocks,
# projection->proj, neck names.
_ENC_RULES = [
    (r"^image_encoder\.layers\.", "image_encoder.blocks."),
    (r"^image_encoder\.patch_embed\.projection\.", "image_encoder.patch_embed.proj."),
    (r"^image_encoder\.neck\.conv1\.", "image_encoder.neck.0."),
    (r"^image_encoder\.neck\.norm1\.", "image_encoder.neck.1."),
    (r"^image_encoder\.neck\.conv2\.", "image_encoder.neck.2."),
    (r"^image_encoder\.neck\.norm2\.", "image_encoder.neck.3."),
]


def _hf_mlp_rename(key: str) -> str:
    """HF MLP (proj_in / layers.i / proj_out) -> original (layers.0..n)."""
    m = re.match(
        r"^(mask_decoder\.(?:output_hypernetworks_mlps\.\d+|iou_prediction_head))\.(.+)$",
        key,
    )
    if not m:
        return key
    base, rest = m.groups()
    if rest.startswith("proj_in."):
        return f"{base}.layers.0.{rest[len('proj_in.'):]}"
    mm = re.match(r"^layers\.(\d+)\.(.+)$", rest)
    if mm:
        return f"{base}.layers.{int(mm.group(1)) + 1}.{mm.group(2)}"
    if rest.startswith("proj_out."):
        # depth is only known per-MLP; resolved in normalize_sam_keys.
        return f"{base}.__proj_out__.{rest[len('proj_out.'):]}"
    return key


def normalize_sam_keys(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """HF SamModel naming -> original Meta naming (no-op for original)."""
    if not any(k.startswith("vision_encoder.") for k in sd):
        return dict(sd)
    out: Dict[str, Any] = {}
    pending = {}
    for k, v in sd.items():
        if k.startswith("shared_image_embedding."):
            continue  # duplicate of prompt_encoder.shared_embedding
        for pat, rep in _HF_RULES:
            k = re.sub(pat, rep, k)
        for pat, rep in _ENC_RULES:
            k = re.sub(pat, rep, k)
        k = _hf_mlp_rename(k)
        if "__proj_out__" in k:
            pending[k] = v
        else:
            out[k] = v
    # proj_out index = max existing layer index + 1 per MLP; resolve depths
    # for all bases first so weight/bias land on the same layer index.
    depths: Dict[str, int] = {}
    for k in pending:
        base = k.split(".__proj_out__.")[0]
        if base not in depths:
            idxs = [
                int(re.match(rf"^{re.escape(base)}\.layers\.(\d+)\.", kk).group(1))
                for kk in out
                if kk.startswith(base + ".layers.")
            ]
            depths[base] = (max(idxs) + 1) if idxs else 0
    for k, v in pending.items():
        base = k.split(".__proj_out__.")[0]
        out[k.replace("__proj_out__", f"layers.{depths[base]}")] = v
    return out


def convert_sam(
    sd: Mapping[str, torch.Tensor], cfg: SamConfig, dtype=None, device=None
) -> Dict[str, Any]:
    """SAM state dict (Meta or HF naming) -> `{"image_encoder",
    "prompt_encoder", "mask_decoder"}`. The image encoder takes `dtype`
    (default `cfg.vision.dtype`), the prompt encoder and the mask decoder
    fp32, as the JAX converter does."""
    sd = normalize_sam_keys(sd)
    v = cfg.vision
    device = resolve_device(device)
    enc_dtype = dtype or v.dtype

    def leaf(name, dt, transpose=False):
        t = sd[name].to(device=device, dtype=dt)
        return (t.t() if transpose else t).contiguous()

    def e(name, transpose=False):
        return leaf(name, enc_dtype, transpose)

    def f32(name, transpose=False):
        return leaf(name, torch.float32, transpose)

    # ---- image encoder ----------------------------------------------------
    def block(i):
        b = f"image_encoder.blocks.{i}."
        return {
            "ln1_scale": e(b + "norm1.weight"),
            "ln1_bias": e(b + "norm1.bias"),
            "qkv": e(b + "attn.qkv.weight", True),
            "qkv_bias": e(b + "attn.qkv.bias"),
            "proj": e(b + "attn.proj.weight", True),
            "proj_bias": e(b + "attn.proj.bias"),
            "rel_pos_h": e(b + "attn.rel_pos_h"),
            "rel_pos_w": e(b + "attn.rel_pos_w"),
            "ln2_scale": e(b + "norm2.weight"),
            "ln2_bias": e(b + "norm2.bias"),
            "fc1": e(b + "mlp.lin1.weight", True),
            "fc1_bias": e(b + "mlp.lin1.bias"),
            "fc2": e(b + "mlp.lin2.weight", True),
            "fc2_bias": e(b + "mlp.lin2.bias"),
        }

    def conv(name, dt, perm):
        return sd[name].to(device=device, dtype=dt).permute(*perm).contiguous()

    patch_w = sd["image_encoder.patch_embed.proj.weight"]  # [C, 3, p, p]
    image_encoder = {
        "patch_proj": patch_w.reshape(patch_w.shape[0], -1).to(device=device, dtype=enc_dtype)
        .t().contiguous(),
        "patch_bias": e("image_encoder.patch_embed.proj.bias"),
        "pos_embed": e("image_encoder.pos_embed")[0],
        "window_blocks": [block(i) for i in range(v.depth) if i not in v.global_attn_indexes],
        "global_blocks": [block(i) for i in v.global_attn_indexes],
        "neck_conv1": conv("image_encoder.neck.0.weight", enc_dtype, (2, 3, 1, 0))[0, 0],
        "neck_ln1_scale": e("image_encoder.neck.1.weight"),
        "neck_ln1_bias": e("image_encoder.neck.1.bias"),
        "neck_conv2": conv("image_encoder.neck.2.weight", enc_dtype, (2, 3, 1, 0)),  # HWIO
        "neck_ln2_scale": e("image_encoder.neck.3.weight"),
        "neck_ln2_bias": e("image_encoder.neck.3.bias"),
    }

    # ---- prompt encoder -----------------------------------------------------
    pe, md = "prompt_encoder.", "prompt_encoder.mask_downscaling."
    prompt_encoder = {
        "pe_gaussian": f32(pe + "pe_layer.positional_encoding_gaussian_matrix"),
        "point_embeddings": torch.stack(
            [f32(pe + f"point_embeddings.{i}.weight")[0] for i in range(4)]),
        "not_a_point": f32(pe + "not_a_point_embed.weight")[0],
        "no_mask": f32(pe + "no_mask_embed.weight")[0],
        # Conv2d weight [out, in, kh, kw] -> [kh, kw, in, out]
        "mask_conv1": conv(md + "0.weight", torch.float32, (2, 3, 1, 0)),
        "mask_conv1_bias": f32(md + "0.bias"),
        "mask_ln1_scale": f32(md + "1.weight"),
        "mask_ln1_bias": f32(md + "1.bias"),
        "mask_conv2": conv(md + "3.weight", torch.float32, (2, 3, 1, 0)),
        "mask_conv2_bias": f32(md + "3.bias"),
        "mask_ln2_scale": f32(md + "4.weight"),
        "mask_ln2_bias": f32(md + "4.bias"),
        "mask_conv3": conv(md + "6.weight", torch.float32, (2, 3, 1, 0)),
        "mask_conv3_bias": f32(md + "6.bias"),
    }

    # ---- mask decoder -------------------------------------------------------
    def lin(name):
        return {"w": f32(name + ".weight", True), "b": f32(name + ".bias")}

    def attn(base):
        return {"q": lin(base + ".q_proj"), "k": lin(base + ".k_proj"),
                "v": lin(base + ".v_proj"), "out": lin(base + ".out_proj")}

    def ln(name):
        return {"scale": f32(name + ".weight"), "bias": f32(name + ".bias")}

    def mlp(base, n):
        return {f"fc{i}": lin(f"{base}.layers.{i}") for i in range(n)}

    dd = "mask_decoder."
    tr = dd + "transformer."
    layers = []
    for i in range(cfg.decoder.depth):
        b = f"{tr}layers.{i}."
        layers.append({
            "self_attn": attn(b + "self_attn"),
            "ln1": ln(b + "norm1"),
            "cross_t2i": attn(b + "cross_attn_token_to_image"),
            "ln2": ln(b + "norm2"),
            "mlp": {"fc0": lin(b + "mlp.lin1"), "fc1": lin(b + "mlp.lin2")},
            "ln3": ln(b + "norm3"),
            "cross_i2t": attn(b + "cross_attn_image_to_token"),
            "ln4": ln(b + "norm4"),
        })
    n_hyper_layers = 3
    mask_decoder = {
        "iou_token": f32(dd + "iou_token.weight"),
        "mask_tokens": f32(dd + "mask_tokens.weight"),
        "layers": layers,
        "final_attn": attn(tr + "final_attn_token_to_image"),
        "final_ln": ln(tr + "norm_final_attn"),
        # ConvTranspose2d weight [in, out, kh, kw] -> [kh, kw, in, out]
        "upscale_conv1": conv(dd + "output_upscaling.0.weight", torch.float32, (2, 3, 0, 1)),
        "upscale_conv1_bias": f32(dd + "output_upscaling.0.bias"),
        "upscale_ln": ln(dd + "output_upscaling.1"),
        "upscale_conv2": conv(dd + "output_upscaling.3.weight", torch.float32, (2, 3, 0, 1)),
        "upscale_conv2_bias": f32(dd + "output_upscaling.3.bias"),
        "hyper_mlps": [
            mlp(dd + f"output_hypernetworks_mlps.{i}", n_hyper_layers)
            for i in range(cfg.decoder.num_mask_tokens)
        ],
        "iou_head": mlp(dd + "iou_prediction_head", cfg.decoder.iou_head_depth),
    }
    return {"image_encoder": image_encoder, "prompt_encoder": prompt_encoder,
            "mask_decoder": mask_decoder}
