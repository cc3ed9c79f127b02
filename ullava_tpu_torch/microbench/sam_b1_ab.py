"""The B=1 SAM attention forms of ViT-L and ViT-B (K3, K14 and K11 at hd
64, bf16 and `dots_i8` scores, K11's pre-pass included; K4, the
head-major global kernel, at hd 64 in both exponential forms; K19 and
K20, the packed window and global kernels, over 64 real lanes of 128)
beside their hd 80 twins at ViT-H's serving shapes (K19's and K20's at
the packed B=4 serve's window and global blocks, K4's at the bf16 B=4
serve's 64 (image, head) pairs), for one checkout of the port, and one
`SamPredictor.set_image` at ViT-L (bf16, int8 towers, int8 towers with
`attn_dots_i8`) split into the host's resize + normalize and the encode.

    python ullava_tpu_torch/microbench/sam_b1_ab.py [--root DIR] [--no-set-image]
        [--only SUBSTRING ...]

`--root` imports `ullava_tpu_torch` from DIR instead of this checkout (the
parent commit unpacked beside it, say); the inputs and helpers come from
this checkout's `chip_smoke.py`, drawn from one generator seeded on the
card, so both versions see the same tensors. Run parent, this, this,
parent in one call to compare two versions on one card.

One `sam_b1_form` line a form: `ms` the median of five batches of 20
launches each after an L2 eviction, with the batches' least and largest
(`chip_smoke.spread_ms`, each launch queued behind a short device sleep
so that the wrapper's host time, which can exceed these kernels' own,
stays out of it); the same for SDPA with the bias as a mask at the same
shape (`sdpa_ms`; for K19 and K20 over the real lanes, and over all 128
`sdpa_128_lanes_ms`); the kernel against its plain version
(`row_rel_err`, beside the limit `chip_smoke.py` gates it with); and
`out_sha1`, a digest of the kernel's output bits, equal in two checkouts
whose kernels compute the same bits on these inputs. A checkout whose
K19 or K20 wrapper has no `head_dim` (before it contracted the real lanes
alone) runs it over all 128. `--only` keeps the forms whose name holds
one of the substrings. Before them one `sam_b1_sass` line: the
instruction counts of the hd 64 kernels (and K20's hd 80 one) in the
built libraries' SASS (`chip_smoke.sass_counts`). Then one
`sam_b1_set_image` line a weight form (median of five calls of each part,
synchronized), the card's name and power limit. It needs a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import importlib.util
import inspect
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]


def forms(cs, gen):
    """(name, run, plain, sdpa, tol) of every form this script times;
    `sdpa` is the library yardstick, or {key: yardstick}."""
    import torch
    import torch.nn.functional as F

    from ullava_tpu_torch.ops import sam_attention

    bf, W, G = torch.bfloat16, 14, 64

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(bf)

    out = []
    # K3: 16 full windows (one image) of each size at hd 64 in both score
    # forms, 196 rows and the resident layout's 200; ViT-H's serving forms
    # at B=16 (256 windows of 200 rows).
    for size, H, hd, N in (("vit_l", 16, 64, 16), ("vit_b", 12, 64, 16), ("vit_h", 16, 80, 256)):
        C, sc = H * hd, hd**-0.5
        for rows in ((196, 200) if hd == 64 else (200,)):
            y = randn(N, rows, 3 * C)
            a, bb = (randn(N, rows, H * W, scale=2.0 / sc) for _ in range(2))
            a[:, 196:], bb[:, 196:] = 0, 0
            lib = cs.window_sdpa_inputs(y, a, bb, y, torch.arange(rows, device="cuda") < 196,
                                        (C, H, hd, W))
            for i8 in (False, True):
                kw = dict(num_heads=H, head_dim=hd, window=W, scale=sc, dots_i8=i8)
                out.append((
                    f"fused_window_attention_grid{'_i8' if i8 else ''}{'_hd64' if hd == 64 else ''}"
                    f" {size} {N} x {rows}",
                    lambda y=y, a=a, bb=bb, kw=kw, r=rows: sam_attention.fused_window_attention_grid(
                        y, a, bb, **kw, total_rows=0 if r == 196 else r)[:, :196],
                    lambda y=y, a=a, bb=bb, kw=kw: sam_attention.fused_window_attention_grid_plain(
                        y, a, bb, kw["num_heads"], kw["head_dim"], W, kw["scale"],
                        kw["dots_i8"])[:, :196],
                    lambda l=lib: cs.window_sdpa(*l), 1e-2))
    # K19: ViT-L's and ViT-B's 25 padded windows (one image, block layout)
    # at 64 real lanes of 128; ViT-H's window block of the packed B=4 serve.
    packed = sam_attention.fused_window_attention_packed
    real_lanes = "head_dim" in inspect.signature(packed).parameters
    for size, H, hd, N in (("vit_l", 16, 64, 25), ("vit_b", 12, 64, 25), ("vit_h", 16, 80, 100)):
        sc = hd**-0.5
        y = torch.zeros((N, W * W, 3, H, cs.SAM_HP), dtype=bf, device="cuda")
        y[..., :hd] = randn(N, W * W, 3, H, hd)
        y = y.reshape(N, W * W, 3 * H * cs.SAM_HP)
        a, bb = (randn(N, H, W * W, W, scale=2.0) for _ in range(2))
        lanes = {"head_dim": hd} if real_lanes else {}
        sdpa = {}
        for key, n in (("sdpa_ms", hd), ("sdpa_128_lanes_ms", cs.SAM_HP)):
            y5, mask = cs.packed_sdpa_inputs(y, a, bb, H, cs.SAM_HP, n)
            sdpa[key] = lambda y5=y5, m=mask, sc=sc: F.scaled_dot_product_attention(
                y5[0], y5[1], y5[2], attn_mask=m, scale=sc)
        out.append((
            f"fused_window_attention_packed {size} hd{hd} [{N}, 196, {3 * H * cs.SAM_HP}]",
            lambda y=y, a=a, bb=bb, H=H, sc=sc, kw=lanes: packed(y, a, bb, H, cs.SAM_HP, W, sc,
                                                                 **kw),
            lambda y=y, a=a, bb=bb, H=H, sc=sc: sam_attention.fused_window_attention_packed_plain(
                y, a, bb, H, cs.SAM_HP, W, sc),
            sdpa, 1e-2))
    # K14: every geometry of each size at hd 64 (B=1: 4 windows of each edge,
    # one corner), both score forms; ViT-H's merged pair and corner at B=16.
    sizes = (("vit_l", 16, 64), ("vit_b", 12, 64), ("vit_h", 16, 80))
    geoms = {"right": ([(14, 8)], 4), "bottom": ([(8, 14)], 4), "corner": ([(8, 8)], 1),
             "edge_pair": ([(14, 8), (8, 14)], 4)}
    for size, H, hd in sizes:
        C, sc = H * hd, hd**-0.5
        qkv_bias = randn(3 * C, scale=0.5)
        for geo, (gs, per) in geoms.items():
            if hd == 80:
                if geo in ("right", "bottom"):
                    continue
                per *= cs.B_INT8
            case = cs.rect_case(gen, gs, per, qkv_bias, (C, H, hd, W))
            y, a, bb, tables, padded, _ = case
            geometry = tuple(gs) if len(gs) == 2 else gs[0]
            lib = cs.window_sdpa_inputs(y, a, bb, padded,
                                        torch.ones(W * W, dtype=torch.bool, device="cuda"),
                                        (C, H, hd, W))
            for i8 in (False, True):
                kw = dict(num_heads=H, head_dim=hd, window=W, scale=sc, dots_i8=i8)
                out.append((
                    f"fused_window_attention_rect{'_i8' if i8 else ''}{'_hd64' if hd == 64 else ''}"
                    f" {size} {geo}",
                    lambda y=y, a=a, bb=bb, t=tables, g_=geometry, kw=kw:
                        sam_attention.fused_window_attention_rect(y, a, bb, *t, **kw, geometry=g_),
                    lambda y=y, a=a, bb=bb, t=tables, kw=kw:
                        sam_attention.fused_window_attention_rect_plain(
                            y, a, bb, *t, kw["num_heads"], kw["head_dim"], W, kw["scale"],
                            kw["dots_i8"]),
                    lambda l=lib: cs.window_sdpa(*l), 1e-2))
    # K11: one global block at ViT-L and ViT-B (B=1), ViT-H's at B=16.
    for size, H, hd, Bn in (("vit_l", 16, 64, 1), ("vit_b", 12, 64, 1), ("vit_h", 16, 80, 16)):
        C, sc, S = H * hd, hd**-0.5, G * G
        y = randn(Bn, S, 3 * C)
        a, bb = (randn(Bn, S, H, G, scale=2.0 / sc) for _ in range(2))
        y5, mask = cs.global_sdpa_inputs(y, a, bb)
        for dots in (False, True):
            for exp_bf16 in (True, False):
                kw = dict(num_heads=H, head_dim=hd, window=G, scale=sc, exp_bf16=exp_bf16,
                          dots_i8=dots)
                name = (f"fused_global_attention_y{'_i8' if dots else ''}"
                        f"{'_hd64' if hd == 64 else ''} {size} "
                        f"{'exp_bf16' if exp_bf16 else 'exp_fp32'}")
                out.append((
                    name,
                    lambda y=y, a=a, bb=bb, kw=kw: sam_attention.fused_global_attention_y(
                        y, a, bb, **kw),
                    lambda y=y, a=a, bb=bb, kw=kw: sam_attention.fused_global_attention_y_plain(
                        y, a, bb, **kw),
                    lambda y5=y5, m=mask, sc=sc: F.scaled_dot_product_attention(
                        y5[0], y5[1], y5[2], attn_mask=m, scale=sc),
                    2e-2 if exp_bf16 else 1e-2))
            if dots:
                out.append((
                    f"global_attention_y_quant_i8{'_hd64' if hd == 64 else ''} {size}",
                    lambda y=y, a=a, bb=bb, H=H, hd=hd: sam_attention.global_y_quant_i8(
                        y, a, bb, H, hd),
                    None, None, 0.0))
    # K4: one global block of ViT-L and ViT-B (16 and 12 (image, head)
    # pairs of hd 64), ViT-H's at B=4 (64 pairs of hd 80); the bias terms
    # from `decomposed_bias_terms` of the unscaled q, as the encoder makes
    # them.
    S = G * G
    for size, N, hd in (("vit_l", 16, 64), ("vit_b", 12, 64), ("vit_h", 64, 80)):
        sc = hd**-0.5
        q, k, v = (randn(N, S, hd) for _ in range(3))
        rel_h, rel_w = (randn(2 * G - 1, hd, scale=0.25) for _ in range(2))
        a, bb = (t.reshape(N, S, G).to(bf) for t in sam_attention.decomposed_bias_terms(
            q.reshape(1, N, G, G, hd), rel_h, rel_w, G))
        gmask = (a.float()[:, :, :, None] + bb.float()[:, :, None, :]).reshape(N, S, S).to(bf)
        for exp_bf16 in (False, True):
            args = (q, k, v, a, bb, G, sc)
            out.append((
                f"fused_global_attention{'_hd64' if hd == 64 else ''} {size} {N} x 4096 "
                f"{'exp_bf16' if exp_bf16 else 'exp_fp32'}",
                lambda args=args, e=exp_bf16: sam_attention.fused_global_attention(
                    *args, exp_bf16=e),
                lambda args=args, e=exp_bf16: sam_attention.fused_global_attention_plain(
                    *args, exp_bf16=e),
                lambda q=q, k=k, v=v, m=gmask, sc=sc: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=m, scale=sc),
                2e-2 if exp_bf16 else 1e-2))
    # K20: one packed global block of ViT-L and ViT-B (B=1, 64 real lanes
    # of 128) and the packed ViT-H B=4 serve's (80 of 128).
    packed_g = sam_attention.fused_global_attention_packed
    g_lanes = "head_dim" in inspect.signature(packed_g).parameters
    for size, H, hd, Bn in (("vit_l", 16, 64, 1), ("vit_b", 12, 64, 1), ("vit_h", 16, 80, 4)):
        sc = hd**-0.5
        y = torch.zeros((Bn, S, 3, H, cs.SAM_HP), dtype=bf, device="cuda")
        y[..., :hd] = randn(Bn, S, 3, H, hd)
        y = y.reshape(Bn, S, 3 * H * cs.SAM_HP)
        a, bb = (randn(Bn, H, S, G, scale=2.0) for _ in range(2))
        lanes = {"head_dim": hd} if g_lanes else {}
        sdpa = {}
        for key, n in (("sdpa_ms", hd), ("sdpa_128_lanes_ms", cs.SAM_HP)):
            y5, mask = cs.packed_sdpa_inputs(y, a, bb, H, cs.SAM_HP, n)
            sdpa[key] = lambda y5=y5, m=mask, sc=sc: F.scaled_dot_product_attention(
                y5[0], y5[1], y5[2], attn_mask=m, scale=sc)
        out.append((
            f"fused_global_attention_packed {size} hd{hd} [{Bn}, 4096, {3 * H * cs.SAM_HP}]",
            lambda y=y, a=a, bb=bb, H=H, sc=sc, kw=lanes: packed_g(y, a, bb, H, cs.SAM_HP, G, sc,
                                                                   **kw),
            lambda y=y, a=a, bb=bb, H=H, sc=sc: sam_attention.fused_global_attention_packed_plain(
                y, a, bb, H, cs.SAM_HP, G, sc),
            sdpa, 1e-2))
    return out


def digest(out) -> str:
    """sha1 of the bits of a tensor or a nested tuple of tensors."""
    import torch

    h = hashlib.sha1()
    for t in torch.utils._pytree.tree_leaves(out):
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def set_image_lines(cs, gen, card: str) -> list:
    """`set_image` at ViT-L in each weight form: host resize + normalize
    (to the card) and encode, each the median of five synchronized calls."""
    import numpy as np
    import torch

    from ullava_tpu_torch.models import weights
    from ullava_tpu_torch.models.sam import build, image_encoder, predictor
    from ullava_tpu_torch.models.sam.convert import convert_sam
    from ullava_tpu_torch.ops import quant

    image = np.random.default_rng(24).integers(0, 256, (*cs.SAM_PRED_HW, 3), dtype=np.uint8)
    with tempfile.TemporaryDirectory(prefix="sam_b1_ab_") as root:
        sd = weights.load_state_dict(cs.write_sam_checkpoint(root, "vit_l", gen))
    converted = convert_sam(sd, build.sam_vit_l(torch.bfloat16), device="cuda")
    del sd
    int8 = None
    lines = []
    for form in ("bf16", "int8", "int8_i8"):
        cfg = build.sam_vit_l(torch.bfloat16)
        params = dict(converted)
        if form != "bf16":
            if int8 is None:
                int8 = image_encoder.precompute_window_bias_weights(quant.quantize_tree(
                    params["image_encoder"], ("qkv", "proj", "fc1", "fc2")), cfg.vision)
            params["image_encoder"] = int8
            cfg = dataclasses.replace(cfg, vision=dataclasses.replace(
                cfg.vision, mlp_w8a8=True, attn_dots_i8=form == "int8_i8"))
        pred = predictor.SamPredictor(params, cfg, device="cuda")
        pred.set_image(image)
        host, enc, whole = [], [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pre = torch.as_tensor(pred.seg_tool.preprocess(pred.seg_tool.apply_image(image))[None],
                                  device="cuda")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            image_encoder.encode(params["image_encoder"], cfg.vision, pre)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            pred.set_image(image)
            torch.cuda.synchronize()
            host.append(t1 - t0)
            enc.append(t2 - t1)
            whole.append(time.perf_counter() - t2)
        line = {"phase": "sam_b1_set_image", "weights": form, "size": "vit_l",
                "host_resize_normalize_s": sorted(host)[2], "encode_s": sorted(enc)[2],
                "set_image_s": sorted(whole)[2], "encode_s_min_max": [min(enc), max(enc)],
                "card": card}
        print(json.dumps(line), flush=True)
        lines.append(line)
        del pred
        torch.cuda.empty_cache()
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--no-set-image", action="store_true")
    ap.add_argument("--only", nargs="*", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        print("sam_b1_ab: needs a card", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    from ullava_tpu_torch import kernels

    kernels.build_all()
    card = cs.card_name_and_power_limit()
    ops = ("HGMMA", "IGMMA", "UTMALDG", "MUFU", "HMMA", "IMMA")
    print(json.dumps({"phase": "sam_b1_sass", "root": args.root, **{
        name: cs.sass_counts(src, fn, ops) for name, src, fn in (
            ("k3_hd64", "sam_window_attention.cu", "window_whole_kernelILi64E"),
            ("k19", "sam_packed_attention.cu", "window_whole_kernel"),
            ("k14_hd64", "sam_rect_attention.cu", "ILi64ELi14E"),
            ("k11_hd64", "sam_global_attention_y.cu", "GlobalYILi64E"),
            ("k11_hd64_pre_pass", "sam_global_attention_y.cu", "global_y_quant_i8_kernelILi64E"),
            ("k4_hd64", "sam_global_attention.cu", "HeadMajorGlobalILi64E"),
            ("k20_hd64", "sam_packed_attention.cu", "PackedGlobalILi64E"),
            ("k20_hd80", "sam_packed_attention.cu", "PackedGlobalILi80E"),
            ("k20", "sam_packed_attention.cu", "PackedGlobal"))}}),
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(28)
    for name, run, plain, sdpa, tol in forms(cs, gen):
        if args.only is not None and not any(o in name for o in args.only):
            continue
        line = {"phase": "sam_b1_form", "form": name, "root": args.root}
        if plain is not None:
            line.update(row_rel_err=cs.row_rel_err(run(), plain()), tol=tol)
        line["out_sha1"] = digest(run())
        line.update(cs.spread_ms(run))
        for key, fn in ({"sdpa_ms": sdpa} if callable(sdpa) else sdpa or {}).items():
            line[key] = cs.spread_ms(fn)
        line["card"] = card
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    if not args.no_set_image:
        set_image_lines(cs, gen, card)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
