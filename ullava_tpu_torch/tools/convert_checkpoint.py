"""Checkpoint pre-conversion CLI (counterpart of
`tools/convert_checkpoint.py`).

Converts released checkpoints (an HF Vicuna/LLaMA dir, an HF CLIP dir, a
Meta or HF SAM file such as `sam_vit_h_4b8939.pth`) once into the port's
checkpoint layout (`training/checkpoint.py`: a directory holding
`state.pt`), so that a build restores the tree instead of converting the
torch state dict on every start. It runs on the host and needs no card.

    python -m ullava_tpu_torch.tools.convert_checkpoint llama <hf_dir> <out_dir> [--dtype bf16]
    python -m ullava_tpu_torch.tools.convert_checkpoint clip  <hf_dir> <out_dir>
    python -m ullava_tpu_torch.tools.convert_checkpoint sam   <ckpt.pth> <out_dir> [--variant vit_h]

The output is restorable with `training.checkpoint.load_saved` /
`restore_checkpoint`, and through the `model.pretrained_*` config keys
once assembled into the composite tree those keys name.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _num_layers(hf_dir: str, vision: bool) -> int:
    with open(os.path.join(hf_dir, "config.json")) as f:
        hf = json.load(f)
    if vision:
        hf = hf.get("vision_config", hf)
    return int(hf["num_hidden_layers"])


def convert(kind: str, src: str, dtype: str = "bf16", variant: str = "vit_h"):
    """The params tree of the released checkpoint `src`, on the CPU:
    `models.llama`'s (kind "llama"), `models.clip_vit`'s ("clip") or
    `{"image_encoder", "prompt_encoder", "mask_decoder"}` of SAM `variant`
    ("sam")."""
    from ullava_tpu_torch.models.weights import (
        convert_clip_vision,
        convert_llama,
        load_state_dict,
    )

    dt = DTYPES[dtype]
    sd = load_state_dict(src)
    if kind == "llama":
        return convert_llama(sd, _num_layers(src, False), dt, device="cpu")
    if kind == "clip":
        return convert_clip_vision(sd, _num_layers(src, True), dt, device="cpu")
    if kind == "sam":
        from ullava_tpu_torch.models.sam import build as sam_build
        from ullava_tpu_torch.models.sam.convert import convert_sam

        cfg = getattr(sam_build, f"sam_{variant}")(dtype=dt)
        return convert_sam(sd, cfg, dt, device="cpu")
    raise ValueError(f"unknown checkpoint kind {kind!r}")


def main(argv=None) -> str:
    parser = argparse.ArgumentParser()
    parser.add_argument("kind", choices=["llama", "clip", "sam"])
    parser.add_argument("src")
    parser.add_argument("out")
    parser.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    parser.add_argument("--variant", default="vit_h", choices=["vit_h", "vit_l", "vit_b"])
    args = parser.parse_args(argv)

    from ullava_tpu_torch.training.checkpoint import save_tree

    tree = convert(args.kind, args.src, args.dtype, args.variant)
    out = save_tree(args.out, tree)
    print(f"converted {args.kind} checkpoint -> {out}")
    return out


if __name__ == "__main__":
    main()
