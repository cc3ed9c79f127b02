"""Checkpoint conversion: HF state dicts -> the port's parameter trees
(counterpart of `ullava_tpu/models/weights.py`).

Converts released checkpoints (Vicuna-7B LLaMA, CLIP ViT-L/14) into the
port's layout: torch `Linear` stores [out, in], the port [in, out], and
per-layer tensors become one dict per layer in a list, the layout that
`bridge.py` gives a JAX tree (nothing is stacked on the way).

`load_state_dict` reads a checkpoint directory, a sharded
`model.safetensors.index.json` set, `.safetensors` files and
`.bin` / `.pth` files. The `.safetensors` format is read here (an 8-byte
little-endian header length, a JSON header, then the raw bytes of each
tensor), bf16 included, without the `safetensors` package.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Mapping

import torch

from ullava_tpu_torch import resolve_device

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
    "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
    "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """One `.safetensors` file -> CPU tensors. They are views of one
    buffer that holds the file's data, which lives as long as any of them."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - n)
        f.readinto(data)
    header.pop("__metadata__", None)
    out = {}
    for name, info in header.items():
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        shape = info["shape"]
        begin, end = info["data_offsets"]
        if begin == end:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        count = (end - begin) // dtype.itemsize
        out[name] = torch.frombuffer(data, dtype=dtype, count=count, offset=begin).reshape(shape)
    return out


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Load one or many checkpoint shards into a CPU state dict, dtypes
    as stored."""
    if os.path.isdir(path):
        index = os.path.join(path, "model.safetensors.index.json")
        if os.path.exists(index):
            with open(index) as f:
                shards = sorted(set(json.load(f)["weight_map"].values()))
            files = [os.path.join(path, s) for s in shards]
        else:
            files = sorted(
                os.path.join(path, f) for f in os.listdir(path)
                if f.endswith((".safetensors", ".bin", ".pth"))
            )
        out: Dict[str, torch.Tensor] = {}
        for f in files:
            out.update(load_state_dict(f))
        return out
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if "state_dict" in sd and isinstance(sd["state_dict"], Mapping):
        sd = sd["state_dict"]
    return dict(sd)


def _leaf(sd, name, dtype, device, transpose=False) -> torch.Tensor:
    """One converted tensor: moved, cast, and transposed from [out, in]
    to [in, out] when asked, stored contiguous."""
    t = sd[name].to(device=device, dtype=dtype)
    return (t.t() if transpose else t).contiguous()


def convert_llama(
    sd: Mapping[str, torch.Tensor],
    num_layers: int,
    dtype=torch.bfloat16,
    prefix: str = "",
    device=None,
) -> Dict[str, Any]:
    """HF LlamaForCausalLM state dict -> `models.llama` params."""
    device = resolve_device(device)
    p = prefix

    def leaf(name, transpose=False):
        return _leaf(sd, p + name, dtype, device, transpose)

    def layer(i):
        b = f"model.layers.{i}."
        return {
            "input_norm": leaf(b + "input_layernorm.weight"),
            "q_proj": leaf(b + "self_attn.q_proj.weight", True),
            "k_proj": leaf(b + "self_attn.k_proj.weight", True),
            "v_proj": leaf(b + "self_attn.v_proj.weight", True),
            "o_proj": leaf(b + "self_attn.o_proj.weight", True),
            "post_norm": leaf(b + "post_attention_layernorm.weight"),
            "gate_proj": leaf(b + "mlp.gate_proj.weight", True),
            "up_proj": leaf(b + "mlp.up_proj.weight", True),
            "down_proj": leaf(b + "mlp.down_proj.weight", True),
        }

    return {
        "embed_tokens": leaf("model.embed_tokens.weight"),
        "layers": [layer(i) for i in range(num_layers)],
        "norm": leaf("model.norm.weight"),
        "lm_head": leaf("lm_head.weight", True),
    }


def convert_clip_vision(
    sd: Mapping[str, torch.Tensor],
    num_layers: int,
    dtype=torch.bfloat16,
    prefix: str = "vision_model.",
    device=None,
) -> Dict[str, Any]:
    """HF CLIPVisionModel state dict -> `models.clip_vit` params."""
    device = resolve_device(device)
    p = prefix

    def leaf(name, transpose=False):
        return _leaf(sd, p + name, dtype, device, transpose)

    def layer(i):
        b = f"encoder.layers.{i}."
        out = {}
        for ours, theirs, transpose in (
            ("ln1_scale", "layer_norm1.weight", False), ("ln1_bias", "layer_norm1.bias", False),
            ("q_proj", "self_attn.q_proj.weight", True), ("q_bias", "self_attn.q_proj.bias", False),
            ("k_proj", "self_attn.k_proj.weight", True), ("k_bias", "self_attn.k_proj.bias", False),
            ("v_proj", "self_attn.v_proj.weight", True), ("v_bias", "self_attn.v_proj.bias", False),
            ("out_proj", "self_attn.out_proj.weight", True),
            ("out_bias", "self_attn.out_proj.bias", False),
            ("ln2_scale", "layer_norm2.weight", False), ("ln2_bias", "layer_norm2.bias", False),
            ("fc1", "mlp.fc1.weight", True), ("fc1_bias", "mlp.fc1.bias", False),
            ("fc2", "mlp.fc2.weight", True), ("fc2_bias", "mlp.fc2.bias", False),
        ):
            out[ours] = leaf(b + theirs, transpose)
        return out

    conv_w = sd[p + "embeddings.patch_embedding.weight"]  # [D, 3, ph, pw]
    return {
        "class_embedding": leaf("embeddings.class_embedding"),
        # (C, ph, pw) flatten order, as `clip_vit.patchify` lays patches out.
        "patch_proj": conv_w.reshape(conv_w.shape[0], -1).to(device=device, dtype=dtype)
        .t().contiguous(),
        "position_embedding": leaf("embeddings.position_embedding.weight"),
        "pre_ln": {"scale": leaf("pre_layrnorm.weight"), "bias": leaf("pre_layrnorm.bias")},
        "layers": [layer(i) for i in range(num_layers)],
        "post_ln": {"scale": leaf("post_layernorm.weight"), "bias": leaf("post_layernorm.bias")},
    }
