"""Token and embedding utilities (counterpart of `ullava_tpu/models/tools.py`).

- vocabulary growth with mean-initialized rows for new special tokens (in
  the input embeddings and in lm_head) - `smart_resize_token_embedding`;
- the multimodal variant that adds the patch tokens WITHOUT
  mean-averaging, then the start/end tokens WITH it
  (`multi_modal_resize_token_embedding`);
- `pad_vocab_to_multiple`, which zero-pads the tables (a bf16 or an int8
  lm_head) to an aligned vocabulary;
- keyword stopping: stop strings resolved to token ids for the
  token-level stop of `models/generate.py`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ullava_tpu_torch.ops.quant import column_major, is_quantized


def _grow(matrix: torch.Tensor, n_new: int, axis: int, mean_init: bool) -> torch.Tensor:
    """Append n_new rows (axis 0) or columns (axis 1). New entries are the
    mean of the existing ones, or with mean_init=False 0.02-scaled noise
    from numpy's generator seeded 0, the JAX package's draw (training
    overwrites or trains those rows)."""
    if n_new <= 0:
        return matrix
    if mean_init:
        fill = matrix.float().mean(dim=axis, keepdim=True)
        fill = fill.repeat_interleave(n_new, dim=axis).to(matrix.dtype)
    else:
        shape = list(matrix.shape)
        shape[axis] = n_new
        noise = (0.02 * np.random.default_rng(0).standard_normal(shape)).astype(np.float32)
        fill = torch.from_numpy(noise).to(device=matrix.device, dtype=matrix.dtype)
    return torch.cat([matrix, fill], dim=axis)


def resize_token_embeddings(
    llm_params: Dict[str, Any], new_vocab: int, mean_init: bool = True
) -> Dict[str, Any]:
    """Grow embed_tokens [V, D] and lm_head [D, V] to new_vocab (a table
    that already covers it is left as it is)."""
    n_new = new_vocab - llm_params["embed_tokens"].shape[0]
    out = dict(llm_params)
    if n_new <= 0:
        return out
    out["embed_tokens"] = _grow(llm_params["embed_tokens"], n_new, 0, mean_init)
    out["lm_head"] = _grow(llm_params["lm_head"], n_new, 1, mean_init)
    return out


def smart_resize_token_embedding(
    new_tokens: Sequence[str], tokenizer, llm_params: Dict[str, Any]
) -> Tuple[Dict[str, Any], int]:
    """Add tokens to the tokenizer; mean-init their embeddings."""
    num_new = tokenizer.add_tokens(list(new_tokens))
    return resize_token_embeddings(llm_params, len(tokenizer), mean_init=True), num_new


def multi_modal_resize_token_embedding(
    mm_tokens: Dict[str, str], tokenizer, llm_params: Dict[str, Any]
) -> Tuple[Dict[str, Any], Dict[str, int]]:
    """Patch tokens first (no averaging), then start/end tokens with
    mean-init; returns (params, name -> token id)."""
    tokenizer.add_tokens([mm_tokens["IMG_PATCH"], mm_tokens["VID_PATCH"]])
    params = resize_token_embeddings(llm_params, len(tokenizer), mean_init=False)
    tokenizer.add_tokens([mm_tokens["IMG_START"], mm_tokens["IMG_END"],
                          mm_tokens["VID_START"], mm_tokens["VID_END"]])
    params = resize_token_embeddings(params, len(tokenizer), mean_init=True)
    return params, {k: tokenizer.convert_tokens_to_ids(v) for k, v in mm_tokens.items()}


def pad_vocab_to_multiple(
    llm_params: Dict[str, Any], multiple: int = 128
) -> Tuple[Dict[str, Any], int]:
    """Zero-pad embed_tokens rows and lm_head columns up to a multiple of
    `multiple`. Returns (params, real_vocab); thread real_vocab into
    `GenerateConfig.vocab_size` so that pad ids are never emitted. An int8
    lm_head pads `q` with 0 (kept column-major) and its scale with 1."""
    emb = llm_params["embed_tokens"]
    real_vocab = emb.shape[0]
    n_new = -real_vocab % multiple
    out = dict(llm_params)
    if n_new == 0:
        return out, real_vocab
    out["embed_tokens"] = torch.cat([emb, emb.new_zeros((n_new, emb.shape[1]))])
    head = llm_params["lm_head"]
    if is_quantized(head):
        q, scale = head["q"], head["scale"]
        out["lm_head"] = {
            "q": column_major(torch.cat([q, q.new_zeros((q.shape[0], n_new))], dim=1)),
            "scale": torch.cat([scale, scale.new_ones(scale.shape[:-1] + (n_new,))], dim=-1),
        }
    else:
        out["lm_head"] = torch.cat([head, head.new_zeros((head.shape[0], n_new))], dim=1)
    return out, real_vocab


def keyword_stop_ids(tokenizer, keywords: Sequence[str]) -> Tuple[int, ...]:
    """Keywords -> single-token ids for token-level stopping. A keyword of
    several tokens stops on its last one; the tokenizer's EOS is added."""
    ids: List[int] = []
    for kw in keywords:
        kid = tokenizer.convert_tokens_to_ids(kw)
        if kid is not None and kid != getattr(tokenizer, "unk_token_id", None):
            ids.append(int(kid))
            continue
        toks = [t for t in tokenizer(kw)["input_ids"]
                if t != getattr(tokenizer, "bos_token_id", None)]
        if toks:
            ids.append(int(toks[-1]))
    eos = getattr(tokenizer, "eos_token_id", None)
    if eos is not None and eos not in ids:
        ids.append(int(eos))
    return tuple(ids)
