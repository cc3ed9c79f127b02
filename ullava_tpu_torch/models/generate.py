"""Greedy decoding with a KV cache, per-sample stop and hidden readout
(counterpart of `ullava_tpu/models/generate.py`).

- the JAX `lax.while_loop` becomes a Python loop that stops after
  `max_new_tokens` steps or when every sample has emitted a stop token;
- right-padded ragged prompts decode natively: each sample writes its
  next token at its own `lens[b]` cache slot;
- last-layer hidden states are captured for every position, aligned so
  `hidden_last[b, j]` produced `sequences[b, j+1]` (the [SEG]/[LOC]
  readout contract).

Only greedy decoding is ported; sampling (temperature, top-p) waits.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ullava_tpu_torch.models import llama, ullava_core
from ullava_tpu_torch.ops.quant import apply_linear


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    max_new_tokens: int = 32
    stop_token_ids: Tuple[int, ...] = ()  # usually (eos_id,) + keyword ids
    # Real vocabulary size when the embedding/lm_head tables are padded:
    # logits at ids >= vocab_size can never be emitted.
    vocab_size: Optional[int] = None


def sample_token(logits: torch.Tensor, gen: GenerateConfig) -> torch.Tensor:
    """[B, V] logits -> [B] int32 token ids (greedy)."""
    if gen.vocab_size is not None and gen.vocab_size < logits.shape[-1]:
        pad = torch.arange(logits.shape[-1], device=logits.device) >= gen.vocab_size
        logits = logits.masked_fill(pad[None, :], float("-inf"))
    return logits.argmax(-1).to(torch.int32)


@torch.no_grad()
def generate(
    params: Dict,
    cfg: ullava_core.UllavaCoreConfig,
    gen: GenerateConfig,
    *,
    input_ids: torch.Tensor,  # [B, S] right-padded prompts
    prompt_lens: torch.Tensor,  # [B] true prompt lengths
    images: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Returns sequences [B, S+new] (prompt + generated, right-padded with
    0), lengths [B], hidden_last [B, S+new, D]."""
    B, S = input_ids.shape
    total = S + gen.max_new_tokens
    dev = input_ids.device
    stops = torch.tensor(gen.stop_token_ids or (-1,), dtype=torch.int32, device=dev)

    cache = llama.init_kv_cache(cfg.llm, B, total, device=dev)
    embeds = ullava_core.embed_multimodal(params, cfg, input_ids, images)
    pre = llama.forward(
        params["llm"], cfg.llm, inputs_embeds=embeds, kv_lens=prompt_lens,
        kv_cache=cache, compute_logits=False,
    )
    b_idx = torch.arange(B, device=dev)
    lens = prompt_lens.to(torch.int32)
    # Logits only at each sample's last prompt position.
    h_last = pre["hidden_states"][b_idx, lens.long() - 1]
    tok = sample_token(
        apply_linear(h_last.to(cfg.llm.dtype), params["llm"]["lm_head"]).float(), gen
    )

    seq = torch.zeros((B, total), dtype=torch.int32, device=dev)
    seq[:, :S] = input_ids.to(torch.int32)
    hidden = torch.zeros(
        (B, total, cfg.llm.hidden_size), dtype=pre["hidden_states"].dtype, device=dev
    )
    hidden[:, :S] = pre["hidden_states"]
    done = torch.zeros(B, dtype=torch.bool, device=dev)

    for _ in range(gen.max_new_tokens):
        if bool(done.all()):
            break
        write = ~done & (lens < total)
        pos = lens.clamp(max=total - 1).long()
        seq[b_idx, pos] = torch.where(write, tok, seq[b_idx, pos])
        done = done | (tok[:, None] == stops[None, :]).any(-1)
        new_lens = torch.where(write, lens + 1, lens)
        out = llama.forward(
            params["llm"], cfg.llm, input_ids=tok[:, None].long(),
            positions=lens[:, None], kv_lens=new_lens, kv_cache=cache,
            write_pos=lens.long(),
        )
        h_step = out["hidden_states"][:, 0]
        hidden[b_idx, pos] = torch.where(write[:, None], h_step, hidden[b_idx, pos])
        tok = sample_token(out["logits"][:, 0], gen)
        lens = new_lens
    return {"sequences": seq, "lengths": lens, "hidden_last": hidden}


def readout_token_hidden(
    sequences: torch.Tensor,  # [B, T]
    hidden_last: torch.Tensor,  # [B, T, D]
    lengths: torch.Tensor,  # [B]
    token_id: int,
    max_tokens: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hidden states that PRODUCED the first `max_tokens` occurrences of
    `token_id`: a token at position p was produced by hidden_last[:, p-1].
    Returns ([B, max_tokens, D] gather, [B, max_tokens] validity)."""
    B, T = sequences.shape
    pos = torch.arange(T, device=sequences.device).expand(B, T)
    valid = (sequences == token_id) & (pos >= 1) & (pos < lengths[:, None])
    key = torch.where(valid, pos, torch.full_like(pos, T + 1))
    order = torch.argsort(key, dim=1, stable=True)[:, :max_tokens]
    picked_valid = torch.gather(valid, 1, order)
    idx = (order - 1).clamp(min=0)
    h = torch.gather(hidden_last, 1, idx[..., None].expand(B, idx.shape[1], hidden_last.shape[-1]))
    return h, picked_valid
