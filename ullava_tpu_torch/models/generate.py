"""Decoding with a KV cache, per-sample stop and hidden readout
(counterpart of `ullava_tpu/models/generate.py`).

- the JAX `lax.while_loop` becomes a Python loop that stops after
  `max_new_tokens` steps or when every sample has emitted a stop token;
- greedy or temperature / top-p sampling (`do_sample` iff temperature >
  0); the randomness comes from an explicit `torch.Generator` in place of
  JAX's `rng` key, so the two packages draw different tokens from the
  same distribution;
- right-padded ragged prompts decode natively: each sample writes its
  next token at its own `lens[b]` cache slot;
- last-layer hidden states are captured for every position, aligned so
  `hidden_last[b, j]` produced `sequences[b, j+1]` (the [SEG]/[LOC]
  readout contract).

With `DTensor` parameters (`parallel/`) the decoder runs tensor-parallel
(`models/llama.py`) and `lm_head` is vocab-parallel: the greedy token
comes from each rank's best (value, id) over its V / tp columns, combined
from `[tp, B]` gathers; a sampled token from the logits gathered over tp.
A decode step then issues the tp all-reduces and those combines, and no
parameter-sized gather. `make_generate_fn` also splits the batch over the
data ranks and gathers the results.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ullava_tpu_torch.models import llama, ullava_core
from ullava_tpu_torch.ops.quant import apply_linear
from ullava_tpu_torch.parallel.collectives import (
    TPGroup,
    all_data_done,
    all_gather_tp,
    gather_data,
    gather_from_tp,
    tp_group,
)
from ullava_tpu_torch.parallel.mesh import data_rank
from ullava_tpu_torch.parallel.sharding import local_weight, mesh_of


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    max_new_tokens: int = 32
    temperature: float = 0.2
    top_p: Optional[float] = None
    stop_token_ids: Tuple[int, ...] = ()  # usually (eos_id,) + keyword ids
    # Declared as in the JAX package, which never reads it: hidden states
    # are captured either way.
    capture_hidden: bool = True
    # Real vocabulary size when the embedding/lm_head tables are padded:
    # logits at ids >= vocab_size can never be emitted.
    vocab_size: Optional[int] = None

    @property
    def do_sample(self) -> bool:
        return self.temperature > 0


def nucleus_logits(logits: torch.Tensor, gen: GenerateConfig) -> torch.Tensor:
    """The logits `sample_token` draws from: pad ids masked to -inf, then
    (when sampling) divided by the temperature, then every token outside
    the top-p nucleus masked to -inf. A token stays while the probability
    before it in descending order is at most `top_p` (so at least one
    stays), and every token tied with the smallest kept logit stays."""
    if gen.vocab_size is not None and gen.vocab_size < logits.shape[-1]:
        pad = torch.arange(logits.shape[-1], device=logits.device) >= gen.vocab_size
        logits = logits.masked_fill(pad[None, :], float("-inf"))
    if not gen.do_sample:
        return logits
    logits = logits / gen.temperature
    if gen.top_p is not None and gen.top_p < 1.0:
        sorted_logits = logits.sort(dim=-1, descending=True).values
        sorted_probs = sorted_logits.softmax(dim=-1)
        cumulative = sorted_probs.cumsum(dim=-1)
        cutoff_mask = (cumulative - sorted_probs) > gen.top_p
        cutoff_logit = sorted_logits.masked_fill(cutoff_mask, float("inf")).amin(
            dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff_logit, float("-inf"))
    return logits


def sample_token(
    logits: torch.Tensor, gen: GenerateConfig, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """[B, V] logits -> [B] int32 token ids: the argmax at temperature 0,
    else one categorical draw per row from `nucleus_logits`, taken from
    `generator` (a fresh one seeded 0 on the logits' device when None, as
    the JAX package defaults to `PRNGKey(0)`)."""
    logits = nucleus_logits(logits, gen)
    if not gen.do_sample:
        return logits.argmax(-1).to(torch.int32)
    if generator is None:
        generator = torch.Generator(device=logits.device).manual_seed(0)
    probs = logits.float().softmax(dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def _tp_token(logits: torch.Tensor, gen: GenerateConfig, generator, tp: TPGroup) -> torch.Tensor:
    """`sample_token` over vocab-parallel logits [B, V / tp] (this rank's
    columns). Greedy: each rank's first best column, then the best over
    ranks (the lowest rank among equal values, so the first best id, as an
    argmax over the whole row); sampling draws from the gathered row."""
    if gen.do_sample:
        return sample_token(gather_from_tp(logits, tp), gen, generator)
    V = logits.shape[-1]
    if gen.vocab_size is not None:
        col = tp.rank * V + torch.arange(V, device=logits.device)
        logits = logits.masked_fill((col >= gen.vocab_size)[None, :], float("-inf"))
    idx = logits.argmax(-1)
    vals = all_gather_tp(logits.gather(-1, idx[:, None])[:, 0], tp)  # [tp, B]
    ids = all_gather_tp(idx + tp.rank * V, tp)
    return ids.gather(0, vals.argmax(0)[None])[0].to(torch.int32)


@torch.no_grad()
def generate(
    params: Dict,
    cfg: ullava_core.UllavaCoreConfig,
    gen: GenerateConfig,
    *,
    input_ids: torch.Tensor,  # [B, S] right-padded prompts
    prompt_lens: torch.Tensor,  # [B] true prompt lengths
    images: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """Returns sequences [B, S+new] (prompt + generated, right-padded with
    0), lengths [B], hidden_last [B, S+new, D]. Sampling draws every step
    from `generator` (seeded 0 when None)."""
    B, S = input_ids.shape
    total = S + gen.max_new_tokens
    dev = input_ids.device
    stops = torch.tensor(gen.stop_token_ids or (-1,), dtype=torch.int32, device=dev)
    if gen.do_sample and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    llm = params["llm"]
    tp = tp_group(llm["embed_tokens"])
    mesh = None if tp is None else mesh_of(llm["embed_tokens"])
    if tp is not None and mesh.size(mesh.mesh_dim_names.index("fsdp")) == 1:
        # Nothing to gather: take the decoder's local tensors once, not at
        # every step.
        llm = llama.local_params(llm)
    lm_head = llm["lm_head"] if tp is None else local_weight(llm["lm_head"], dim=-1)

    def next_token(logits):
        if tp is None:
            return sample_token(logits, gen, generator)
        return _tp_token(logits, gen, generator, tp)

    cache = llama.init_kv_cache(cfg.llm, B, total, device=dev, tp=1 if tp is None else tp.size)
    embeds = ullava_core.embed_multimodal(params, cfg, input_ids, images)
    pre = llama.forward(
        llm, cfg.llm, inputs_embeds=embeds, kv_lens=prompt_lens,
        kv_cache=cache, compute_logits=False, tp=tp,
    )
    b_idx = torch.arange(B, device=dev)
    lens = prompt_lens.to(torch.int32)
    # Logits only at each sample's last prompt position.
    h_last = pre["hidden_states"][b_idx, lens.long() - 1]
    tok = next_token(apply_linear(h_last.to(cfg.llm.dtype), lm_head).float())

    seq = torch.zeros((B, total), dtype=torch.int32, device=dev)
    seq[:, :S] = input_ids.to(torch.int32)
    hidden = torch.zeros(
        (B, total, cfg.llm.hidden_size), dtype=pre["hidden_states"].dtype, device=dev
    )
    hidden[:, :S] = pre["hidden_states"]
    done = torch.zeros(B, dtype=torch.bool, device=dev)

    for _ in range(gen.max_new_tokens):
        if all_data_done(done, mesh) if mesh is not None else bool(done.all()):
            break
        write = ~done & (lens < total)
        pos = lens.clamp(max=total - 1).long()
        seq[b_idx, pos] = torch.where(write, tok, seq[b_idx, pos])
        done = done | (tok[:, None] == stops[None, :]).any(-1)
        new_lens = torch.where(write, lens + 1, lens)
        out = llama.forward(
            llm, cfg.llm, input_ids=tok[:, None].long(),
            positions=lens[:, None], kv_lens=new_lens, kv_cache=cache,
            write_pos=lens.long(), compute_logits=tp is None, tp=tp,
        )
        h_step = out["hidden_states"][:, 0]
        hidden[b_idx, pos] = torch.where(write[:, None], h_step, hidden[b_idx, pos])
        if tp is None:
            tok = sample_token(out["logits"][:, 0], gen, generator)
        else:
            tok = next_token(apply_linear(out["hidden_states"], lm_head).float()[:, 0])
        lens = new_lens
    return {"sequences": seq, "lengths": lens, "hidden_last": hidden}


def make_generate_fn(cfg: ullava_core.UllavaCoreConfig, gen: GenerateConfig):
    """The generate closure for serving (the JAX package jit-compiles it):
    fn(params, input_ids, prompt_lens, images=None, generator=None). Over
    `DTensor` parameters of a (dp, fsdp, tp) mesh, every rank passes the
    whole batch; each data rank decodes its part (when the batch divides
    by dp * fsdp) with the decoder tensor-parallel, and every rank gets
    the whole result back."""

    def fn(params, input_ids, prompt_lens, images=None, generator=None):
        mesh = mesh_of(params["llm"]["embed_tokens"])
        B = input_ids.shape[0]
        r, n = (0, 1) if mesh is None else data_rank(mesh)
        split = n > 1 and B % n == 0
        if split:
            part = slice(r * B // n, (r + 1) * B // n)
            input_ids, prompt_lens = input_ids[part], prompt_lens[part]
            images = None if images is None else images[part]
        out = generate(params, cfg, gen, input_ids=input_ids, prompt_lens=prompt_lens,
                       images=images, generator=generator)
        if split:
            out = {k: gather_data(v, mesh) for k, v in out.items()}
        return out

    return fn


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
