"""u-LLaVA stage-1 core: CLIP tower + projector + LLaMA, for serving and
for stage-1 training (counterpart of `ullava_tpu/models/ullava_core.py`).

- `encode_image` / `encode_video`: frozen CLIP features at the readout
  layer with CLS dropped, under `torch.no_grad()` (the JAX
  `stop_gradient`); a video's frames are pooled over time (spatial
  tokens) and over patches (temporal tokens), n_frm + 256 tokens.
- `splice_mm_features` is the fixed-shape splice: the N positions after
  each sample's start marker are overwritten with projected features;
  rows without the marker pass through unchanged. With `detach_text`
  (pretraining, `projector_from_scratch`) the text embeddings outside the
  marker span [start, start + N + 1] are detached, so only the marker
  tokens' embedding rows train; text-only rows keep their gradients.
- `forward` with `labels`: the decoder and the shifted next-token CE with
  IGNORE_INDEX masking, either streamed over the vocabulary
  (`chunked_cross_entropy`, `fused_ce`) or from full logits. Both divide
  by the global count of valid targets (`parallel.collectives.global_sum`:
  summed over the data ranks inside a sharded training step).

With `DTensor` parameters (`parallel/`) CLIP and the projector run on
their whole weights (`parallel.sharding.whole`), and the streamed CE on
the whole `lm_head`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.utils.checkpoint

from ullava_tpu_torch import resolve_device
from ullava_tpu_torch.constants import IGNORE_INDEX
from ullava_tpu_torch.models import clip_vit, llama, projector
from ullava_tpu_torch.ops.quant import dequantize, is_quantized
from ullava_tpu_torch.parallel.collectives import global_sum
from ullava_tpu_torch.parallel.sharding import whole

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class UllavaCoreConfig:
    llm: llama.LlamaConfig = dataclasses.field(default_factory=llama.LlamaConfig)
    vision: clip_vit.CLIPVisionConfig = dataclasses.field(
        default_factory=clip_vit.CLIPVisionConfig
    )
    vision_hidden_layer: int = -2  # reference configs use -2
    projector_type: str = "mlp"
    # Pretraining (train the projector and the embeddings, detach the text
    # embeddings outside the marker span); False for finetuning.
    projector_from_scratch: bool = True
    img_start_id: int = -1  # set from the tokenizer vocabulary
    img_end_id: int = -1
    vid_start_id: int = -1
    vid_end_id: int = -1
    n_frm: int = 8
    # Training CE: True streams the vocabulary (`chunked_cross_entropy`,
    # no [B, S, V] logits), False takes the full logits.
    fused_ce: bool = True

    @classmethod
    def tiny(cls, **kw) -> "UllavaCoreConfig":
        defaults = dict(
            llm=llama.LlamaConfig.tiny(vocab_size=160),
            vision=clip_vit.CLIPVisionConfig.tiny(),
            img_start_id=150,
            img_end_id=151,
            vid_start_id=152,
            vid_end_id=153,
        )
        defaults.update(kw)
        return cls(**defaults)


def init_params(
    cfg: UllavaCoreConfig, generator: Optional[torch.Generator] = None, device=None
) -> Params:
    device = resolve_device(device)
    gen = generator or torch.Generator(device=device).manual_seed(0)
    return {
        "llm": llama.init_params(cfg.llm, gen, device),
        "vision": clip_vit.init_params(cfg.vision, gen, device),
        "projector": projector.init_vision_projector(
            gen, cfg.vision.hidden_size, cfg.llm.hidden_size, cfg.projector_type,
            dtype=cfg.llm.dtype, device=device,
        ),
    }


def encode_image(params: Params, cfg: UllavaCoreConfig, images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] -> frozen CLIP patch features [B, P, Dv] at the readout
    layer (no gradient reaches the tower)."""
    with torch.no_grad():
        out = clip_vit.forward(
            whole(params["vision"]), cfg.vision, images, hidden_layer=cfg.vision_hidden_layer
        )
    return out["patch_features"]


def encode_video(params: Params, cfg: UllavaCoreConfig, videos: torch.Tensor) -> torch.Tensor:
    """[B, T, H, W, 3] -> temporal + spatial pooled features [B, T+P, Dv]."""
    B, T = videos.shape[:2]
    feats = encode_image(params, cfg, videos.reshape((B * T,) + videos.shape[2:]))
    feats = feats.reshape(B, T, feats.shape[1], feats.shape[2])
    spatial = feats.mean(1)  # [B, P, Dv] (mean over frames)
    temporal = feats.mean(2)  # [B, T, Dv] (mean over patches)
    return torch.cat([temporal, spatial], dim=1)


def splice_mm_features(
    inputs_embeds: torch.Tensor,  # [B, S, D]
    input_ids: torch.Tensor,  # [B, S]
    feats: torch.Tensor,  # [B, N, D] projected features
    start_id: int,
    detach_text: bool = False,
) -> torch.Tensor:
    B, S, D = inputs_embeds.shape
    N = feats.shape[1]
    is_start = input_ids == start_id
    has = is_start.any(1)
    start = is_start.int().argmax(1)  # first marker (0 if absent; gated by `has`)
    col = torch.arange(S, device=input_ids.device).expand(B, S)
    rel = col - (start[:, None] + 1)
    in_span = (rel >= 0) & (rel < N) & has[:, None]
    idx = rel.clamp(0, N - 1)
    gathered = torch.gather(feats, 1, idx[..., None].expand(B, S, D)).to(inputs_embeds.dtype)
    base = inputs_embeds
    if detach_text:
        # Only the marker span keeps embedding gradients; rows without a
        # marker keep them all.
        keep = (col >= start[:, None]) & (col <= start[:, None] + N + 1) & has[:, None]
        keep = keep | ~has[:, None]
        base = torch.where(keep[..., None], base, base.detach())
    return torch.where(in_span[..., None], gathered, base)


def embed_multimodal(
    params: Params,
    cfg: UllavaCoreConfig,
    input_ids: torch.Tensor,  # [B, S]
    images: Optional[torch.Tensor] = None,  # [B, H, W, 3]
    videos: Optional[torch.Tensor] = None,  # [B, T, H, W, 3]
) -> torch.Tensor:
    """Token embeddings with the image and video features spliced in."""
    embeds = llama.embed(params["llm"], input_ids).to(cfg.llm.dtype)
    detach = cfg.projector_from_scratch
    proj = whole(params["projector"]) if images is not None or videos is not None else None
    if images is not None:
        feats = projector.apply_vision_projector(proj, encode_image(params, cfg, images))
        embeds = splice_mm_features(embeds, input_ids, feats, cfg.img_start_id, detach)
    if videos is not None:
        feats = projector.apply_vision_projector(proj, encode_video(params, cfg, videos))
        embeds = splice_mm_features(embeds, input_ids, feats, cfg.vid_start_id, detach)
    return embeds


def _ce_chunk(h, w_c, m, s, tgt, safe_labels, start: int, V: int):
    """One vocabulary chunk [start, start + C) of the streamed CE: the
    chunk's fp32 logits, the online max / sum update and the target
    logits that fall in it. Columns past V (the zero padding of the last
    chunk) are masked."""
    C = w_c.shape[1]
    logits = h.float() @ w_c.float()  # [B, S-1, C]
    col = start + torch.arange(C, device=h.device)
    logits = logits.masked_fill(col >= V, -1e30)
    m_new = torch.maximum(m, logits.amax(-1))
    s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[..., None]).sum(-1)
    rel = safe_labels - start
    in_chunk = (rel >= 0) & (rel < C)
    got = torch.gather(logits, -1, rel.clamp(0, C - 1)[..., None])[..., 0]
    return m_new, s, torch.where(in_chunk, got, tgt)


def chunked_cross_entropy(
    hidden: torch.Tensor,  # [B, S, D] final post-norm hidden states
    lm_head: torch.Tensor,  # [D, V]
    labels: torch.Tensor,  # [B, S]
    num_chunks: int = 8,
) -> torch.Tensor:
    """Shifted next-token CE without the [B, S, V] logits: the vocabulary
    streams in `num_chunks` chunks with an online logsumexp, each chunk
    checkpointed so that only one [B, S, V / num_chunks] block of fp32
    logits is live at a time (forward and backward)."""
    if is_quantized(lm_head):
        lm_head = dequantize(lm_head, hidden.dtype)
    B, S, D = hidden.shape
    V = lm_head.shape[1]
    h = hidden[:, :-1]  # predict token t+1 from hidden t
    shift = labels[:, 1:]
    valid = shift != IGNORE_INDEX
    safe = torch.where(valid, shift, torch.zeros_like(shift))
    pad = (-V) % num_chunks
    W = torch.nn.functional.pad(lm_head, (0, pad)) if pad else lm_head
    C = (V + pad) // num_chunks
    m = torch.full((B, S - 1), -1e30, dtype=torch.float32, device=hidden.device)
    s = torch.zeros((B, S - 1), dtype=torch.float32, device=hidden.device)
    tgt = torch.zeros((B, S - 1), dtype=torch.float32, device=hidden.device)
    for i in range(num_chunks):
        m, s, tgt = torch.utils.checkpoint.checkpoint(
            _ce_chunk, h, W[:, i * C:(i + 1) * C], m, s, tgt, safe, i * C, V,
            use_reentrant=False)
    token_loss = torch.where(valid, m + torch.log(s) - tgt, torch.zeros_like(m))
    return token_loss.sum() / global_sum(valid.sum()).clamp_min(1)


def cross_entropy_loss(
    logits: torch.Tensor,  # [B, S, V] (pre-shift)
    labels: torch.Tensor,  # [B, S] with IGNORE_INDEX masking
) -> torch.Tensor:
    """Shifted next-token CE, mean over non-ignored targets (fp32)."""
    shift_logits = logits[:, :-1].float()
    shift = labels[:, 1:]
    valid = shift != IGNORE_INDEX
    safe = torch.where(valid, shift, torch.zeros_like(shift))
    logp = torch.log_softmax(shift_logits, dim=-1)
    token_loss = -torch.gather(logp, -1, safe[..., None])[..., 0]
    token_loss = torch.where(valid, token_loss, torch.zeros_like(token_loss))
    return token_loss.sum() / global_sum(valid.sum()).clamp_min(1)


def forward(
    params: Params,
    cfg: UllavaCoreConfig,
    *,
    input_ids: torch.Tensor,
    labels: Optional[torch.Tensor] = None,
    images: Optional[torch.Tensor] = None,
    videos: Optional[torch.Tensor] = None,
    attn_lens: Optional[torch.Tensor] = None,  # [B] true lengths (right padding)
    inputs_embeds: Optional[torch.Tensor] = None,
    kv_cache: Optional[Dict[str, torch.Tensor]] = None,
    positions: Optional[torch.Tensor] = None,
    write_pos: Optional[torch.Tensor] = None,
) -> Dict[str, Any]:
    """The decoder over the spliced embeddings; with `labels`, also the
    training loss (`out["loss"]`)."""
    if inputs_embeds is None:
        inputs_embeds = embed_multimodal(params, cfg, input_ids, images, videos)
    training = labels is not None
    use_fused = training and cfg.fused_ce
    out = llama.forward(
        params["llm"], cfg.llm, inputs_embeds=inputs_embeds, kv_lens=attn_lens,
        kv_cache=kv_cache, positions=positions, write_pos=write_pos,
        compute_logits=not use_fused,
    )
    if training:
        if use_fused:
            out["loss"] = chunked_cross_entropy(
                out["hidden_states"], whole(params["llm"]["lm_head"]), labels)
        else:
            out["loss"] = cross_entropy_loss(out["logits"], labels)
    return out
