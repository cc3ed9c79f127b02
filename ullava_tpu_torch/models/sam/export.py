"""A portable serving artifact of the SAM prompt + mask decoder
(counterpart of `ullava_tpu/models/sam/export.py`).

One pure function computes what the reference's ONNX wrapper does: the
point prompt embedding with -1 padding labels, the gated mask-prompt
embedding, mask decoding, the multi-click single-mask selection by score
reweighting (no control flow) and optional stability scores. Where the
JAX package serializes it with `jax.export` (StableHLO), the port exports
it with `torch.export` at fixed prompt shapes and serializes the
`ExportedProgram` with `torch.export.save`; `load_sam_decoder` gives the
loaded program's callable, which runs with no Python model code.

As in the JAX package the artifact returns masks upscaled to the fixed
padded frame (`build.upscale_masks_to_frame`); the crop and resize to the
original size stay on the host (`build.postprocess_masks_host`).

    blob = export_sam_decoder(params, cfg, num_points=2)
    masks, iou, low_res = load_sam_decoder(blob)(emb, coords, labels, mask, has_mask)
"""

from __future__ import annotations

import io
from typing import Any, Dict

import torch

from ullava_tpu_torch.models.sam import build as sam_build
from ullava_tpu_torch.models.sam import mask_decoder, prompt_encoder

Params = Dict[str, Any]


def stability_score_t(
    logits: torch.Tensor, threshold: float = 0.0, offset: float = 1.0
) -> torch.Tensor:
    """IoU between the masks binarized at threshold +/- offset (the tensor
    version of `automatic.stability_score`)."""
    hi = (logits > threshold + offset).sum(dim=(-1, -2)).float()
    lo = (logits > threshold - offset).sum(dim=(-1, -2)).float()
    return hi / lo.clamp_min(1.0)


def make_decoder_fn(
    params: Params,  # {"prompt_encoder": ..., "mask_decoder": ...}
    cfg,  # SamConfig
    *,
    return_single_mask: bool = True,
    use_stability_score: bool = False,
    upscale_to_frame: bool = True,
):
    """The exportable function:

    fn(image_embeddings [B, g, g, D], point_coords [B, N, 2] f32 pixels,
       point_labels [B, N] i32 in {-1, 0, 1} (-1 = padding), mask_input
       [B, 4g, 4g, 1] f32, has_mask_input [B] f32 in {0., 1.})
      -> (masks, iou_scores, low_res_masks)"""
    pp = params["prompt_encoder"]
    dp = params["mask_decoder"]
    pcfg, dcfg = cfg.prompt, cfg.decoder

    def fn(image_embeddings, point_coords, point_labels, mask_input, has_mask_input):
        B = image_embeddings.shape[0]
        sparse = prompt_encoder._embed_points(pp, pcfg, point_coords, point_labels, pad=False)
        # The gated mask embedding: the downscaled mask and the no-mask
        # embedding blended by the has_mask flag, a static graph.
        _, dense_m = prompt_encoder.encode_prompts(pp, pcfg, batch=B, masks=mask_input)
        _, dense_0 = prompt_encoder.encode_prompts(pp, pcfg, batch=B)
        has = has_mask_input.reshape(B, 1, 1, 1).to(dense_m.dtype)
        dense = has * dense_m + (1.0 - has) * dense_0

        image_pe = prompt_encoder.dense_positional_embedding(pp, pcfg)
        low_res, iou = mask_decoder.decode_masks(
            dp, dcfg, image_embeddings, image_pe, sparse, dense, return_all=True,
        )  # [B, M, 4g, 4g], [B, M]

        if use_stability_score:
            iou = stability_score_t(low_res)

        if return_single_mask:
            # Multi-click selection without control flow: token 0's score
            # gains 1000 when there are at most two points, so argmax picks
            # it, else the best multimask token wins.
            num_points = point_labels.shape[1]
            reweight = torch.zeros(dcfg.num_mask_tokens, dtype=torch.float32,
                                   device=iou.device)
            reweight[0] = 1000.0
            score = iou.float() + (num_points - 2.5) * reweight
            best = score.argmax(dim=1)
            low_res = torch.take_along_dim(low_res, best[:, None, None, None], dim=1)
            iou = torch.take_along_dim(iou, best[:, None], dim=1)

        masks = (
            sam_build.upscale_masks_to_frame(low_res, cfg.vision.img_size)
            if upscale_to_frame else low_res
        )
        return masks, iou, low_res

    return fn


class _DecoderModule(torch.nn.Module):
    """`make_decoder_fn`'s function as the module `torch.export` takes; the
    parameters ride along as constants of the exported program."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, image_embeddings, point_coords, point_labels, mask_input, has_mask_input):
        return self.fn(image_embeddings, point_coords, point_labels, mask_input, has_mask_input)


def export_sam_decoder(
    params: Params,
    cfg,
    *,
    batch: int = 1,
    num_points: int = 1,
    return_single_mask: bool = True,
    use_stability_score: bool = False,
    upscale_to_frame: bool = True,
) -> bytes:
    """The decoder function exported with `torch.export` at fixed prompt
    shapes (`batch`, `num_points`) on the device of `params`, serialized to
    bytes by `torch.export.save` (write them to a `.pt2` file to deploy)."""
    g = cfg.prompt.image_embedding_size
    D = cfg.prompt.embed_dim
    dev = params["mask_decoder"]["iou_token"].device
    fn = make_decoder_fn(
        params, cfg,
        return_single_mask=return_single_mask,
        use_stability_score=use_stability_score,
        upscale_to_frame=upscale_to_frame,
    )
    args = (
        torch.zeros((batch, g, g, D), dtype=cfg.decoder.dtype, device=dev),
        torch.zeros((batch, num_points, 2), dtype=torch.float32, device=dev),
        torch.zeros((batch, num_points), dtype=torch.int32, device=dev),
        torch.zeros((batch, 4 * g, 4 * g, 1), dtype=torch.float32, device=dev),
        torch.zeros((batch,), dtype=torch.float32, device=dev),
    )
    with torch.no_grad():
        program = torch.export.export(_DecoderModule(fn), args)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_sam_decoder(blob: bytes):
    """Deserialize an exported artifact; returns a callable with the
    `make_decoder_fn` signature."""
    return torch.export.load(io.BytesIO(blob)).module()
