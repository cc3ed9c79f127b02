"""Image preprocessing of the serving path (counterpart of
`ullava_tpu/ops/image_ops.py`), and the host's uint8 resize.

The host ships ONE uint8 canvas per image: the decoded frame resized so
that its longest side is `SAM_IMAGE_SIZE` and placed at the top-left
corner (`SegToolBox.apply_image`, `make_canvas`). Everything downstream
(white-pad, resize to 224, both normalizations) runs as torch ops on the
canvas's device.

Contract: `canvas` is uint8 NHWC `[B, 1024, 1024, 3]`; `sizes[b] = (h, w)`
is the valid (aspect-preserved) region, `max(h, w) == 1024`.

`jax.image.resize(..., "cubic", antialias=True)` becomes
`F.interpolate(mode="bicubic", antialias=True)`: both are Keys' cubic with
a = -0.5 on half-pixel centres, widened by the scale when shrinking.
They may differ at the borders, where each renormalizes the taps that
fall inside the image; `tests/test_torch_image_ops.py` states the
measured difference.

`resize_uint8` is the host's resize of uint8 images in place of PIL's
(which the card's machine lacks): bicubic in two passes, horizontal then
vertical, each rounded and clamped to uint8 as PIL stores its
intermediate; bilinear in one pass; nearest with PIL's pixel-centre rule.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ullava_tpu_torch.constants import (
    CLIP_MEAN,
    CLIP_STD,
    DEFAULT_IMAGE_SIZE,
    SAM_IMAGE_SIZE,
    SAM_MEAN,
    SAM_STD,
)


def _nearest_index(n_out: int, n_in: int) -> torch.Tensor:
    """Source index of each output pixel under PIL's NEAREST: the centre
    coordinate accumulated in float64 from half a step, truncated."""
    step = n_in / n_out
    coords = np.full(n_out, step)
    coords[0] = step * 0.5
    return torch.from_numpy(np.cumsum(coords).astype(np.int64).clip(0, n_in - 1))


def _round_u8(x: torch.Tensor) -> torch.Tensor:
    return (x + 0.5).floor().clamp(0, 255)


def resize_uint8(image, size: Tuple[int, int], mode: str) -> np.ndarray:
    """uint8 [H, W] or [H, W, C] -> uint8 resized to `size` = (h, w), with
    mode "bicubic", "bilinear" or "nearest" (PIL's resize semantics,
    within 1 LSB on smooth and noisy images alike)."""
    a = np.array(image)  # a writable copy: decoded images may be read-only
    nh, nw = size
    if mode == "nearest":
        t = torch.from_numpy(a)
        t = t.index_select(0, _nearest_index(nh, a.shape[0]))
        return t.index_select(1, _nearest_index(nw, a.shape[1])).numpy()
    x = torch.from_numpy(a).float()
    x = (x[None, None] if a.ndim == 2 else x.permute(2, 0, 1)[None])
    kw = dict(mode=mode, align_corners=False, antialias=True)
    if mode == "bicubic":
        # PIL resamples horizontally, then vertically, through a uint8 image.
        if nw != x.shape[-1]:
            x = _round_u8(F.interpolate(x, size=(x.shape[-2], nw), **kw))
        if nh != x.shape[-2]:
            x = _round_u8(F.interpolate(x, size=(nh, nw), **kw))
    elif mode == "bilinear":
        x = _round_u8(F.interpolate(x, size=(nh, nw), **kw))
    else:
        raise ValueError(f"unknown resize mode {mode!r}")
    x = x.to(torch.uint8)[0]
    return (x[0] if a.ndim == 2 else x.permute(1, 2, 0)).numpy()


def valid_mask(sizes: torch.Tensor, side: int) -> torch.Tensor:
    """[B, 2] (h, w) -> [B, side, side, 1] f32 {0,1} mask of the valid region."""
    r = torch.arange(side, device=sizes.device)
    h = sizes[:, 0].reshape(-1, 1, 1, 1)
    w = sizes[:, 1].reshape(-1, 1, 1, 1)
    return ((r.reshape(1, side, 1, 1) < h) & (r.reshape(1, 1, side, 1) < w)).float()


def sam_preprocess(canvas: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """uint8 canvas -> SAM encoder input [B, 1024, 1024, 3] f32: the valid
    region SAM-normalized, the corner padding zero."""
    mean = torch.tensor(SAM_MEAN, dtype=torch.float32, device=canvas.device)
    std = torch.tensor(SAM_STD, dtype=torch.float32, device=canvas.device)
    x = (canvas.float() - mean) / std
    return x * valid_mask(sizes, canvas.shape[1])


def clip_preprocess(
    canvas: torch.Tensor,
    sizes: torch.Tensor,
    image_size: int = DEFAULT_IMAGE_SIZE,
) -> torch.Tensor:
    """uint8 canvas -> CLIP tower input [B, image_size, image_size, 3] f32:
    white outside the valid region, the image centred, then an
    antialiased cubic resize to `image_size` and the CLIP normalization."""
    B, side = canvas.shape[0], canvas.shape[1]
    mask = valid_mask(sizes, side)
    white = canvas.float() * mask + 255.0 * (1.0 - mask)
    # Centre the corner-anchored region: a roll by ((side-h)//2,
    # (side-w)//2) per sample; the wrap-around carries white pixels only.
    r = torch.arange(side, device=canvas.device)
    rows = (r[None] - (side - sizes[:, :1]) // 2) % side  # [B, side]
    cols = (r[None] - (side - sizes[:, 1:]) // 2) % side
    b = torch.arange(B, device=canvas.device)[:, None, None]
    centered = white[b, rows[:, :, None], cols[:, None, :]]
    resized = F.interpolate(
        centered.permute(0, 3, 1, 2), size=(image_size, image_size), mode="bicubic",
        align_corners=False, antialias=True,
    ).permute(0, 2, 3, 1)
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=canvas.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=canvas.device)
    return (resized / 255.0 - mean) / std


def preprocess_canvas(
    canvas: torch.Tensor,
    sizes: torch.Tensor,
    clip_size: int = DEFAULT_IMAGE_SIZE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One canvas -> (CLIP input [B,224,224,3], SAM input [B,1024,1024,3])."""
    return clip_preprocess(canvas, sizes, clip_size), sam_preprocess(canvas, sizes)


def make_canvas(image, sam_size: int = SAM_IMAGE_SIZE, out=None):
    """Host helper: uint8 HWC RGB image (any size) -> (canvas, (h, w)).

    Resizes the longest side to `sam_size` and corner-pastes into a fixed
    canvas. With cv2 installed it resizes as the JAX package does there
    (INTER_LINEAR when enlarging, INTER_AREA when shrinking); without it,
    `SegToolBox.apply_image` (bilinear). `out`: an optional preallocated
    [sam_size, sam_size, 3] uint8 array to write into."""
    from ullava_tpu_torch.data.tools.mask_toolbox import SegToolBox, get_preprocess_shape

    image = np.asarray(image)
    h, w = image.shape[:2]
    nh, nw = get_preprocess_shape(h, w, sam_size)
    try:
        import cv2

        interp = cv2.INTER_LINEAR if nh >= h else cv2.INTER_AREA
        resized = cv2.resize(image, (nw, nh), interpolation=interp)
    except ImportError:
        resized = SegToolBox(sam_size).apply_image(image)
    canvas = np.zeros((sam_size, sam_size, 3), np.uint8) if out is None else out
    if out is not None:
        canvas[nh:] = 0
        canvas[:nh, nw:] = 0
    canvas[:nh, :nw] = resized
    return canvas, (nh, nw)
