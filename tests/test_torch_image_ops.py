"""The port's image transforms against the JAX package's.

- bit-equal: `sam_preprocess`, `sam/build.preprocess`,
  `SegToolBox.preprocess`, `DetToolBox`, and the nearest-neighbour mask
  resizes (`apply_mask`, `pad_mask_to_frame`) against PIL's;
- `clip_preprocess` (`F.interpolate` bicubic antialiased against
  `jax.image.resize` cubic antialiased): measured at most 2.8e-6 and on
  average 3.6e-7 apart in normalized units on noise and smooth canvases at
  1024 and 64 (bounds below: max 1e-5, mean 1e-6);
- `make_canvas`: with cv2 both packages resize with it and agree exactly;
  without it the port's bilinear `resize_uint8` against PIL's: measured
  at most 1 LSB apart, on average 0.124-0.152 LSB over the canvas at
  48 x 64, 480 x 640 and 1500 x 1100 (bounds: max 1, mean 0.2);
- `CLIPProcessor` and `SegToolBox.apply_image` (torch resizes in place of
  PIL's): within 1 uint8 LSB of JAX's PIL versions on at least 99% of
  pixels.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ullava_tpu.data.processors import CLIPProcessor as JCLIPProcessor
from ullava_tpu.data.tools import mask_toolbox as jmask
from ullava_tpu.models.sam import build as jsam_build
from ullava_tpu.ops import image_ops as jio
from ullava_tpu_torch.constants import CLIP_STD
from ullava_tpu_torch.data.processors import CLIPProcessor
from ullava_tpu_torch.data.tools import mask_toolbox
from ullava_tpu_torch.models.sam import build as sam_build
from ullava_tpu_torch.ops import image_ops as io


def _noise(rng, shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


def _smooth(shape, phase=0.0):
    h, w = shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([(128 + 100 * np.sin(xx / 7.0 + c + phase) * np.cos(yy / 5.0)).astype(np.uint8)
                     for c in range(3)], -1)


def _canvas(kind, side, sizes, rng):
    if kind == "noise":
        c = _noise(rng, (len(sizes), side, side, 3))
    else:
        c = np.stack([_smooth((side, side), b) for b in range(len(sizes))])
    return c, np.asarray(sizes, np.int32)


CANVASES = [(1024, [(768, 1024), (1024, 683)]), (64, [(48, 64), (64, 40)])]


@pytest.mark.parametrize("side,sizes", CANVASES)
@pytest.mark.parametrize("kind", ["noise", "smooth"])
def test_sam_preprocess_bit_equal(side, sizes, kind):
    c, s = _canvas(kind, side, sizes, np.random.default_rng(0))
    ref = np.asarray(jio.sam_preprocess(jnp.asarray(c), jnp.asarray(s)))
    got = io.sam_preprocess(torch.from_numpy(c), torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(io.valid_mask(torch.from_numpy(s), side).numpy(),
                                  np.asarray(jio.valid_mask(jnp.asarray(s), side)))


@pytest.mark.parametrize("side,sizes", CANVASES)
@pytest.mark.parametrize("kind", ["noise", "smooth"])
def test_clip_preprocess_close(side, sizes, kind):
    c, s = _canvas(kind, side, sizes, np.random.default_rng(1))
    size = 224 if side == 1024 else 28
    ref = np.asarray(jio.clip_preprocess(jnp.asarray(c), jnp.asarray(s), size))
    got = io.clip_preprocess(torch.from_numpy(c), torch.from_numpy(s), size).numpy()
    d = np.abs(got - ref)
    assert d.max() <= 1e-5 and d.mean() <= 1e-6, (d.max(), d.mean())
    clip_in, sam_in = io.preprocess_canvas(torch.from_numpy(c), torch.from_numpy(s), size)
    np.testing.assert_array_equal(clip_in.numpy(), got)
    assert sam_in.shape == (len(sizes), side, side, 3)


@pytest.mark.parametrize("hw", [(48, 64), (64, 64), (30, 20)])
def test_sam_build_preprocess_bit_equal(hw):
    rng = np.random.default_rng(2)
    for x in (_noise(rng, (2,) + hw + (3,)), rng.standard_normal((2,) + hw + (3,)).astype(np.float32)):
        ref = np.asarray(jsam_build.preprocess(jnp.asarray(x), 64))
        got = sam_build.preprocess(torch.from_numpy(x), 64).numpy()
        np.testing.assert_array_equal(got, ref)


def test_det_toolbox_bit_equal():
    a, b = jmask.DetToolBox(), mask_toolbox.DetToolBox()
    rng = np.random.default_rng(3)
    for w, h in ((640, 480), (480, 640), (300, 300)):
        xywh = list(rng.random(4) * 200)
        xyxy = b.xywh2xyxy(xywh)
        assert xyxy == a.xywh2xyxy(xywh)
        n = b.pad_normalize_xyxy(xyxy, w, h)
        assert n == a.pad_normalize_xyxy(xyxy, w, h)
        assert b.denormalize_padded_xyxy(n, w, h) == a.denormalize_padded_xyxy(n, w, h)
        assert b.get_pad_length(w, h) == a.get_pad_length(w, h)
    m = np.zeros((20, 30), np.uint8)
    m[3:9, 5:17] = 1
    assert b.mask2bbox(m) == a.mask2bbox(m) == [5.0, 3.0, 16.0, 8.0]
    assert b.mask2bbox(np.zeros((4, 4))) == a.mask2bbox(np.zeros((4, 4)))


def _lsb_share(got, ref):
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    return (d <= 1).mean()


@pytest.mark.parametrize("hw", [(48, 64), (480, 640), (1500, 1100), (1024, 1024)])
@pytest.mark.parametrize("kind", ["noise", "smooth"])
def test_seg_toolbox_apply_image_within_one_lsb(hw, kind):
    img = _noise(np.random.default_rng(4), hw + (3,)) if kind == "noise" else _smooth(hw)
    ref = jmask.SegToolBox(1024).apply_image(img)
    got = mask_toolbox.SegToolBox(1024).apply_image(img)
    assert got.shape == ref.shape and got.dtype == np.uint8
    assert _lsb_share(got, ref) >= 0.99


@pytest.mark.parametrize("hw", [(48, 64), (480, 640), (300, 300), (37, 53)])
@pytest.mark.parametrize("aspect_ratio", ["pad", None])
@pytest.mark.parametrize("kind", ["noise", "smooth"])
def test_clip_processor_within_one_lsb(hw, aspect_ratio, kind):
    img = _noise(np.random.default_rng(5), hw + (3,)) if kind == "noise" else _smooth(hw)
    ref = JCLIPProcessor(224, aspect_ratio)(img)
    got = CLIPProcessor(224, aspect_ratio)(img)
    assert got.shape == ref.shape == (224, 224, 3) and got.dtype == np.float32
    lsb = np.abs(got - ref) * 255.0 * np.asarray(CLIP_STD, np.float32)
    assert (lsb <= 1.0 + 1e-3).mean() >= 0.99
    from PIL import Image

    np.testing.assert_array_equal(CLIPProcessor(224, aspect_ratio)(Image.fromarray(img)), got)


@pytest.mark.parametrize("hw", [(48, 64), (37, 53), (1500, 1100)])
def test_mask_resizes_match_pil(hw):
    rng = np.random.default_rng(6)
    m = (rng.random(hw) > 0.5).astype(np.uint8)
    a, b = jmask.SegToolBox(1024), mask_toolbox.SegToolBox(1024)
    np.testing.assert_array_equal(b.apply_mask(m), a.apply_mask(m))
    r = b.apply_mask(m)
    for frame in (256, 64, 1024):
        np.testing.assert_array_equal(b.pad_mask_to_frame(r, frame), a.pad_mask_to_frame(r, frame))


def test_seg_toolbox_preprocess_matches_jax(monkeypatch):
    """Bit-equal to the JAX package's numpy form; its native library (where
    built) multiplies by a reciprocal and lands within one fp32 ulp."""
    from ullava_tpu.data.tools import native

    img = _noise(np.random.default_rng(7), (768, 1024, 3))
    got = mask_toolbox.SegToolBox(1024).preprocess(img)
    np.testing.assert_allclose(got, jmask.SegToolBox(1024).preprocess(img), rtol=2.4e-7, atol=0)
    monkeypatch.setattr(native, "sam_normalize_pad", lambda *a: None)
    np.testing.assert_array_equal(got, jmask.SegToolBox(1024).preprocess(img))
    assert mask_toolbox.get_preprocess_shape(480, 640, 1024) == jmask.get_preprocess_shape(480, 640, 1024)


@pytest.mark.parametrize("hw", [(48, 64), (480, 640), (1500, 1100)])
def test_make_canvas(hw, monkeypatch):
    img = _smooth(hw)
    ref, ref_hw = jio.make_canvas(img, 1024)
    got, got_hw = io.make_canvas(img, 1024)
    assert got_hw == ref_hw
    np.testing.assert_array_equal(got, ref)  # cv2 on both sides

    out = np.full((1024, 1024, 3), 7, np.uint8)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)  # the card's machine: no cv2
        ref, _ = jio.make_canvas(img, 1024)
        got, _ = io.make_canvas(img, 1024, out=out)
    assert got is out
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1 and d.mean() <= 0.2, (d.max(), d.mean())
    assert not got[got_hw[0]:].any() and not got[:, got_hw[1]:].any()
