"""Video and GIF processors on the host (counterpart of
`ullava_tpu/data/processors/video_processor.py`).

Frame sampling `uniform` (stride vlen / n_frm) or `headtail` (n/2 drawn
from each half with Python's `random`); training takes one random resized
crop for all frames (bicubic, scale [min_scale, max_scale]), evaluation a
shortest-side resize and a center crop; both then CLIP-normalize. The
output is [T, H, W, 3] float32, as the CLIP tower takes frames.

GIFs are read through Pillow, where the JAX line calls `imageio.mimread`:
the card's machine has Pillow and no imageio. The frames are what
imageio's Pillow plugin gives (a palette frame converted to its palette's
mode, each frame as a numpy array), so the two agree bit for bit. Videos
are read through `cv2.VideoCapture`, as in the JAX line. Each library is
imported at the read.
"""

from __future__ import annotations

import random
from typing import List, Tuple

import numpy as np

from ullava_tpu_torch.constants import CLIP_MEAN, CLIP_STD
from ullava_tpu_torch.data.tools.image_io import _cv2, _pil_image
from ullava_tpu_torch.data.tools.video_transforms import BICUBIC
from ullava_tpu_torch.registry import registry


def sample_indices(vlen: int, n_frm: int, sampling: str, rng=random) -> List[int]:
    n_frm = min(n_frm, vlen)
    start, end = 0, vlen
    if sampling == "uniform":
        indices = np.arange(start, end, vlen / n_frm).astype(int).tolist()
    elif sampling == "headtail":
        half = vlen // 2
        head = rng.sample(range(start, half), min(n_frm // 2, max(half, 1)))
        tail = rng.sample(range(half, end), min(n_frm // 2, max(end - half, 1)))
        indices = sorted(head + tail)
    else:
        raise NotImplementedError(f"sampling {sampling}")
    return [min(i, vlen - 1) for i in indices]


def read_gif(path: str) -> List[np.ndarray]:
    """Every frame of the GIF at `path`, as `imageio.mimread` gives them:
    a palette frame converted to its palette's mode, a frame of any other
    mode as it is."""
    Image = _pil_image(path)
    from PIL import ImageSequence

    frames = []
    with Image.open(path) as img:
        for frame in ImageSequence.Iterator(img):
            if frame.mode == "P":
                frame = frame.convert(frame.palette.mode)
            frames.append(np.asarray(frame))
    return frames


def load_gif_frames(gif_path: str, n_frm: int, sampling: str = "uniform") -> np.ndarray:
    frames = read_gif(gif_path)
    idx = sample_indices(len(frames), n_frm, sampling)
    out = []
    for i in idx:
        f = np.asarray(frames[i])
        if f.ndim == 2:
            f = np.stack([f] * 3, -1)
        out.append(f[..., :3])
    return np.stack(out)  # [T, H, W, 3] uint8


def load_video_frames(video_path: str, n_frm: int, sampling: str = "uniform") -> np.ndarray:
    cv2 = _cv2(video_path)
    cap = cv2.VideoCapture(video_path)
    vlen = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    if vlen <= 0:
        raise IOError(f"cannot read video {video_path}")
    idx = set(sample_indices(vlen, n_frm, sampling))
    frames = []
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if i in idx:
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        i += 1
    cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {video_path}")
    return np.stack(frames)


def _normalize(frames: np.ndarray) -> np.ndarray:
    x = frames.astype(np.float32) / 255.0
    return (x - np.asarray(CLIP_MEAN, np.float32)) / np.asarray(CLIP_STD, np.float32)


def _resize_frames(frames: np.ndarray, size: Tuple[int, int], method=BICUBIC) -> np.ndarray:
    Image = _pil_image("video frames")
    return np.stack([
        np.asarray(Image.fromarray(f).resize((size[1], size[0]), method)) for f in frames
    ])


def random_resized_crop(
    frames: np.ndarray, image_size: int, min_scale: float, max_scale: float,
    rng=random,
) -> np.ndarray:
    """One crop window for all frames: up to 10 draws of area and aspect,
    then the whole frame resized."""
    T, H, W, _ = frames.shape
    area = H * W
    for _ in range(10):
        target_area = rng.uniform(min_scale, max_scale) * area
        aspect = rng.uniform(3.0 / 4.0, 4.0 / 3.0)
        w = int(round((target_area * aspect) ** 0.5))
        h = int(round((target_area / aspect) ** 0.5))
        if 0 < w <= W and 0 < h <= H:
            top = rng.randint(0, H - h)
            left = rng.randint(0, W - w)
            cropped = frames[:, top : top + h, left : left + w]
            return _resize_frames(cropped, (image_size, image_size))
    return _resize_frames(frames, (image_size, image_size))


def _center_crop(frames: np.ndarray, image_size: int) -> np.ndarray:
    T, H, W, _ = frames.shape
    scale = image_size / min(H, W)
    frames = _resize_frames(frames, (round(H * scale), round(W * scale)))
    H, W = frames.shape[1:3]
    top = (H - image_size) // 2
    left = (W - image_size) // 2
    return frames[:, top : top + image_size, left : left + image_size]


class VideoBaseProcessor:
    media_loader = staticmethod(load_video_frames)

    def __init__(self, image_size=224, n_frm=8, min_scale=0.5, max_scale=1.0,
                 sampling="headtail", train=True):
        self.image_size = image_size
        self.n_frm = n_frm
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.sampling = sampling
        self.train = train

    def __call__(self, path: str) -> np.ndarray:
        frames = self.media_loader(path, self.n_frm, self.sampling)
        if self.train:
            frames = random_resized_crop(frames, self.image_size, self.min_scale, self.max_scale)
        else:
            frames = _center_crop(frames, self.image_size)
        return _normalize(frames)  # [T, H, W, 3] float32

    @classmethod
    def from_config(cls, cfg=None):
        cfg = cfg or {}
        return cls(
            image_size=int(cfg.get("image_size", 224)),
            n_frm=int(cfg.get("n_frm", 8)),
            min_scale=float(cfg.get("min_scale", 0.5)),
            max_scale=float(cfg.get("max_scale", 1.0)),
        )


@registry.register_processor("video_train")
class VideoTrainProcessor(VideoBaseProcessor):
    def __init__(self, **kw):
        kw.setdefault("sampling", "headtail")
        kw.setdefault("train", True)
        super().__init__(**kw)


@registry.register_processor("video_eval")
class VideoEvalProcessor(VideoBaseProcessor):
    def __init__(self, **kw):
        kw.setdefault("sampling", "uniform")
        kw.setdefault("train", False)
        super().__init__(**kw)


@registry.register_processor("gif_train")
class GIFTrainProcessor(VideoBaseProcessor):
    media_loader = staticmethod(load_gif_frames)

    def __init__(self, **kw):
        kw.setdefault("sampling", "headtail")
        kw.setdefault("train", True)
        super().__init__(**kw)
