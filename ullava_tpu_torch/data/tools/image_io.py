"""Image and label reads of the data layer, through the library that the
JAX line uses for each read: `cv2.imread` + `cvtColor(BGR2RGB)` in the
RES, salient and semantic-seg datasets, `PIL.Image.open(...).convert("RGB")`
in the LLaVA datasets, `np.array(PIL.Image.open(...))` for label images.

Each library is imported only when a read needs it, so that the modules
import without it; where it is missing, ImportError names it.
"""

from __future__ import annotations

import numpy as np


def _cv2(path: str):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"reading {path} needs cv2 (OpenCV), which is not installed") from e
    return cv2


def _pil_image(path: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"reading {path} needs PIL (Pillow), which is not installed") from e
    return Image


def read_rgb(path: str, library: str = "cv2") -> np.ndarray:
    """uint8 [H, W, 3] RGB of the image at `path`, read by `library`:
    "cv2" (`cv2.imread` + BGR -> RGB) or "pil" (`.convert("RGB")`), as the
    JAX line that reads it."""
    if library == "cv2":
        cv2 = _cv2(path)
        image = cv2.imread(path)
        if image is None:
            raise ValueError(f"{path}: cv2 could not read the image")
        return cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
    if library == "pil":
        with _pil_image(path).open(path) as img:
            return np.asarray(img.convert("RGB"))
    raise ValueError(f"unknown image library {library!r}")


def read_label(path: str) -> np.ndarray:
    """The samples of a label image as `np.array(PIL.Image.open(path))`
    gives them: a palette image's indices, not its colours."""
    with _pil_image(path).open(path) as img:
        return np.array(img)
