"""Host-side image IO and the CLI's resize/pad conventions
(``instarevive_tpu/utils/image_io.py``; numpy and PIL only).

``auto_resize``: short edge up to >= size via PIL bicubic; ``pad_to_multiple``:
zero-pad bottom/right to a multiple; ``center_crop_arr``: the ADM center crop
used with ``--use_center_crop``.
"""

from __future__ import annotations

import io
import math
import os
from typing import List, Tuple

import numpy as np
from PIL import Image

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".tif", ".tiff")


def list_image_files(folder: str, recursive: bool = False) -> List[str]:
    """The images directly in ``folder`` (or, ``recursive``, anywhere under
    it), sorted."""
    if recursive:
        return sorted(os.path.join(root, f) for root, _, files in os.walk(folder)
                      for f in files if f.lower().endswith(IMG_EXTS))
    return sorted(os.path.join(folder, f) for f in os.listdir(folder) if f.lower().endswith(IMG_EXTS))


def load_image(path: str) -> Image.Image:
    return Image.open(path).convert("RGB")


def to_uint8(arr01: np.ndarray) -> np.ndarray:
    """[0,1] float -> the 8-bit levels every entry point writes."""
    return np.clip(arr01 * 255.0 + 0.5, 0, 255).astype(np.uint8)


def save_image(arr01: np.ndarray, path: str) -> None:
    """[0,1] HWC float -> PNG."""
    Image.fromarray(to_uint8(arr01)).save(path)


def png_bytes(img: Image.Image) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "PNG")
    return buf.getvalue()


def prepare(img: Image.Image, size: int = 512, multiple: int = 64) -> Tuple[np.ndarray, int, int]:
    """What the servers feed the pipeline for one image: RGB, short edge
    raised to ``size``, zero-padded to a multiple, as (H, W, 3) float32 in
    [0, 1], with the height and width before the pad (the crop of the answer)."""
    resized = auto_resize(img.convert("RGB"), size)
    x = pad_to_multiple(np.array(resized), multiple).astype(np.float32) / 255.0
    return x, resized.height, resized.width


def auto_resize(img: Image.Image, size: int) -> Image.Image:
    """Upscale so the short edge >= size (PIL bicubic), else copy."""
    short_edge = min(img.size)
    if short_edge < size:
        r = size / short_edge
        img = img.resize(tuple(math.ceil(x * r) for x in img.size), Image.BICUBIC)
    else:
        img = img.copy()
    return img


def pad_to_multiple(img: np.ndarray, scale: int) -> np.ndarray:
    """Zero-pad bottom/right so H, W are multiples of ``scale``."""
    h, w = img.shape[:2]
    ph = (scale - h % scale) % scale
    pw = (scale - w % scale) % scale
    if ph == 0 and pw == 0:
        return img
    return np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="constant")


def center_crop_arr(img: Image.Image, size: int) -> np.ndarray:
    """ADM-style center crop: downsample by halves, then bicubic to short
    edge == size, then center crop (utils/image/common.py center_crop_arr)."""
    while min(*img.size) >= 2 * size:
        img = img.resize(tuple(x // 2 for x in img.size), Image.BOX)
    scale = size / min(*img.size)
    img = img.resize(tuple(round(x * scale) for x in img.size), Image.BICUBIC)
    arr = np.array(img)
    y = (arr.shape[0] - size) // 2
    x = (arr.shape[1] - size) // 2
    return arr[y : y + size, x : x + size]
