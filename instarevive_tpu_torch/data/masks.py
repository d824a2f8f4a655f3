"""Inpainting mask synthesis (brush strokes) and the 8-mode flip/rotate
augmentation (``instarevive_tpu/data/masks.py``). The strokes are drawn on
the host with numpy and PIL; the augmentation runs on NHWC tensors on
whatever device holds them.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
from PIL import Image, ImageDraw


def brush_stroke_mask(
    rng: np.random.Generator,
    hw: Tuple[int, int] = (512, 512),
    min_num_vertex: int = 4,
    max_num_vertex: int = 12,
    mean_angle: float = 2 * math.pi / 5,
    angle_range: float = 2 * math.pi / 15,
    min_width: int = 12,
    max_width: int = 40,
) -> np.ndarray:
    """Random brush-stroke mask, 1 = hole; returns (H, W) float32."""
    h, w = hw
    average_radius = math.sqrt(h * h + w * w) / 8
    mask = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(mask)
    for _ in range(int(rng.integers(1, 4))):
        num_vertex = int(rng.integers(min_num_vertex, max_num_vertex))
        angle_min = mean_angle - rng.uniform(0, angle_range)
        angle_max = mean_angle + rng.uniform(0, angle_range)
        angles = []
        for i in range(num_vertex):
            a = rng.uniform(angle_min, angle_max)
            angles.append(2 * math.pi - a if i % 2 == 0 else a)

        vertex = [(int(rng.integers(0, w)), int(rng.integers(0, h)))]
        for a in angles:
            r = float(np.clip(rng.normal(average_radius, average_radius // 2), 0, 2 * average_radius))
            x = np.clip(vertex[-1][0] + r * math.cos(a), 0, w)
            y = np.clip(vertex[-1][1] + r * math.sin(a), 0, h)
            vertex.append((int(x), int(y)))

        width = int(rng.uniform(min_width, max_width))
        draw.line(vertex, fill=1, width=width)
        for v in vertex:
            draw.ellipse((v[0] - width // 2, v[1] - width // 2, v[0] + width // 2, v[1] + width // 2), fill=1)
    if rng.random() > 0.5:
        mask = mask.transpose(Image.FLIP_LEFT_RIGHT)
    if rng.random() > 0.5:
        mask = mask.transpose(Image.FLIP_TOP_BOTTOM)
    return np.asarray(mask, np.float32)


def augment_dihedral(img: torch.Tensor, mode: int) -> torch.Tensor:
    """8-mode flip/rotate augmentation on NHWC: modes 0-3 rotate by 90
    degrees ``mode`` times; 4-7 flip top to bottom, then rotate ``mode - 4``
    times."""
    if mode >= 4:
        img = img.flip(1)
        mode -= 4
    return torch.rot90(img, k=mode, dims=(1, 2))


def invert_augment_dihedral(img: torch.Tensor, mode: int) -> torch.Tensor:
    if mode < 4:
        return torch.rot90(img, k=-mode, dims=(1, 2))
    return torch.rot90(img, k=-(mode - 4), dims=(1, 2)).flip(1)
