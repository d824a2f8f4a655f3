"""Patch fold/unfold for split-input (patch-wise) diffusion
(``instarevive_tpu/ops/patching.py``): an image is cut into overlapping
crops, a function runs on all of them at once, and the results are added back
with a border-distance weighting that feathers the overlaps.

The patch offsets follow from the shapes, so ``unfold`` is a stack of slices
and ``fold`` a sequence of slice additions; ``patched_apply`` folds the L
patches into the batch and calls the wrapped function once on
(B * L, kh, kw, C). The border weighting is computed with numpy on the host.
Layouts are NHWC.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["delta_border", "patch_weighting", "unfold", "fold", "patched_apply"]


def delta_border(h: int, w: int) -> np.ndarray:
    """Normalised distance to the nearest image border (0 at the border,
    0.5 at the centre)."""
    y = np.arange(h, dtype=np.float64) / max(h - 1, 1)
    x = np.arange(w, dtype=np.float64) / max(w - 1, 1)
    dy = np.minimum(y, 1.0 - y)[:, None]
    dx = np.minimum(x, 1.0 - x)[None, :]
    return np.minimum(dy, dx)


def patch_weighting(
    kh: int,
    kw: int,
    ly: int,
    lx: int,
    clip_min_weight: float = 0.01,
    clip_max_weight: float = 0.5,
    tie_braker: bool = True,
    clip_min_tie_weight: float = 0.01,
    clip_max_tie_weight: float = 0.5,
) -> np.ndarray:
    """Per-patch feathering weights, (ly * lx, kh, kw): each pixel's distance
    to its patch's border, scaled with ``tie_braker`` by the patch's position
    in the (ly, lx) grid so that interior patches dominate on overlaps."""
    w = np.clip(delta_border(kh, kw), clip_min_weight, clip_max_weight)
    w = np.broadcast_to(w[None], (ly * lx, kh, kw)).copy()
    if tie_braker:
        lw = np.clip(delta_border(ly, lx), clip_min_tie_weight, clip_max_tie_weight)
        w *= lw.reshape(ly * lx, 1, 1)
    return w


def _grid(size: int, k: int, stride: int) -> List[int]:
    n = (size - k) // stride + 1
    if n < 1:
        raise ValueError(f"kernel {k} larger than size {size}")
    return [i * stride for i in range(n)]


def unfold(x: torch.Tensor, kernel_size: Tuple[int, int], stride: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) -> (B, L, kh, kw, C): the crops of ``torch.nn.Unfold``
    without padding or dilation, row-major over the (Ly, Lx) grid."""
    kh, kw = kernel_size
    oys = _grid(x.shape[1], kh, stride[0])
    oxs = _grid(x.shape[2], kw, stride[1])
    return torch.stack([x[:, oy:oy + kh, ox:ox + kw, :] for oy in oys for ox in oxs], dim=1)


def fold(
    patches: torch.Tensor,
    output_hw: Tuple[int, int],
    stride: Tuple[int, int],
    weighting: Optional[np.ndarray] = None,
    normalize: bool = True,
) -> torch.Tensor:
    """(B, L, kh, kw, C) -> (B, H, W, C) weighted overlap-add, accumulated
    in f32. With ``normalize`` the accumulated weight divides the sum, so
    ``fold(unfold(x)) == x`` for any positive weighting."""
    b, l, kh, kw, c = patches.shape
    h, w = output_hw
    oys = _grid(h, kh, stride[0])
    oxs = _grid(w, kw, stride[1])
    if len(oys) * len(oxs) != l:
        raise ValueError(f"{l} patches cannot tile {output_hw} with kernel {(kh, kw)} stride {stride}")
    if weighting is None:
        weighting = np.ones((l, kh, kw), dtype=np.float64)
    weighting = np.asarray(weighting, dtype=np.float64).reshape(l, kh, kw)
    weights = torch.from_numpy(weighting.astype(np.float32)).to(patches.device)

    out = torch.zeros((b, h, w, c), dtype=torch.float32, device=patches.device)
    norm = np.zeros((h, w), dtype=np.float64)
    for idx, (oy, ox) in enumerate((oy, ox) for oy in oys for ox in oxs):
        out[:, oy:oy + kh, ox:ox + kw, :] += patches[:, idx].float() * weights[idx][None, :, :, None]
        norm[oy:oy + kh, ox:ox + kw] += weighting[idx]
    if normalize:
        out = out / torch.from_numpy(norm.astype(np.float32)).to(patches.device)[None, :, :, None]
    return out.to(patches.dtype)


def patched_apply(
    fn: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    kernel_size: Tuple[int, int],
    stride: Tuple[int, int],
    uf: int = 1,
    df: int = 1,
    **weighting_kwargs,
) -> torch.Tensor:
    """Apply ``fn`` patch-wise with feathered overlap-add recombination: one
    call on (B * L, kh, kw, C); the output may change resolution by ``uf``
    (up, as a VAE decode does) or ``1 / df`` (down, as an encode does) and is
    recombined on the scaled grid with the same border weighting, normalised
    over the overlaps."""
    if uf != 1 and df != 1:
        raise ValueError("uf and df are mutually exclusive")
    kh, kw = kernel_size
    b = x.shape[0]
    ly = len(_grid(x.shape[1], kh, stride[0]))
    lx = len(_grid(x.shape[2], kw, stride[1]))

    patches = unfold(x, kernel_size, stride)  # (B, L, kh, kw, C)
    l = patches.shape[1]
    out = fn(patches.reshape((b * l,) + patches.shape[2:]))  # (B * L, kh', kw', C')
    okh, okw = out.shape[1], out.shape[2]
    if okh != kh * uf // df or okw != kw * uf // df:
        raise ValueError(f"fn changed patch {kernel_size} -> {(okh, okw)}, expected scale uf={uf} df={df}")
    out = out.reshape((b, l) + out.shape[1:])

    out_hw = (x.shape[1] * uf // df, x.shape[2] * uf // df)
    out_stride = (stride[0] * uf // df, stride[1] * uf // df)
    return fold(out, out_hw, out_stride, weighting=patch_weighting(okh, okw, ly, lx, **weighting_kwargs))
