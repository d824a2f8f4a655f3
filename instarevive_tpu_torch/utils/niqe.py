"""NIQE (Natural Image Quality Evaluator), no-reference IQA: the port's own
copy of ``instarevive_tpu/utils/niqe.py``, in float64 numpy on the host, with
the half-scale image made by the port's ``ops/resize.imresize_matlab``.

A self-contained implementation of Mittal et al., "Making a 'Completely
Blind' Image Quality Analyzer" (IEEE SPL 2013), following the basicsr /
pyiqa conventions (Y channel in [0,255], MATLAB bicubic half-downsample
between scales, 96px blocks, 18 features per scale).

The metric needs a *pristine model* (mean + covariance of the 36-dim
features over patches of undistorted images). Two ways to get one:

- ``load_pris_params(path)`` reads the standard ``niqe_pris_params.npz``
  shipped by basicsr/pyiqa (keys ``mu_pris_param``/``cov_pris_param``),
  so scores are comparable with published numbers, or
- ``fit_pristine_model(images)`` fits one from any set of pristine
  images (useful in zero-egress environments).

Host-side numpy: per-image feature extraction is a few hundred small
moment computations, not work for the card, and needs NaN-aware
covariance.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from instarevive_tpu_torch.ops.resize import imresize_matlab

__all__ = [
    "NiqePristineModel",
    "load_pris_params",
    "fit_pristine_model",
    "niqe",
    "niqe_features",
]

# Precomputed lookup for moment-matching the (A)GGD shape parameter:
# gam -> Gamma(1/g)Gamma(3/g)/Gamma(2/g)^2 over the standard search grid.
_GAM_GRID = np.arange(0.2, 10.001, 0.001)
_R_GAM = (
    np.array([math.gamma(1.0 / g) for g in _GAM_GRID])
    * np.array([math.gamma(3.0 / g) for g in _GAM_GRID])
    / np.array([math.gamma(2.0 / g) for g in _GAM_GRID]) ** 2
)


def _ggd_fit(x: np.ndarray) -> tuple[float, float]:
    """Fit a zero-mean generalized Gaussian: returns (alpha, sigma^2)."""
    x = x.ravel()
    sig_sq = float(np.mean(x**2))
    e_abs = float(np.mean(np.abs(x)))
    if sig_sq <= 0 or e_abs <= 0:
        return 10.0, 0.0
    rho = sig_sq / (e_abs**2)
    alpha = _GAM_GRID[int(np.argmin(np.abs(_R_GAM - rho)))]
    return float(alpha), sig_sq


def _aggd_fit(x: np.ndarray) -> tuple[float, float, float]:
    """Fit an asymmetric GGD: returns (alpha, beta_left, beta_right)."""
    x = x.ravel()
    left = x[x < 0]
    right = x[x > 0]
    # std of each half around zero
    sigma_l = math.sqrt(np.mean(left**2)) if left.size else 0.0
    sigma_r = math.sqrt(np.mean(right**2)) if right.size else 0.0
    if sigma_l == 0.0 or sigma_r == 0.0:
        return 10.0, sigma_l**2, sigma_r**2
    gamma_hat = sigma_l / sigma_r
    e_abs = float(np.mean(np.abs(x)))
    sig_sq = float(np.mean(x**2))
    r_hat = (e_abs**2) / sig_sq if sig_sq > 0 else 0.0
    r_hat_norm = (
        r_hat * (gamma_hat**3 + 1.0) * (gamma_hat + 1.0) / ((gamma_hat**2 + 1.0) ** 2)
    )
    # AGGD moment matching uses the reciprocal ratio G(2/a)^2/(G(1/a)G(3/a))
    alpha = _GAM_GRID[int(np.argmin((1.0 / _R_GAM - r_hat_norm) ** 2))]
    beta_l = sigma_l * math.sqrt(math.gamma(1.0 / alpha) / math.gamma(3.0 / alpha))
    beta_r = sigma_r * math.sqrt(math.gamma(1.0 / alpha) / math.gamma(3.0 / alpha))
    return float(alpha), beta_l, beta_r


def _gaussian_window(size: int = 7, sigma: float = 7.0 / 6.0) -> np.ndarray:
    half = (size - 1) / 2.0
    coords = np.arange(size) - half
    g = np.exp(-(coords**2) / (2.0 * sigma**2))
    w = np.outer(g, g)
    return w / w.sum()


def _filter2_same(img: np.ndarray, win: np.ndarray) -> np.ndarray:
    """'same'-size 2-D correlation with edge replication (nearest)."""
    kh, kw = win.shape
    ph, pw = kh // 2, kw // 2
    padded = np.pad(img, ((ph, ph), (pw, pw)), mode="edge")
    # separable? the window is an outer product of one gaussian — exploit it
    gy = win.sum(axis=1)
    gx = win[np.argmax(gy)] / win[np.argmax(gy)].sum()
    gy = gy / gy.sum()
    tmp = np.apply_along_axis(lambda r: np.convolve(r, gx[::-1], mode="valid"), 1, padded)
    out = np.apply_along_axis(lambda c: np.convolve(c, gy[::-1], mode="valid"), 0, tmp)
    return out * win.sum()


def _mscn(img: np.ndarray, win: np.ndarray) -> np.ndarray:
    mu = _filter2_same(img, win)
    sigma = np.sqrt(np.abs(_filter2_same(img * img, win) - mu * mu))
    return (img - mu) / (sigma + 1.0)


_SHIFTS = [(0, 1), (1, 0), (1, 1), (1, -1)]  # H, V, D1, D2


def _block_features(mscn: np.ndarray) -> np.ndarray:
    """18 NIQE features of one normalized block.

    Follows MATLAB/basicsr: the MSCN coefficients themselves are ALSO fit
    with the asymmetric estimator, feature 2 being the mean of the two
    scale parameters.
    """
    feats = []
    alpha, beta_l, beta_r = _aggd_fit(mscn)
    feats += [alpha, (beta_l + beta_r) / 2.0]
    for dy, dx in _SHIFTS:
        shifted = np.roll(mscn, shift=(dy, dx), axis=(0, 1))
        pair = (mscn * shifted).ravel()
        a, bl, br = _aggd_fit(pair)
        mean = (br - bl) * (math.gamma(2.0 / a) / math.gamma(1.0 / a))
        feats += [a, mean, bl, br]
    return np.asarray(feats, dtype=np.float64)


def niqe_features(img_y: np.ndarray, block_size: int = 96) -> np.ndarray:
    """Per-patch 36-dim NIQE features of a grayscale image in [0, 255].

    Two scales (full + MATLAB-bicubic half); blocks are anchored on the
    scale-1 grid so each patch's features from both scales concatenate.
    Returns (num_patches, 36).
    """
    img = np.asarray(img_y, dtype=np.float64)
    h, w = img.shape
    nbh, nbw = h // block_size, w // block_size
    if nbh == 0 or nbw == 0:
        raise ValueError(f"image {img.shape} smaller than one {block_size}px block")
    img = img[: nbh * block_size, : nbw * block_size]
    win = _gaussian_window()

    per_scale = []
    for scale in (1, 2):
        mscn = _mscn(img, win)
        b = block_size // scale
        feats = np.stack(
            [
                _block_features(mscn[i * b : (i + 1) * b, j * b : (j + 1) * b])
                for i in range(nbh)
                for j in range(nbw)
            ]
        )
        per_scale.append(feats)
        if scale == 1:
            hh, ww = img.shape
            half = imresize_matlab(torch.from_numpy((img[None, :, :, None] / 255.0).astype(np.float32)),
                                   (hh // 2, ww // 2))
            img = half[0, :, :, 0].numpy().astype(np.float64) * 255.0
    return np.concatenate(per_scale, axis=1)


@dataclass
class NiqePristineModel:
    mu: np.ndarray  # (36,)
    cov: np.ndarray  # (36, 36)


def load_pris_params(path: str) -> NiqePristineModel:
    """Load basicsr/pyiqa's ``niqe_pris_params.npz`` pristine model."""
    data = np.load(path)
    return NiqePristineModel(
        mu=np.asarray(data["mu_pris_param"], dtype=np.float64).reshape(-1),
        cov=np.asarray(data["cov_pris_param"], dtype=np.float64),
    )


def _nan_mean_cov(feats: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    mu = np.nanmean(feats, axis=0)
    ok = ~np.isnan(feats).any(axis=1)
    cov = np.cov(feats[ok], rowvar=False)
    return mu, np.atleast_2d(cov)


def fit_pristine_model(images: list[np.ndarray], block_size: int = 96) -> NiqePristineModel:
    """Fit a pristine model from grayscale [0,255] images (≥1 block each)."""
    feats = np.concatenate([niqe_features(im, block_size) for im in images], axis=0)
    mu, cov = _nan_mean_cov(feats)
    return NiqePristineModel(mu=mu, cov=cov)


def _to_gray_255(img: np.ndarray) -> np.ndarray:
    """RGB float [0,1] (H,W,3) or grayscale → Y in [0,255].

    RGB uses basicsr/pyiqa ``to_y_channel`` semantics (limited-range
    BT.601: 65.481 R + 128.553 G + 24.966 B + 16) and rounds, matching
    ``pyiqa.create_metric('niqe')`` preprocessing — the published
    ``niqe_pris_params.npz`` pristine model was fit under exactly this
    convention, so scores are only comparable if we reproduce it.
    """
    img = np.asarray(img, dtype=np.float64)
    if img.ndim == 3 and img.shape[-1] == 3:
        if img.max() > 1.5:  # [0,255] input
            img = img / 255.0
        img = img @ np.array([65.481, 128.553, 24.966]) + 16.0
    elif img.max() <= 1.5:  # grayscale [0,1] input
        img = img * 255.0
    return np.round(img)


def niqe(img: np.ndarray, pris: NiqePristineModel, block_size: int = 96) -> float:
    """NIQE score (lower = more natural). Accepts RGB [0,1] or Y [0,255]."""
    feats = niqe_features(_to_gray_255(img), block_size)
    mu_d, cov_d = _nan_mean_cov(feats)
    diff = pris.mu - mu_d
    mid_cov = (pris.cov + cov_d) / 2.0
    inv = np.linalg.pinv(mid_cov)
    return float(np.sqrt(max(diff @ inv @ diff, 0.0)))
