"""MAE-style token masking for DiT training
(``instarevive_tpu/ops/masking.py``): ``get_mask_indices`` (random, FFT- or
Laplacian-importance token selection), ``mask_out_tokens`` (gather the kept
tokens) and ``unmask_tokens`` (scatter back with a learned mask token).

What is drawn comes from an explicit ``torch.Generator`` on the tokens'
device, or is handed in as ``noise`` (uniform in [0, 1), (B, N)), so that a
test can give this package and the JAX package the same numbers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from instarevive_tpu_torch.ops.color import constant
from instarevive_tpu_torch.ops.filters import depthwise_conv2d

_LAPLACIAN = ((0.0, 1.0, 0.0), (1.0, -4.0, 1.0), (0.0, 1.0, 0.0))


def _importance_laplacian(x_tokens: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Per-token magnitude of a Laplacian response (detail importance)."""
    b, n, c = x_tokens.shape
    resp = depthwise_conv2d(x_tokens.reshape(b, *hw, c), constant(_LAPLACIAN, x_tokens.device))
    return resp.abs().mean(dim=-1).reshape(b, n)


def _importance_fft(x_tokens: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """High-frequency energy per token (FFT high-pass importance)."""
    b, n, c = x_tokens.shape
    h, w = hw
    f = torch.fft.fft2(x_tokens.reshape(b, h, w, c).float(), dim=(1, 2))
    fy = torch.fft.fftfreq(h, device=x_tokens.device)[:, None]
    fx = torch.fft.fftfreq(w, device=x_tokens.device)[None, :]
    highpass = ((fy.abs() > 0.25 / 2) | (fx.abs() > 0.25 / 2))[None, ..., None]
    hf = torch.fft.ifft2(f * highpass, dim=(1, 2)).real
    return hf.abs().mean(dim=-1).reshape(b, n)


def get_mask_indices(
    generator: Optional[torch.Generator],
    x_tokens: torch.Tensor,
    keep_ratio: float,
    mask_type: str = "random",
    hw: Optional[Tuple[int, int]] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (keep_idx (B, K), restore_idx (B, N)); K = int(N * keep_ratio).

    'random' shuffles; 'fft' and 'laplacian' keep the most detailed tokens,
    their scores perturbed by the noise (a stochastic importance pick).
    """
    b, n, _ = x_tokens.shape
    k = max(1, int(n * keep_ratio))
    if noise is None:
        noise = torch.rand((b, n), generator=generator, device=x_tokens.device)
    if mask_type == "random":
        scores = noise
    else:
        imp = _importance_laplacian(x_tokens, hw) if mask_type == "laplacian" else _importance_fft(x_tokens, hw)
        imp = imp / imp.amax(dim=1, keepdim=True).clamp_min(1e-8)
        scores = imp + 0.1 * noise
    order = torch.argsort(-scores, dim=1, stable=True)  # the highest first
    return order[:, :k], torch.argsort(order, dim=1, stable=True)


def mask_out_tokens(x: torch.Tensor, keep_idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) -> (B, K, C) gather."""
    return torch.gather(x, 1, keep_idx[..., None].expand(-1, -1, x.shape[-1]))


def unmask_tokens(x_kept: torch.Tensor, restore_idx: torch.Tensor, mask_token: torch.Tensor, n: int) -> torch.Tensor:
    """(B, K, C) + mask token -> (B, N, C) in the original order."""
    b, k, c = x_kept.shape
    fill = mask_token.reshape(1, 1, c).to(x_kept.dtype).expand(b, n - k, c)
    full = torch.cat([x_kept, fill], dim=1)
    return torch.gather(full, 1, restore_idx[..., None].expand(-1, -1, c))
