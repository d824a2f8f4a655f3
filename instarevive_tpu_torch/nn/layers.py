"""Shared building blocks (``instarevive_tpu/nn/layers.py``).

``Linear`` and ``Conv2d`` cast their input to their compute dtype, as a flax
layer with ``dtype=`` does. That dtype is the weight's own unless the layer's
``compute_dtype`` is set (``set_compute_dtype``): inference casts the weights
once (one ``module.to(bf16)`` turns a model into bf16 compute), training keeps
f32 master weights and casts them per call, so the product runs in bf16 and
the gradient arrives at the f32 parameter in f32. A per-layer dtype rather
than ``torch.autocast``, because autocast picks the dtype per operator (it
would run the f32 adaLN arithmetic and the residual adds its own way), while
this reproduces exactly the casts of the JAX package: input, kernel and bias
to the compute dtype, output in it. ``LayerNorm`` and ``GroupNorm`` take their
statistics in f32 whatever the activation dtype, as flax does. Parameter
names are torch's own, so the reference checkpoints' keys load as they are.

``GroupNorm`` runs through ``ops/norm_kernels.group_norm_silu`` (the CUDA
moments and apply kernels on the card). What the kernels read in another
form than the state dict holds (f32 norm vectors, HWIO conv weights and their
split-tf32 planes) is derived once per module by ``derived`` and rebuilt when
its source changes.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from instarevive_tpu_torch.ops.gn_conv import weight_planes
from instarevive_tpu_torch.ops.norm_kernels import group_norm_silu


@lru_cache(maxsize=32)
def device_constant(make: Callable[..., np.ndarray], args: tuple, device: torch.device) -> torch.Tensor:
    """``make(*args)`` as a tensor on ``device``, copied there once per
    geometry rather than on every forward. Made outside inference mode, so
    a caller that records autograd may use it too."""
    with torch.inference_mode(False):
        return torch.from_numpy(make(*args)).to(device)


def derived(module: nn.Module, name: str, sources: Sequence[torch.Tensor], make: Callable[[], object]):
    """``make()`` cached on ``module`` under ``name`` until one of ``sources``
    changes: an in-place write (an optimizer step, ``copy_``) bumps its
    version, and ``DerivedCache`` drops the whole cache on ``.to(...)`` and
    ``load_state_dict``. The cache is a plain attribute, not a buffer, so
    state-dict keys stay as they are. Made outside inference mode, so any
    later caller may use it."""
    # An inference tensor has no version counter: written in place by other
    # means than load_state_dict, it keeps its stale pack.
    key = tuple((None if t.is_inference() else t._version, t.dtype, t.device, t.data_ptr()) for t in sources)
    cache = module.__dict__.setdefault("_derived", {})
    hit = cache.get(name)
    if hit is None or hit[0] != key:
        with torch.inference_mode(False), torch.no_grad():
            hit = cache[name] = (key, make())
    return hit[1]


class DerivedCache:
    """Mixin for a module that uses ``derived``: conversions (``.to``,
    ``.cuda``, ``.half``: all go through ``_apply``) and ``load_state_dict``
    drop the cache. The key alone would miss ``.to(bf16).to(float32)``
    without a forward between, where version, dtype and device come back
    and the allocator may hand back the old address."""

    def _apply(self, *args, **kwargs):
        self.__dict__.pop("_derived", None)
        return super()._apply(*args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self.__dict__.pop("_derived", None)
        return super()._load_from_state_dict(*args, **kwargs)


def load_built(make: Callable[[], nn.Module], sd, device="cuda") -> nn.Module:
    """``make()`` built on the meta device (no weights drawn), given the
    tensors of the state dict ``sd`` as f32 on ``device``, frozen and in eval
    mode: how the evaluation networks, whose every parameter comes from a
    checkpoint, are made. A module built so holds no buffers that ``sd``
    does not."""
    with torch.device("meta"):
        net = make()
    net.load_state_dict({k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))).float()
                         for k, v in sd.items()}, assign=True)
    return net.to(device).eval().requires_grad_(False)


def set_compute_dtype(module: nn.Module, dtype: Optional[torch.dtype]) -> nn.Module:
    """Make every ``Linear`` and ``Conv2d`` under ``module`` compute in
    ``dtype`` from weights kept in their own dtype (None: back to the
    weight's dtype)."""
    for m in module.modules():
        if isinstance(m, (Linear, Conv2d)):
            m.compute_dtype = dtype
    return module


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """GELU with the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return t if t is None or t.dtype == dtype else t.to(dtype)


class Linear(nn.Linear):
    compute_dtype: Optional[torch.dtype] = None  # None: the weight's dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype or self.weight.dtype
        return F.linear(x.to(dtype), _cast(self.weight, dtype), _cast(self.bias, dtype))


class Conv2d(DerivedCache, nn.Conv2d):
    """NCHW convolution computing in ``compute_dtype`` (the weight's dtype
    unless set)."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype or self.weight.dtype
        return self._conv_forward(x.to(dtype), _cast(self.weight, dtype), _cast(self.bias, dtype))

    def hwio(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(weight as contiguous (kh, kw, Cin, Cout) in its own dtype, bias in
        f32): what ``ops/gn_conv.gn_silu_conv3x3`` reads. Packed once, not
        per call."""
        return derived(self, "hwio", (self.weight, self.bias), lambda: (
            self.weight.detach().permute(2, 3, 1, 0).contiguous(), self.bias.detach().float()))

    def tf32_planes(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The weight's split-tf32 hi and lo planes, each (Cout, kh, kw, Cin)
        f32: what the f32 form of ``ops/gn_conv.gn_silu_conv3x3`` reads
        (``weight_planes``). Made once, not per call: a frozen model pays no
        prepass launch a step."""
        return derived(self, "tf32_planes", (self.weight,),
                       lambda: weight_planes(self.weight.detach().permute(2, 3, 1, 0)))


class TokenGridConv(Conv2d):
    """Depthwise stride-r convolution over a (B, gh * gw, C) token grid, row
    major: ``Conv2d(c, c, r, stride=r, groups=c)`` without padding, so
    (B, gh/r * gw/r, C) comes out. Where r divides the grid it agrees with
    flax's ``SAME`` padding; elsewhere the two differ, so that raises."""

    def __init__(self, channels: int, ratio: int):
        super().__init__(channels, channels, ratio, stride=ratio, groups=channels)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        (b, n, c), (gh, gw), r = x.shape, hw, self.stride[0]
        if gh % r or gw % r:
            raise ValueError(f"a {gh}x{gw} token grid: the stride-{r} convolution needs a grid that {r} divides")
        y = super().forward(x.reshape(b, gh, gw, c).permute(0, 3, 1, 2))
        return y.flatten(2).transpose(1, 2)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last dim with f32 statistics; output in x.dtype,
    which is the compute dtype wherever x comes out of a ``Linear`` or a
    ``Conv2d`` (the DiT's qk-norm and KV-compression norms, flax's
    ``LayerNorm(dtype=...)``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = None if self.weight is None else self.weight.float()
        b = None if self.bias is None else self.bias.float()
        return F.layer_norm(x.float(), self.normalized_shape, w, b, self.eps).to(x.dtype)


class GroupNorm(DerivedCache, nn.GroupNorm):
    """GroupNorm on NCHW with f32 statistics and an optional SiLU; output in
    x.dtype. On the card x must lie channels-last in memory: the kernels read
    its NHWC view, and nothing here copies a tensor into that layout."""

    def affine_f32(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(weight, bias) in f32, as the kernels read them."""
        return derived(self, "affine_f32", (self.weight, self.bias),
                       lambda: (self.weight.detach().float(), self.bias.detach().float()))

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        gamma, beta = self.affine_f32()
        y = group_norm_silu(x.permute(0, 2, 3, 1), gamma, beta, self.num_groups, self.eps, silu)
        return y.permute(0, 3, 1, 2)


class Mlp(nn.Module):
    """timm-style MLP: fc1 -> act -> fc2."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None, act: Callable = gelu_tanh):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features)
        self.fc2 = Linear(hidden_features, out_features or in_features)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """NHWC pixel-unshuffle with torch's channel order (c*r^2 + i*r + j):
    (B, H, W, C) -> (B, H/r, W/r, C*r*r), contiguous."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // r, r, w // r, r, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // r, w // r, c * r * r)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """NHWC pixel-shuffle with torch's channel order."""
    return F.pixel_shuffle(x.permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """ADM sinusoidal embedding: (N,) -> (N, dim) f32, cos|sin halves."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb
