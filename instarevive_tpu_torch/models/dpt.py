"""MiDaS monocular depth (DPT-Hybrid, DPT-Large, DPT-B/16, MiDaS v2.1 and
v2.1-small), the PyTorch port of ``instarevive_tpu/models/dpt.py``.

Modules are NCHW inside; a model takes a normalised (B, H, W, 3) image and
returns (B, H, W) non-negative inverse depth, as the JAX modules do.

* DPT (``DPTDepthModel``): a ViT (or, for ``vitb_rn50_384``, the ResNetV2
  hybrid: a stem and three stages of weight-standardised, TF-``SAME``
  convolutions with GroupNorm) whose hook blocks are reassembled (readout,
  1x1 conv, a stride-k transposed conv up or a stride-2 conv down) into four
  levels, fused by RefineNet blocks, and a depth head. The ViT's attention
  goes through ``ops.attention.attention``: K1 (``csrc/flash_attn_fwd.cu``)
  at head dim 64 on the card, over 577 tokens at 384 x 384.
* ``MidasNet`` (v2.1): a ResNeXt101-32x8d encoder and the non-custom fusion
  blocks; ``MidasNetSmall``: an EfficientNet-lite3 encoder (ReLU6, TF
  ``SAME``) and the expanding custom fusion blocks.

Parameter names are those of the official (ISL) checkpoints
(``pretrained.model.blocks.N.attn.qkv``, ``pretrained.act_postprocessN.*``,
``scratch.refinenetN.resConfUnitK.*``, ``pretrained.layerN.*``), with what the
JAX importers fold folded here too: the hybrid's weight standardisation
(eps 1e-8, ``_ws``) and every BatchNorm of the v2.1 encoders (eps 1e-5, and
1e-3 for EfficientNet's ``tf_`` BatchNorms) into the convolution before
it, which then has a bias. ``load_official`` reads an official state dict
that way; ``convert/from_jax`` carries the JAX package's params. Keys a
forward never uses (the ViT's final norm and head, ``refinenet4``'s first
unit) are not held.

``MiDaSInference`` maps a [0, 1] batch to depth at its own size: the
aspect-keeping resize to the net size (bicubic, ``midas_transform_size``),
the model's normalisation, the net, a bicubic resize back; ``depth_fn`` is
the ``train.ldm_tasks.depth2image_loss`` hook.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from instarevive_tpu_torch.convert.checkpoint_layouts import strip_prefixes
from instarevive_tpu_torch.ops.attention import attention


def same_pad(x: torch.Tensor, k: int, s: int, value: float = 0.0) -> torch.Tensor:
    """TF ``SAME`` padding of an NCHW map for a k x k window at stride s
    (the lower side gets the smaller half)."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value) if any(pads) else x


class SameConv2d(nn.Conv2d):
    """A convolution under TF ``SAME`` padding."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(same_pad(x, self.kernel_size[0], self.stride[0]), self.weight, self.bias, self.stride,
                        0, 1, self.groups)


def _conv3(cin: int, cout: int, bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, bias=bias)


def _up2(x: torch.Tensor, align_corners: bool) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=align_corners)


# ------------------------------------------------------------------ ViT ---


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads, d // self.heads).permute(2, 0, 3, 1, 4)
        return self.proj(attention(q, k, v).transpose(1, 2).reshape(b, n, d))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(dim, hidden), nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """timm's pre-LN ViT block (fused qkv, exact GELU)."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1, self.norm2 = nn.LayerNorm(dim, eps=1e-6), nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


# ------------------------------------------------- ResNetV2 (dpt_hybrid) ---


class GroupNormAct(nn.GroupNorm):
    def __init__(self, groups: int, channels: int, act: bool = True):
        super().__init__(groups, channels, eps=1e-5)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = super().forward(x)
        return F.relu(x) if self.act else x


class BottleneckV2(nn.Module):
    """timm ResNetV2's non-preactivation bottleneck; its convolutions hold
    standardised weights."""

    def __init__(self, cin: int, out_chs: int, mid_chs: int, stride: int, groups: int):
        super().__init__()
        self.conv1 = SameConv2d(cin, mid_chs, 1, bias=False)
        self.norm1 = GroupNormAct(groups, mid_chs)
        self.conv2 = SameConv2d(mid_chs, mid_chs, 3, stride=stride, bias=False)
        self.norm2 = GroupNormAct(groups, mid_chs)
        self.conv3 = SameConv2d(mid_chs, out_chs, 1, bias=False)
        self.norm3 = GroupNormAct(groups, out_chs, act=False)
        self.downsample = None
        if cin != out_chs or stride != 1:
            self.downsample = nn.Module()
            self.downsample.conv = SameConv2d(cin, out_chs, 1, stride=stride, bias=False)
            self.downsample.norm = GroupNormAct(groups, out_chs, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.downsample is None else self.downsample.norm(self.downsample.conv(x))
        y = self.norm3(self.conv3(self.norm2(self.conv2(self.norm1(self.conv1(x))))))
        return F.relu(y + shortcut)


class ResNetV2(nn.Module):
    """Stem and three stages; the features after each stage (/4, /8, /16)."""

    def __init__(self, layers=(3, 4, 9), stem_chs: int = 64, base_chs: int = 256, groups: int = 32):
        super().__init__()
        self.stem = nn.Module()
        self.stem.conv = SameConv2d(3, stem_chs, 7, stride=2, bias=False)
        self.stem.norm = GroupNormAct(groups, stem_chs)
        self.stages = nn.ModuleList()
        cin = stem_chs
        for si, depth in enumerate(layers):
            out = base_chs * 2 ** si
            stage = nn.Module()
            stage.blocks = nn.ModuleList(
                BottleneckV2(cin if bi == 0 else out, out, out // 4, 2 if (si > 0 and bi == 0) else 1, groups)
                for bi in range(depth))
            self.stages.append(stage)
            cin = out

    def forward(self, x: torch.Tensor):
        x = self.stem.norm(self.stem.conv(x))
        x = F.max_pool2d(same_pad(x, 3, 2, float("-inf")), 3, 2)
        feats = []
        for stage in self.stages:
            for blk in stage.blocks:
                x = blk(x)
            feats.append(x)
        return feats


# ------------------------------------------------------- DPT components ---


class Readout(nn.Module):
    """The readout token: ignore | add | project (a Linear of [token,
    readout] and a GELU)."""

    def __init__(self, mode: str, dim: int):
        super().__init__()
        if mode not in ("ignore", "add", "project"):
            raise ValueError(f"unknown readout {mode!r}")
        self.mode = mode
        if mode == "project":
            self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cls, rest = tokens[:, :1], tokens[:, 1:]
        if self.mode == "ignore":
            return rest
        if self.mode == "add":
            return rest + cls
        return self.project(torch.cat([rest, cls.expand_as(rest)], dim=-1))


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1, self.conv2 = _conv3(features, features), _conv3(features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    """RefineNet fusion: the skip's unit added, a unit, a 2x bilinear
    upsample (corners aligned for DPT and the custom block); the custom
    block (``out_features`` given, or DPT's) ends in a 1x1 ``out_conv``."""

    def __init__(self, features: int, skip: bool, out_conv: bool = True, out_features: Optional[int] = None):
        super().__init__()
        if skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, out_features or features, 1) if out_conv else None

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = _up2(self.resConfUnit2(x), align_corners=True)
        return x if self.out_conv is None else self.out_conv(x)


class Head(nn.Module):
    """``scratch.output_conv``: conv 3x3 (``0``), 2x bilinear, conv 3x3
    (``2``), ReLU, conv 1x1 (``4``), ReLU when non-negative."""

    def __init__(self, features: int, mid: int, align_corners: bool, non_negative: bool):
        super().__init__()
        self.align_corners, self.non_negative = align_corners, non_negative
        for name, conv in (("0", _conv3(features, mid)), ("2", _conv3(mid, 32)), ("4", nn.Conv2d(32, 1, 1))):
            self.add_module(name, conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _up2(self._modules["0"](x), self.align_corners)
        y = self._modules["4"](F.relu(self._modules["2"](y)))
        return (F.relu(y) if self.non_negative else y)[:, 0]


def _scratch(in_chs: Sequence[int], widths: Sequence[int], head: Head, fusion: Sequence[nn.Module]) -> nn.Module:
    """``scratch``: the 3x3 ``layerN_rn`` convolutions, ``refinenet1..4``
    (``fusion`` in that order) and the head."""
    scratch = nn.Module()
    for li in range(4):
        setattr(scratch, f"layer{li + 1}_rn", _conv3(in_chs[li], widths[li], bias=False))
    for ri, block in enumerate(fusion):
        setattr(scratch, f"refinenet{ri + 1}", block)
    scratch.output_conv = head
    return scratch


def _decode(scratch: nn.Module, layers) -> torch.Tensor:
    rn = [getattr(scratch, f"layer{li + 1}_rn")(layers[li]) for li in range(4)]
    path = scratch.refinenet4(rn[3])
    path = scratch.refinenet3(path, rn[2])
    path = scratch.refinenet2(path, rn[1])
    path = scratch.refinenet1(path, rn[0])
    return scratch.output_conv(path)


# ------------------------------------------------------------ the model ---


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    vit_dim: int = 768
    vit_depth: int = 12
    vit_heads: int = 12
    patch: int = 16
    hooks: Tuple[int, int, int, int] = (0, 1, 8, 11)
    layer_chs: Tuple[int, int, int, int] = (256, 512, 768, 768)
    features: int = 256
    readout: str = "project"
    non_negative: bool = True
    hybrid: bool = True
    rn_layers: Tuple[int, ...] = (3, 4, 9)
    rn_stem_chs: int = 64
    rn_base_chs: int = 256
    gn_groups: int = 32
    pos_grid: int = 24  # the stored position grid (384 / 16)


VARIANTS = {
    "vitl16_384": DPTConfig(vit_dim=1024, vit_depth=24, vit_heads=16, hooks=(5, 11, 17, 23),
                            layer_chs=(256, 512, 1024, 1024), hybrid=False),
    "vitb16_384": DPTConfig(hooks=(2, 5, 8, 11), layer_chs=(96, 192, 384, 768), hybrid=False),
    "vitb_rn50_384": DPTConfig(),
}


class DPTDepthModel(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.vit_dim
        self.pretrained = nn.Module()
        vit = self.pretrained.model = nn.Module()
        vit.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        vit.pos_embed = nn.Parameter(torch.zeros(1, 1 + cfg.pos_grid ** 2, d))
        vit.patch_embed = nn.Module()
        if cfg.hybrid:
            vit.patch_embed.backbone = ResNetV2(cfg.rn_layers, cfg.rn_stem_chs, cfg.rn_base_chs, cfg.gn_groups)
            rn_out = cfg.rn_base_chs * 2 ** (len(cfg.rn_layers) - 1)
            vit.patch_embed.proj = nn.Conv2d(rn_out, d, 1)
        else:
            vit.patch_embed.proj = nn.Conv2d(3, d, cfg.patch, stride=cfg.patch)
        vit.blocks = nn.ModuleList(Block(d, cfg.vit_heads) for _ in range(cfg.vit_depth))
        for li, scale in enumerate((4, 2, 1, -2)):
            if cfg.hybrid and li < 2:
                continue
            c = cfg.layer_chs[li]
            post = nn.ModuleDict({"0": Readout(cfg.readout, d), "3": nn.Conv2d(d, c, 1)})
            if scale > 1:
                post["4"] = nn.ConvTranspose2d(c, c, scale, stride=scale)
            elif scale == -2:
                post["4"] = nn.Conv2d(c, c, 3, stride=2, padding=1)
            setattr(self.pretrained, f"act_postprocess{li + 1}", post)
        f = cfg.features
        self.scratch = _scratch(cfg.layer_chs, (f,) * 4, Head(f, f // 2, True, cfg.non_negative),
                                [FeatureFusionBlock(f, skip=ri < 3) for ri in range(4)])

    def _pos_embed(self, gh: int, gw: int) -> torch.Tensor:
        pos, g = self.pretrained.model.pos_embed, self.cfg.pos_grid
        if (gh, gw) == (g, g):
            return pos
        grid = pos[:, 1:].reshape(1, g, g, -1).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, (gh, gw), mode="bilinear", align_corners=False)
        return torch.cat([pos[:, :1], grid.flatten(2).transpose(1, 2)], dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg, vit = self.cfg, self.pretrained.model
        x = x.permute(0, 3, 1, 2)
        b, _, h, w = x.shape
        gh, gw = h // cfg.patch, w // cfg.patch
        rn_feats = None
        if cfg.hybrid:
            rn_feats = vit.patch_embed.backbone(x)
            tokens = vit.patch_embed.proj(rn_feats[-1])
        else:
            tokens = vit.patch_embed.proj(x)
        tokens = tokens.flatten(2).transpose(1, 2)
        tokens = torch.cat([vit.cls_token.expand(b, -1, -1), tokens], dim=1) + self._pos_embed(gh, gw)
        acts = {}
        for i, blk in enumerate(vit.blocks):
            tokens = blk(tokens)
            if i in cfg.hooks:
                acts[i] = tokens
        layers = []
        for li in range(4):
            if cfg.hybrid and li < 2:
                layers.append(rn_feats[li])
                continue
            post = getattr(self.pretrained, f"act_postprocess{li + 1}")
            y = post["0"](acts[cfg.hooks[li]]).transpose(1, 2).reshape(b, -1, gh, gw)
            y = post["3"](y)
            layers.append(post["4"](y) if "4" in post else y)
        return _decode(self.scratch, layers)


# ------------------------------------------------- MidasNet (midas_v21) ---


class ResNeXtBottleneck(nn.Module):
    """torchvision's ResNeXt bottleneck, its BatchNorms folded into the
    convolutions."""

    def __init__(self, cin: int, planes: int, width: int, stride: int, groups: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, width, 1)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1, groups=groups)
        self.conv3 = nn.Conv2d(width, planes, 1)
        self.downsample = None
        if cin != planes or stride != 1:
            self.downsample = nn.ModuleDict({"0": nn.Conv2d(cin, planes, 1, stride=stride)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.downsample is None else self.downsample["0"](x)
        y = self.conv3(F.relu(self.conv2(F.relu(self.conv1(x)))))
        return F.relu(y + shortcut)


class MidasNet(nn.Module):
    """MiDaS v2.1: ResNeXt101-32x8d (``pretrained.layer1`` = stem conv at
    ``.0`` and the first stage at ``.4``, then ``layer2..4``), the
    non-custom fusion, a head whose upsample leaves the corners free."""

    def __init__(self, features: int = 256, non_negative: bool = True, layers=(3, 4, 23, 3), stem_chs: int = 64,
                 groups: int = 32, width_per_group: int = 8):
        super().__init__()
        self.pretrained = nn.Module()
        stem = nn.Conv2d(3, stem_chs, 7, stride=2, padding=3)
        cin, chs = stem_chs, []
        for si, depth in enumerate(layers):
            planes = stem_chs * 4 * 2 ** si
            width = int(stem_chs * 2 ** si * width_per_group * groups / 64)
            blocks = nn.ModuleList(
                ResNeXtBottleneck(cin if bi == 0 else planes, planes, width, 2 if (si > 0 and bi == 0) else 1, groups)
                for bi in range(depth))
            setattr(self.pretrained, f"layer{si + 1}",
                    nn.ModuleDict({"0": stem, "4": blocks}) if si == 0 else blocks)
            cin = planes
            chs.append(planes)
        self.scratch = _scratch(chs, (features,) * 4, Head(features, 128, False, non_negative),
                                [FeatureFusionBlock(features, skip=ri < 3, out_conv=False) for ri in range(4)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        l1 = self.pretrained.layer1
        x = F.max_pool2d(F.relu(l1["0"](x)), 3, 2, padding=1)
        feats = []
        for si, blocks in enumerate((l1["4"], self.pretrained.layer2, self.pretrained.layer3, self.pretrained.layer4)):
            for blk in blocks:
                x = blk(x)
            feats.append(x)
        return _decode(self.scratch, feats)


# -------------------------------------- MidasNet_small (midas_v21_small) ---

# tf_efficientnet_lite3: (repeats, out_ch, kernel, stride, expand_ratio) a stage
LITE3_STAGES: Tuple[Tuple[int, int, int, int, int], ...] = (
    (1, 24, 3, 1, 1),
    (3, 32, 3, 2, 6),
    (3, 48, 5, 2, 6),
    (5, 96, 3, 2, 6),
    (5, 136, 5, 1, 6),
    (6, 232, 5, 2, 6),
    (1, 384, 3, 1, 6),
)
# where each stage sits in the official split (pretrained.layerN.M)
LITE3_SLOTS = ("layer1.3", "layer1.4", "layer2.0", "layer3.0", "layer3.1", "layer4.0", "layer4.1")


def _relu6(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x)


class MBConvLite(nn.Module):
    """EfficientNet-lite's depthwise-separable (expand 1: ``conv_dw``,
    ``conv_pw``) and inverted-residual (``conv_pw``, ``conv_dw``,
    ``conv_pwl``) blocks: no squeeze-excite, ReLU6, TF ``SAME``, BatchNorms
    folded."""

    def __init__(self, cin: int, out_ch: int, kernel: int, stride: int, expand: int):
        super().__init__()
        self.expand, self.residual = expand, stride == 1 and cin == out_ch
        mid = cin * expand
        if expand > 1:
            self.conv_pw = nn.Conv2d(cin, mid, 1)
        self.conv_dw = SameConv2d(mid, mid, kernel, stride=stride, groups=mid)
        if expand > 1:
            self.conv_pwl = nn.Conv2d(mid, out_ch, 1)
        else:
            self.conv_pw = nn.Conv2d(mid, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _relu6(self.conv_pw(x)) if self.expand > 1 else x
        y = _relu6(self.conv_dw(y))
        y = self.conv_pwl(y) if self.expand > 1 else self.conv_pw(y)
        return y + x if self.residual else y


class MidasNetSmall(nn.Module):
    """MiDaS v2.1-small: EfficientNet-lite3 (stem ``pretrained.layer1.0``,
    features after stages 1, 2, 4 and 6), the expanding scratch (64, 128,
    256, 512), the custom fusion, a head whose upsample leaves the corners
    free."""

    def __init__(self, features: int = 64, non_negative: bool = True):
        super().__init__()
        self.pretrained = nn.Module()
        for name in ("layer1", "layer2", "layer3", "layer4"):
            setattr(self.pretrained, name, nn.ModuleDict())
        self.pretrained.layer1["0"] = SameConv2d(3, 32, 3, stride=2)
        cin, chs = 32, []
        for si, (reps, out_ch, k, s, e) in enumerate(LITE3_STAGES):
            layer, slot = LITE3_SLOTS[si].split(".")
            getattr(self.pretrained, layer)[slot] = nn.ModuleList(
                MBConvLite(cin if bi == 0 else out_ch, out_ch, k, s if bi == 0 else 1, e) for bi in range(reps))
            cin = out_ch
            if si in (1, 2, 4, 6):
                chs.append(out_ch)
        fs = (features, 2 * features, 4 * features, 8 * features)
        fusion = [FeatureFusionBlock(fs[0], skip=True)] + [
            FeatureFusionBlock(fs[ri], skip=ri < 3, out_features=fs[ri - 1]) for ri in (1, 2, 3)]
        self.scratch = _scratch(chs, fs, Head(features, features // 2, False, non_negative), fusion)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _relu6(self.pretrained.layer1["0"](x.permute(0, 3, 1, 2)))
        feats = []
        for si, slot in enumerate(LITE3_SLOTS):
            layer, idx = slot.split(".")
            for blk in getattr(self.pretrained, layer)[idx]:
                x = blk(x)
            if si in (1, 2, 4, 6):
                feats.append(x)
        return _decode(self.scratch, feats)


# --------------------------------------------------------- MiDaSInference ---

_NORM = {  # the per-model input normalisation of [0, 1] RGB
    "dpt": ([0.5, 0.5, 0.5], [0.5, 0.5, 0.5]),
    "midas_v21": ([0.485, 0.456, 0.406], [0.229, 0.224, 0.225]),
}
DPT_TYPES = {"dpt_large": "vitl16_384", "dpt_hybrid": "vitb_rn50_384", "dpt_vitb16": "vitb16_384"}


def build_dpt(model_type: str = "dpt_hybrid") -> DPTDepthModel:
    return DPTDepthModel(VARIANTS[DPT_TYPES[model_type]])


def build_midas(model_type: str = "dpt_hybrid") -> nn.Module:
    """dpt_large | dpt_hybrid | dpt_vitb16 | midas_v21 | midas_v21_small, at
    their published widths, on the current default device."""
    if model_type in DPT_TYPES:
        return build_dpt(model_type)
    if model_type == "midas_v21":
        return MidasNet()
    if model_type == "midas_v21_small":
        return MidasNetSmall()
    raise ValueError(f"unknown MiDaS model_type: {model_type}")


def midas_transform_size(h: int, w: int, net: int = 384, multiple_of: int = 32,
                         method: str = "minimal") -> Tuple[int, int]:
    """MiDaS ``Resize.get_size`` with the aspect ratio kept."""
    sh, sw = net / h, net / w
    if method == "minimal":
        s = sw if abs(1 - sw) < abs(1 - sh) else sh
    elif method == "lower_bound":
        s = max(sh, sw)
    elif method == "upper_bound":
        s = min(sh, sw)
    else:
        raise ValueError(method)

    def constrain(x, lo=None, hi=None):
        y = int(round(x / multiple_of) * multiple_of)
        if hi is not None and y > hi:
            y = int(np.floor(x / multiple_of) * multiple_of)
        if lo is not None and y < lo:
            y = int(np.ceil(x / multiple_of) * multiple_of)
        return y

    lo = net if method == "lower_bound" else None
    hi = net if method == "upper_bound" else None
    return constrain(s * h, lo, hi), constrain(s * w, lo, hi)


class MiDaSInference:
    """A model (weights inside) -> (B, H, W, 1) inverse depth of a [0, 1]
    NHWC batch at its own size."""

    def __init__(self, model: nn.Module, model_type: str = "dpt_hybrid", net_size: Optional[int] = None):
        self.model = model.eval().requires_grad_(False)
        mean, std = _NORM["midas_v21" if model_type.startswith("midas") else "dpt"]
        p = next(model.parameters())
        self._mean = torch.tensor(mean, dtype=p.dtype, device=p.device)
        self._std = torch.tensor(std, dtype=p.dtype, device=p.device)
        self.net_size = net_size or (256 if model_type == "midas_v21_small" else 384)
        self.method = "upper_bound" if model_type.startswith("midas") else "minimal"

    @torch.no_grad()
    def __call__(self, x01: torch.Tensor) -> torch.Tensor:
        from instarevive_tpu_torch.ops.resize import interpolate

        h, w = x01.shape[1:3]
        y = interpolate(x01, midas_transform_size(h, w, self.net_size, method=self.method), mode="bicubic")
        depth = self.model((y - self._mean) / self._std)
        return interpolate(depth[..., None], (h, w), mode="bicubic")

    def depth_fn(self):
        """For ``depth2image_loss(depth_fn=...)``: HQ in [-1, 1] -> (B, H, W, 1)
        depth, no gradient (a frozen estimator)."""
        return lambda hq: self((hq + 1.0) * 0.5)


# ------------------------------------------------- official checkpoints ---


def _fold_ws(w: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """timm StdConv2dSame's runtime standardisation (biased variance over
    (I, kH, kW)) folded into the weight."""
    w = w.astype(np.float64)
    m, v = w.mean(axis=(1, 2, 3), keepdims=True), w.var(axis=(1, 2, 3), keepdims=True)
    return ((w - m) / np.sqrt(v + eps)).astype(np.float32)


def _fold_bn(sd, conv: str, bn: str, eps: float) -> Tuple[np.ndarray, np.ndarray]:
    """An eval-mode BatchNorm folded into the bias-free convolution before it."""
    w = _np(sd[conv + ".weight"]).astype(np.float64)
    g, b, m, v = (_np(sd[f"{bn}.{k}"]).astype(np.float64) for k in ("weight", "bias", "running_mean", "running_var"))
    s = g / np.sqrt(v + eps)
    return (w * s[:, None, None, None]).astype(np.float32), (b - m * s).astype(np.float32)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


_WS_CONV = re.compile(r"\.patch_embed\.backbone\..*\.conv\d?\.weight$")  # the hybrid's StdConv2dSame weights


def encoder_bn(model: nn.Module, conv: str) -> Optional[str]:
    """The official BatchNorm after a v2.1 encoder convolution, or None."""
    if not conv.startswith("pretrained.") or isinstance(model, DPTDepthModel):
        return None
    if conv == "pretrained.layer1.0":
        return "pretrained.layer1.1"
    head, leaf = conv.rsplit(".", 1)
    if head.endswith(".downsample"):
        return head + ".1"
    if isinstance(model, MidasNet):
        return f"{head}.bn{leaf[-1]}"
    depthwise_separable = head.startswith("pretrained.layer1.3.")
    order = ("conv_dw", "conv_pw") if depthwise_separable else ("conv_pw", "conv_dw", "conv_pwl")
    return f"{head}.bn{order.index(leaf) + 1}"


def official_state_dict(model: nn.Module, sd: Mapping) -> Dict[str, np.ndarray]:
    """An official MiDaS/DPT state dict in ``model``'s keys: the hybrid's
    standardised convolutions and the v2.1 encoders' BatchNorms (eps 1e-5;
    1e-3 for EfficientNet's) folded; the keys the model holds taken (a
    missing one raises) and the rest left, as the JAX importers leave them."""
    sd = strip_prefixes(sd)
    eps = 1e-3 if isinstance(model, MidasNetSmall) else 1e-5
    out: Dict[str, np.ndarray] = {}
    for key in model.state_dict():
        conv, leaf = key.rsplit(".", 1)
        bn = encoder_bn(model, conv)
        if bn is not None:
            w, b = _fold_bn(sd, conv, bn, eps)
            out[key] = w if leaf == "weight" else b
        elif key not in sd:
            raise KeyError(f"MiDaS checkpoint: missing key {key!r}")
        elif _WS_CONV.search(key):
            out[key] = _fold_ws(_np(sd[key]))
        else:
            out[key] = _np(sd[key])
    return out


def load_official(model: nn.Module, sd: Mapping) -> nn.Module:
    """``model`` with the weights of an official state dict (``official_state_dict``)."""
    state = official_state_dict(model, sd)
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()})
    return model
