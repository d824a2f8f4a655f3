"""OpenAI CLIP RN50, the image and text towers of pyiqa's ``clipiqa``
backbone: ``instarevive_tpu/models/clip_rn50.py`` in PyTorch.

The image tower is CLIP's ModifiedResNet: a 3-conv stem and a 2x2 average
pool, four bottleneck stages whose stride-2 blocks downsample by an average
pool after the 3x3 conv (and before the shortcut's 1x1), and an attention
pool (the mean token prepended, a learned position embedding, one attention
step from the mean token, projected to the joint width). The text tower is
CLIP's transformer: QuickGELU MLPs, a causal mask, the final LayerNorm taken
at the EOT token (the argmax of the ids) and projected.

Parameter names are those of the OpenAI ``RN50`` state dict, as
``state_dict_from_torch`` reads it; each convolution holds its BatchNorm
folded in (weight and bias), as the JAX package's import does, so inference
only. ``clip_meta`` infers the widths from the keys; ``load_openai_clip``
reads a ``.pt``/``.pth`` file (a plain state dict or the TorchScript
archive). ``convert/from_jax.clip_rn50_params_to_torch`` maps the JAX
package's two param trees. Plain torch ops.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from instarevive_tpu_torch.convert.checkpoint_layouts import TakeKeys, strip_prefixes
from instarevive_tpu_torch.nn.layers import load_built


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2)


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv1, self.conv2, self.conv3 = _conv(inplanes, planes, 1), _conv(planes, planes, 3), _conv(planes, 4 * planes, 1)
        self.downsample = _conv(inplanes, 4 * planes, 1) if stride > 1 or inplanes != 4 * planes else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.conv2(F.relu(self.conv1(x))))
        if self.stride > 1:
            y, x = F.avg_pool2d(y, self.stride), F.avg_pool2d(x, self.stride)
        y = self.conv3(y)
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class AttentionPool(nn.Module):
    def __init__(self, spatial: int, width: int, heads: int, output_dim: int):
        super().__init__()
        self.heads = heads
        self.positional_embedding = nn.Parameter(torch.zeros(spatial * spatial + 1, width))
        self.q_proj, self.k_proj, self.v_proj = (nn.Linear(width, width) for _ in range(3))
        self.c_proj = nn.Linear(width, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, _, _ = x.shape
        t = x.flatten(2).transpose(1, 2)
        t = torch.cat([t.mean(1, keepdim=True), t], 1) + self.positional_embedding
        hd = c // self.heads
        q = self.q_proj(t[:, :1]).view(b, 1, self.heads, hd).transpose(1, 2)
        k, v = (f(t).view(b, -1, self.heads, hd).transpose(1, 2) for f in (self.k_proj, self.v_proj))
        a = (q @ k.transpose(-1, -2) / np.sqrt(hd)).softmax(-1)
        return self.c_proj((a @ v).transpose(1, 2).reshape(b, 1, c))[:, 0]


class ModifiedResNet(nn.Module):
    """RN50: layers (3, 4, 6, 3), width 64, 32 heads, output 1024, 224 input."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), output_dim: int = 1024, heads: int = 32,
                 width: int = 64, image_size: int = 224):
        super().__init__()
        self.conv1 = _conv(3, width // 2, 3, stride=2)
        self.conv2, self.conv3 = _conv(width // 2, width // 2, 3), _conv(width // 2, width, 3)
        inplanes = width
        for si, depth in enumerate(layers):
            planes = width * 2**si
            blocks = []
            for bi in range(depth):
                blocks.append(Bottleneck(inplanes, planes, 2 if si > 0 and bi == 0 else 1))
                inplanes = 4 * planes
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))
        self.attnpool = AttentionPool(image_size // 32, 32 * width, heads, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in (self.conv1, self.conv2, self.conv3):
            x = F.relu(conv(x))
        x = F.avg_pool2d(x, 2)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.attnpool(x)


class _TextAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).view(b, t, 3, self.heads, -1).permute(2, 0, 3, 1, 4)
        a = (q @ k.transpose(-1, -2) / np.sqrt(c // self.heads) + mask).softmax(-1)
        return self.out_proj((a @ v).transpose(1, 2).reshape(b, t, c))


class _TextBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1, self.ln_2 = nn.LayerNorm(width, eps=1e-5), nn.LayerNorm(width, eps=1e-5)
        self.attn = _TextAttention(width, heads)
        self.mlp = nn.Module()
        self.mlp.c_fc, self.mlp.c_proj = nn.Linear(width, 4 * width), nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), mask)
        h = self.mlp.c_fc(self.ln_2(x))
        return x + self.mlp.c_proj(h * torch.sigmoid(1.702 * h))


class CLIP(nn.Module):
    """Both towers and the logit scale, with the surface
    ``utils/clipiqa.CLIPIQA`` reads (``get_image_features``,
    ``get_text_features``, ``logit_scale``, ``image_size``). The defaults are
    the OpenAI RN50 checkpoint's."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), embed_dim: int = 1024, vision_width: int = 64,
                 vision_heads: int = 32, image_size: int = 224, text_width: int = 512, text_layers: int = 12,
                 text_heads: int = 8, vocab_size: int = 49408, context_length: int = 77):
        super().__init__()
        self.image_size = image_size
        self.visual = ModifiedResNet(layers, embed_dim, vision_heads, vision_width, image_size)
        self.token_embedding = nn.Embedding(vocab_size, text_width)
        self.positional_embedding = nn.Parameter(torch.zeros(context_length, text_width))
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(_TextBlock(text_width, text_heads) for _ in range(text_layers))
        self.ln_final = nn.LayerNorm(text_width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.zeros(text_width, embed_dim))
        self.logit_scale = nn.Parameter(torch.zeros(()))

    def get_image_features(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) CLIP-normalised -> (B, embed_dim)."""
        return self.visual(pixel_values.to(self.text_projection.device, self.text_projection.dtype))

    def get_text_features(self, input_ids, attention_mask=None) -> torch.Tensor:
        """(B, T) ids -> (B, embed_dim). ``attention_mask`` is accepted and
        not read: the causal mask and the pooling at the first argmax (EOT,
        the largest id) make right padding inert."""
        ids = torch.as_tensor(input_ids if isinstance(input_ids, torch.Tensor) else np.asarray(input_ids),
                              dtype=torch.long, device=self.text_projection.device)
        b, t = ids.shape
        x = self.token_embedding(ids) + self.positional_embedding[:t]
        mask = torch.full((t, t), float("-inf"), device=ids.device).triu(1)
        for blk in self.transformer.resblocks:
            x = blk(x, mask)
        x = self.ln_final(x)
        return x[torch.arange(b, device=ids.device), ids.argmax(-1)] @ self.text_projection


def clip_meta(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """``CLIP``'s constructor arguments from an OpenAI state dict's shapes,
    as openai's ``build_model`` (and the JAX importer) infer them."""
    sd = strip_prefixes(sd)
    shape = {k: tuple(np.shape(v)) for k, v in sd.items()}
    text_width = shape["ln_final.weight"][0]
    vision_width = 2 * shape["visual.conv1.weight"][0]
    return {
        "layers": tuple(1 + max(int(k.split(".")[2]) for k in sd if k.startswith(f"visual.layer{i}."))
                        for i in (1, 2, 3, 4)),
        "embed_dim": shape["text_projection"][1],
        "vision_width": vision_width,
        "vision_heads": vision_width * 32 // 64,
        "image_size": round((shape["visual.attnpool.positional_embedding"][0] - 1) ** 0.5) * 32,
        "text_width": text_width,
        "text_layers": 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("transformer.resblocks.")),
        "text_heads": text_width // 64,
        "vocab_size": shape["token_embedding.weight"][0],
        "context_length": shape["positional_embedding"][0],
    }


def _fold(src: TakeKeys, conv: str, bn: str, eps: float = 1e-5):
    """An eval-mode BatchNorm folded into the bias-free conv before it, in
    float64: w * g / sqrt(v + eps), b - m * g / sqrt(v + eps)."""
    w = torch.as_tensor(src.take(f"{conv}.weight")).double()
    g, b, m, v = (torch.as_tensor(src.take(f"{bn}.{leaf}")).double()
                  for leaf in ("weight", "bias", "running_mean", "running_var"))
    s = g / torch.sqrt(v + eps)
    return (w * s[:, None, None, None]).float(), (b - m * s).float()


def state_dict_from_torch(sd: Mapping) -> Dict[str, torch.Tensor]:
    """``CLIP(**clip_meta(sd))``'s state dict from an OpenAI RN50 state dict:
    every BatchNorm folded into its conv (a bottleneck's ``downsample.0`` /
    ``downsample.1`` into ``downsample``), every other tensor as it is. Raises
    on a missing key or one not used (the archive's ``input_resolution``,
    ``context_length`` and ``vocab_size`` and BatchNorm counters aside)."""
    src = TakeKeys(sd, "CLIP RN50")
    out = {}
    with torch.device("meta"):  # names and shapes only
        layout = CLIP(**clip_meta(sd)).state_dict()
    for key, ref in layout.items():
        mod = key.rsplit(".", 1)[0]
        if key.startswith("visual.") and ref.ndim == 4:  # conv{i} + bn{i}; downsample: .0 + .1
            conv, bn = (f"{mod}.0", f"{mod}.1") if mod.endswith("downsample") else (mod, mod.replace("conv", "bn"))
            out[key], out[f"{mod}.bias"] = _fold(src, conv, bn)
        elif key not in out:
            out[key] = torch.as_tensor(src.take(key)).float()
    src.done(ignore=("input_resolution", "context_length", "vocab_size", "num_batches_tracked"))
    return out


def load_openai_clip(path: str, device="cuda") -> CLIP:
    """An OpenAI CLIP RN50 checkpoint (``.pt``/``.pth``: a plain state dict,
    or the TorchScript archive, whose state dict is read) on ``device``."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except (RuntimeError, pickle.UnpicklingError):  # the TorchScript archive is not a plain pickle
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return from_state_dict(state_dict_from_torch(sd), device, clip_meta(sd))


def from_state_dict(sd: Mapping[str, Any], device="cuda", meta: Optional[Mapping[str, Any]] = None) -> CLIP:
    """``CLIP(**meta)`` with the weights of ``sd`` (the port's layout), in
    eval mode on ``device``; ``meta`` defaults to the RN50 widths."""
    return load_built(lambda: CLIP(**(meta or {})), sd, device)
