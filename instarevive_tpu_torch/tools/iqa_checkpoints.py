"""Seeded state dicts in the official checkpoint layouts of the evaluation
networks, at their published widths unless asked otherwise, for the tests
and ``chip_smoke.py``: what ``torch.load`` gives for torchvision's AlexNet and
``lpips``'s ``alex.pth``, pyiqa's MUSIQ, the official MANIQA (with the timm
trunk's unused norm and head and the Swin buffers), OpenAI's CLIP RN50 (with
the archive's three integers and the BatchNorm counters) and
``Retinaface_mobilenet0.25.pth``. No file is read or downloaded. Also a stub
CLIP tokenizer for CLIP-IQA where ``transformers`` is absent.

Values: a weight of two or more dims N(0, 1/fan-in); 1-D weights (norms)
1 + N(0, 0.01); biases N(0, 0.01); BatchNorm running means N(0, 0.01) and
variances 1 + U(0, 0.1); embeddings and tokens N(0, 0.02^2); LPIPS's
``lin`` weights |N(0, 1/C)| (its distances are non-negative).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

Shapes = Dict[str, Tuple[int, ...]]


def seeded(shapes: Shapes, seed: int, std: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """A state dict of the given key -> shape, its values drawn in key order
    from ``torch.Generator().manual_seed(seed)`` by the rules above; ``std``
    replaces 1/fan-in for the weights of two or more dims."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for key, shape in shapes.items():
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            sd[key] = torch.tensor(0)
            continue
        n = torch.randn(shape, generator=gen)
        if leaf == "running_var":
            n = 1 + 0.1 * torch.rand(shape, generator=gen)
        elif leaf in ("running_mean", "bias") or leaf.endswith("_bias"):
            n = 0.1 * n
        elif leaf == "weight" and len(shape) == 1:
            n = 1 + 0.1 * n
        elif leaf.endswith("weight"):
            n = n * (std if std is not None else 1 / math.sqrt(int(np.prod(shape[1:]))))
        else:
            n = 0.02 * n
        sd[key] = n
    return sd


def _linear(shapes: Shapes, key: str, cin: int, cout: int) -> None:
    shapes[f"{key}.weight"], shapes[f"{key}.bias"] = (cout, cin), (cout,)


def _norm(shapes: Shapes, key: str, c: int) -> None:
    shapes[f"{key}.weight"], shapes[f"{key}.bias"] = (c,), (c,)


def _bn(shapes: Shapes, key: str, c: int) -> None:
    _norm(shapes, key, c)
    shapes[f"{key}.running_mean"], shapes[f"{key}.running_var"] = (c,), (c,)
    shapes[f"{key}.num_batches_tracked"] = ()


def lpips(seed: int = 0, classifier: bool = True) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(torchvision ``alexnet().state_dict()``, ``lpips`` ``alex.pth``)."""
    from instarevive_tpu_torch.utils.metrics import LPIPS

    alex: Shapes = {}
    for ci, (cin, cout, k, _, _) in zip(LPIPS.ALEXNET_IDS, LPIPS.CONVS):
        alex[f"features.{ci}.weight"], alex[f"features.{ci}.bias"] = (cout, cin, k, k), (cout,)
    if classifier:
        for i, (cin, cout) in zip((1, 4, 6), ((9216, 4096), (4096, 4096), (4096, 1000))):
            _linear(alex, f"classifier.{i}", cin, cout)
    lins = seeded({f"lin{i}.model.1.weight": (1, c[1], 1, 1) for i, c in enumerate(LPIPS.CONVS)}, seed + 1)
    return seeded(alex, seed), {k: v.abs() for k, v in lins.items()}


def musiq(seed: int = 0, head_out: int = 1) -> Dict[str, torch.Tensor]:
    """pyiqa's MUSIQ layout (BiT root, ViT-pytorch encoder) at its widths."""
    d, mlp = 384, 1152
    s: Shapes = {"transformer_encoder.cls_token": (1, 1, d), "transformer_encoder.pos_emb": (1, 100, d),
                 "transformer_encoder.scale_emb": (3, d), "conv_root.weight": (64, 3, 7, 7)}
    _norm(s, "gn_root", 64)
    u = "block1.unit1"
    for conv, shape in (("conv1", (64, 64, 1, 1)), ("conv2", (64, 64, 3, 3)), ("conv3", (256, 64, 1, 1)),
                        ("downsample", (256, 64, 1, 1))):
        s[f"{u}.{conv}.weight"] = shape
    for gn, c in (("gn1", 64), ("gn2", 64), ("gn3", 256), ("gn_proj", 256)):
        _norm(s, f"{u}.{gn}", c)
    _linear(s, "embedding", 256 * 8 * 8, d)
    for i in range(14):
        b = f"transformer_encoder.layers.{i}"
        _norm(s, f"{b}.attention_norm", d)
        for t in ("query", "key", "value", "out"):
            _linear(s, f"{b}.attn.{t}", d, d)
        _norm(s, f"{b}.ffn_norm", d)
        _linear(s, f"{b}.ffn.fc1", d, mlp)
        _linear(s, f"{b}.ffn.fc2", mlp, d)
    _norm(s, "transformer_encoder.encoder_norm", d)
    _linear(s, "head", d, head_out)
    return seeded(s, seed)


def maniqa(seed: int = 0) -> Dict[str, torch.Tensor]:
    """The official MANIQA checkpoint's layout (embed 768, depths [2, 2],
    4 heads, window 4, two TABs; timm ViT-B/8 trunk with its norm and head).
    Weights N(0, 0.02^2), the official initialisation (timm's): at 1/fan-in
    the channel attention's logits reach the thousands, and f32 rounding
    then decides the softmax's winner."""
    from instarevive_tpu_torch.ops import window as W

    d = 768
    s: Shapes = {"vit.cls_token": (1, 1, d), "vit.pos_embed": (1, 785, d), "vit.patch_embed.proj.weight": (d, 3, 8, 8),
                 "vit.patch_embed.proj.bias": (d,)}
    for i in range(12):
        b = f"vit.blocks.{i}"
        _norm(s, f"{b}.norm1", d)
        _linear(s, f"{b}.attn.qkv", d, 3 * d)
        _linear(s, f"{b}.attn.proj", d, d)
        _norm(s, f"{b}.norm2", d)
        _linear(s, f"{b}.mlp.fc1", d, 4 * d)
        _linear(s, f"{b}.mlp.fc2", 4 * d, d)
    _norm(s, "vit.norm", d)
    _linear(s, "vit.head", d, 1000)
    for t in range(2):
        for tab in ("tablock1", "tablock2"):
            for qkv in ("c_q", "c_k", "c_v"):
                _linear(s, f"{tab}.{t}.{qkv}", 784, 784)
    s["conv1.weight"], s["conv1.bias"] = (d, 4 * d, 1, 1), (d,)
    s["conv2.weight"], s["conv2.bias"] = (d // 2, d, 1, 1), (d // 2,)
    for swin, dim in (("swintransformer1", d), ("swintransformer2", d // 2)):
        for layer in range(2):
            for blk in range(2):
                b = f"{swin}.layers.{layer}.blocks.{blk}"
                _norm(s, f"{b}.norm1", dim)
                s[f"{b}.attn.relative_position_bias_table"] = (49, 4)
                _linear(s, f"{b}.attn.qkv", dim, 3 * dim)
                _linear(s, f"{b}.attn.proj", dim, dim)
                _norm(s, f"{b}.norm2", dim)
                _linear(s, f"{b}.mlp.fc1", dim, 768)
                _linear(s, f"{b}.mlp.fc2", 768, dim)
    for head in ("fc_score", "fc_weight"):
        _linear(s, f"{head}.0", d // 2, d // 2)
        _linear(s, f"{head}.3", d // 2, 1)
    sd = seeded(s, seed, std=0.02)
    for swin in ("swintransformer1", "swintransformer2"):  # the buffers a real checkpoint carries
        for layer in range(2):
            for blk in range(2):
                b = f"{swin}.layers.{layer}.blocks.{blk}"
                sd[f"{b}.attn.relative_position_index"] = torch.from_numpy(W.relative_position_index(4))
                if blk % 2:
                    sd[f"{b}.attn_mask"] = torch.from_numpy(W.shift_attn_mask(28, 28, 4, 2))
    return sd


def clip_rn50(seed: int = 0, layers: Sequence[int] = (3, 4, 6, 3), width: int = 64, embed_dim: int = 1024,
              image_size: int = 224, text_width: int = 512, text_layers: int = 12, vocab_size: int = 49408,
              context_length: int = 77) -> Dict[str, torch.Tensor]:
    """OpenAI's CLIP layout; the defaults are RN50's."""
    s: Shapes = {}
    for i, (cin, cout) in enumerate(((3, width // 2), (width // 2, width // 2), (width // 2, width)), 1):
        s[f"visual.conv{i}.weight"] = (cout, cin, 3, 3)
        _bn(s, f"visual.bn{i}", cout)
    inplanes = width
    for li, depth in enumerate(layers):
        planes = width * 2**li
        for bi in range(depth):
            b = f"visual.layer{li + 1}.{bi}"
            for i, (cin, cout, k) in enumerate(((inplanes, planes, 1), (planes, planes, 3), (planes, 4 * planes, 1)), 1):
                s[f"{b}.conv{i}.weight"] = (cout, cin, k, k)
                _bn(s, f"{b}.bn{i}", cout)
            if (li > 0 and bi == 0) or inplanes != 4 * planes:
                s[f"{b}.downsample.0.weight"] = (4 * planes, inplanes, 1, 1)
                _bn(s, f"{b}.downsample.1", 4 * planes)
            inplanes = 4 * planes
    w = 32 * width
    s["visual.attnpool.positional_embedding"] = ((image_size // 32) ** 2 + 1, w)
    for proj in ("q_proj", "k_proj", "v_proj"):
        _linear(s, f"visual.attnpool.{proj}", w, w)
    _linear(s, "visual.attnpool.c_proj", w, embed_dim)
    s["token_embedding.weight"] = (vocab_size, text_width)
    s["positional_embedding"] = (context_length, text_width)
    for i in range(text_layers):
        b = f"transformer.resblocks.{i}"
        s[f"{b}.attn.in_proj_weight"], s[f"{b}.attn.in_proj_bias"] = (3 * text_width, text_width), (3 * text_width,)
        _linear(s, f"{b}.attn.out_proj", text_width, text_width)
        _norm(s, f"{b}.ln_1", text_width)
        _linear(s, f"{b}.mlp.c_fc", text_width, 4 * text_width)
        _linear(s, f"{b}.mlp.c_proj", 4 * text_width, text_width)
        _norm(s, f"{b}.ln_2", text_width)
    _norm(s, "ln_final", text_width)
    s["text_projection"] = (text_width, embed_dim)
    sd = seeded(s, seed)
    sd["logit_scale"] = torch.tensor(math.log(100.0))
    sd.update(input_resolution=torch.tensor(image_size), context_length=torch.tensor(context_length),
              vocab_size=torch.tensor(vocab_size))
    return sd


class StubTokenizer:
    """CLIP-IQA's tokenizer without ``transformers`` and its vocabulary: the
    HF tokenizer's call surface, ids from the characters, then EOT (the
    largest id, ``vocab_size - 1``), zero padding to ``length``."""

    def __init__(self, vocab_size: int = 49408, length: int = 77):
        self.vocab_size, self.length = vocab_size, length

    def __call__(self, texts, padding=True, return_tensors="np"):
        ids = np.zeros((len(texts), self.length), np.int64)
        for i, t in enumerate(texts):
            codes = [1 + ord(c) % (self.vocab_size - 10) for c in t[: self.length - 2]]
            ids[i, :len(codes)] = codes
            ids[i, len(codes)] = self.vocab_size - 1
        return {"input_ids": ids, "attention_mask": (ids > 0).astype(np.int64)}


def retinaface(seed: int = 0) -> Dict[str, torch.Tensor]:
    """``Retinaface_mobilenet0.25.pth``'s layout (biubug6)."""
    from instarevive_tpu_torch.utils import retinaface as R

    s: Shapes = {}

    def conv_bn(key: str, cin: int, cout: int, k: int = 3, groups: int = 1, at: int = 0) -> None:
        s[f"{key}.{at}.weight"] = (cout, cin // groups, k, k)
        _bn(s, f"{key}.{at + 1}", cout)

    for stage, spec in (("stage1", R._STAGE1), ("stage2", R._STAGE2), ("stage3", R._STAGE3)):
        for i, (kind, cin, cout, _) in enumerate(spec):
            if kind == "conv":
                conv_bn(f"body.{stage}.{i}", cin, cout)
            else:
                conv_bn(f"body.{stage}.{i}", cin, cin, groups=cin)
                conv_bn(f"body.{stage}.{i}", cin, cout, 1, at=3)
    for name, cin in (("output1", 64), ("output2", 128), ("output3", 256)):
        conv_bn(f"fpn.{name}", cin, 64, 1)
    conv_bn("fpn.merge1", 64, 64)
    conv_bn("fpn.merge2", 64, 64)
    for ssh in ("ssh1", "ssh2", "ssh3"):
        for name, cin, cout in R._SSH:
            conv_bn(f"{ssh}.{name}", cin, cout)
    for head, ch in R._HEADS:
        for i in range(3):
            s[f"{head}.{i}.conv1x1.weight"], s[f"{head}.{i}.conv1x1.bias"] = (ch, 64, 1, 1), (ch,)
    return seeded(s, seed)
