"""MUSIQ, the multi-scale image quality transformer (Ke et al., ICCV 2021):
``instarevive_tpu/utils/musiq.py`` in PyTorch.

The image is taken at its native size and resized (``area``) so its longer
side is 384 and 224; each scale is cut into 32x32 patches (``musiq_prepare``,
on the host, up to 512 a scale, padded and masked). Every patch goes through
a ResNet root (weight-standardised 7x7/2 conv, GroupNorm, ReLU, 3x3/2
max-pool, one bottleneck unit 64 -> 256) and a linear embedding; a hash-based
spatial embedding on a 10x10 grid and a per-scale embedding are added, a CLS
token is prepended, and one 14-layer transformer over all patches of all
scales (masked softmax) scores the image from the CLS token.

Parameter names are those of the pyiqa torch port (BiT root, ViT-pytorch
encoder), as ``state_dict_from_torch`` reads them; the convolutions hold
their standardised weights, as the JAX package's do. ``params_from_npz``
reads the JAX package's own ``.npz`` (what ``--musiq_params`` takes) and
``convert/from_jax.musiq_params_to_torch`` maps it. Plain torch ops.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from instarevive_tpu_torch.convert.checkpoint_layouts import TakeKeys
from instarevive_tpu_torch.nn.layers import load_built
from instarevive_tpu_torch.ops.resize import interpolate

_P = 32  # patch size
_D = 384  # transformer width
_LAYERS = 14
_HEADS = 6
_MLP = 1152
_GRID = 10  # hash-based spatial grid
_SCALES = (0, 384, 224)  # 0 = native resolution
_MAX_SEQ = 512  # patches a scale
_ROOT_W = 64  # ResNet-root width
_ROOT_OUT = 256  # bottleneck output channels
_ROOT_HW = _P // 4  # patch side after the root (stride-2 conv + pool)


def _patchify(img: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """An HWC image cut into P x P patches (zero-padded to multiples of P):
    (patches (N, P*P*3), row index, column index, rows, columns)."""
    h, w, c = img.shape
    ph, pw = -(-h // _P), -(-w // _P)
    img = np.pad(img, ((0, ph * _P - h), (0, pw * _P - w), (0, 0)))
    x = img.reshape(ph, _P, pw, _P, c).transpose(0, 2, 1, 3, 4).reshape(ph * pw, -1)
    return x, np.repeat(np.arange(ph), pw), np.tile(np.arange(pw), ph), ph, pw


def _resize_longer(img: np.ndarray, longer: int) -> np.ndarray:
    """Aspect-kept ``area`` resize to a longer side of ``longer`` (each side at
    least one patch)."""
    h, w = img.shape[:2]
    s = longer / max(h, w)
    nh, nw = max(int(round(h * s)), _P), max(int(round(w * s)), _P)
    return interpolate(torch.from_numpy(img)[None], (nh, nw), mode="area")[0].numpy()


def musiq_prepare(img01: np.ndarray):
    """The patch sequences of one HWC [0, 1] image over the three scales:
    (patches (1536, 3072) f32, spatial hash (1536,) int32, scale ids (1536,)
    int32, mask (1536,) bool); the CLS slot is added by the network."""
    seqs, hashes, scales, masks = [], [], [], []
    for si, longer in enumerate(_SCALES):
        im = img01 if longer == 0 else _resize_longer(img01, longer)
        x, rows, cols, ph, pw = _patchify(im.astype(np.float32))
        gr = np.minimum((rows * _GRID) // max(ph, 1), _GRID - 1)
        gc = np.minimum((cols * _GRID) // max(pw, 1), _GRID - 1)
        hidx = gr * _GRID + gc
        n = min(len(x), _MAX_SEQ)
        pad = _MAX_SEQ - n
        seqs.append(np.pad(x[:n], ((0, pad), (0, 0))))
        hashes.append(np.pad(hidx[:n], (0, pad)))
        scales.append(np.full(_MAX_SEQ, si, np.int32))
        masks.append(np.arange(_MAX_SEQ) < n)
    return (np.concatenate(seqs, 0), np.concatenate(hashes, 0).astype(np.int32), np.concatenate(scales, 0),
            np.concatenate(masks, 0))


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    """Symmetric k // 2 padding, as the torch port pads (XLA's SAME would pad
    the 7x7/2 root (2, 3) on even sizes)."""
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class _Unit(nn.Module):
    """The root's one pre-activation bottleneck, 64 -> 256."""

    def __init__(self):
        super().__init__()
        self.conv1, self.conv2 = _conv(_ROOT_W, _ROOT_W, 1), _conv(_ROOT_W, _ROOT_W, 3)
        self.conv3, self.downsample = _conv(_ROOT_W, _ROOT_OUT, 1), _conv(_ROOT_W, _ROOT_OUT, 1)
        self.gn1, self.gn2 = nn.GroupNorm(32, _ROOT_W, eps=1e-6), nn.GroupNorm(32, _ROOT_W, eps=1e-6)
        self.gn3 = nn.GroupNorm(32, _ROOT_OUT, eps=1e-6)
        self.gn_proj = nn.GroupNorm(_ROOT_OUT, _ROOT_OUT, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = self.gn_proj(self.downsample(x))
        y = F.relu(self.gn1(self.conv1(x)))
        y = F.relu(self.gn2(self.conv2(y)))
        return F.relu(res + self.gn3(self.conv3(y)))


class _Attention(nn.Module):
    def __init__(self):
        super().__init__()
        self.query, self.key, self.value, self.out = (nn.Linear(_D, _D) for _ in range(4))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        q, k, v = (f(x).view(b, n, _HEADS, -1).transpose(1, 2) for f in (self.query, self.key, self.value))
        s = (q @ k.transpose(-1, -2)) * (_D // _HEADS) ** -0.5
        a = s.masked_fill(~mask[:, None, None, :], -1e30).softmax(-1)
        return self.out((a @ v).transpose(1, 2).reshape(b, n, _D))


class _Layer(nn.Module):
    def __init__(self):
        super().__init__()
        self.attention_norm, self.ffn_norm = nn.LayerNorm(_D, eps=1e-6), nn.LayerNorm(_D, eps=1e-6)
        self.attn = _Attention()
        self.ffn = nn.Module()
        self.ffn.fc1, self.ffn.fc2 = nn.Linear(_D, _MLP), nn.Linear(_MLP, _D)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.attention_norm(x), mask)
        return x + self.ffn.fc2(F.gelu(self.ffn.fc1(self.ffn_norm(x))))


class MUSIQ(nn.Module):
    """The network: ``forward`` on prepared sequences, ``score`` on images.
    ``head_out`` 10 is the AVA variant, whose distribution head reduces to
    its mean score."""

    def __init__(self, head_out: int = 1):
        super().__init__()
        self.conv_root = _conv(3, _ROOT_W, 7, stride=2)
        self.gn_root = nn.GroupNorm(32, _ROOT_W, eps=1e-6)
        self.block1 = nn.ModuleDict({"unit1": _Unit()})
        self.embedding = nn.Linear(_ROOT_OUT * _ROOT_HW * _ROOT_HW, _D)
        enc = self.transformer_encoder = nn.Module()
        enc.cls_token = nn.Parameter(torch.zeros(1, 1, _D))
        enc.pos_emb = nn.Parameter(torch.zeros(1, _GRID * _GRID, _D))
        enc.scale_emb = nn.Parameter(torch.zeros(len(_SCALES), _D))
        enc.layers = nn.ModuleList(_Layer() for _ in range(_LAYERS))
        enc.encoder_norm = nn.LayerNorm(_D, eps=1e-6)
        self.head = nn.Linear(_D, head_out)

    def forward(self, patches: torch.Tensor, hash_idx: torch.Tensor, scale_ids: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        """patches (B, N, P*P*3), hash_idx and scale_ids (B, N) int, mask (B,
        N) bool -> (B,) scores."""
        b, n, _ = patches.shape
        x = patches.reshape(b * n, _P, _P, 3).permute(0, 3, 1, 2)
        x = F.relu(self.gn_root(self.conv_root(x)))
        x = self.block1["unit1"](F.max_pool2d(x, 3, 2, padding=1))  # (B*N, 256, 8, 8)
        enc = self.transformer_encoder
        x = self.embedding(x.reshape(b, n, -1))
        x = x + enc.pos_emb[0][hash_idx.long()] + enc.scale_emb[scale_ids.long()]
        x = torch.cat([enc.cls_token.expand(b, 1, _D), x], 1)
        mask = torch.cat([torch.ones(b, 1, dtype=torch.bool, device=mask.device), mask], 1)
        for layer in enc.layers:
            x = layer(x, mask)
        out = self.head(enc.encoder_norm(x)[:, 0])
        if out.shape[-1] > 1:  # the AVA distribution head -> its mean score
            bins = torch.arange(1, out.shape[-1] + 1, dtype=out.dtype, device=out.device)
            return (out.softmax(-1) * bins).sum(-1)
        return out[:, 0]

    @classmethod
    def from_state_dict(cls, sd: Mapping[str, torch.Tensor], device="cuda") -> "MUSIQ":
        """The network with the weights of ``sd`` (its head's width from them)
        on ``device``, in eval mode."""
        return load_built(lambda: cls(head_out=int(np.shape(sd["head.bias"])[0])), sd, device)

    @torch.no_grad()
    def score(self, img01: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) or (H, W, 3) [0, 1] images -> (B,) scores; the patches
        are cut on the host, the network runs on its own device."""
        img01 = np.asarray(img01, np.float32)
        if img01.ndim == 3:
            img01 = img01[None]
        dev = self.head.weight.device
        prepped = [musiq_prepare(im) for im in img01]
        args = (torch.from_numpy(np.stack([q[i] for q in prepped])).to(dev) for i in range(4))
        return self(*args).cpu().numpy()


def params_from_npz(path: str) -> Dict[str, np.ndarray]:
    """The JAX package's own MUSIQ checkpoint (a flat ``.npz`` of its
    parameter names, as its ``save_params_npz`` writes); map it with
    ``convert/from_jax.musiq_params_to_torch``."""
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _std_conv_weight(w: torch.Tensor) -> torch.Tensor:
    """BiT weight standardisation folded into an OIHW kernel: zero mean and
    unit variance over (in, kh, kw) for each output channel."""
    w = w.float()
    mu = w.mean(dim=(1, 2, 3), keepdim=True)
    var = w.var(dim=(1, 2, 3), keepdim=True, unbiased=False)
    return (w - mu) / torch.sqrt(var + 1e-10)


def state_dict_from_torch(sd: Mapping) -> Dict[str, torch.Tensor]:
    """``MUSIQ``'s state dict from a pyiqa-layout torch checkpoint: the
    convolutions standardised, the CLS token, spatial and scale embeddings
    cut to (1, 1, D), (1, 100, D) and (3, D) as the JAX importer reads them.
    Raises on a missing key or one not used (``num_batches_tracked`` aside)."""
    src = TakeKeys(sd, "MUSIQ")
    out = {}
    with torch.device("meta"):  # names and shapes only
        layout = MUSIQ(head_out=1).state_dict()
    for key, ref in layout.items():
        if key.startswith("transformer_encoder.") and key.count(".") == 1:
            rows = ref.reshape(-1, _D).shape[0]
            out[key] = torch.as_tensor(src.take(key)).float().reshape(-1, _D)[:rows].reshape(ref.shape)
        elif ref.ndim == 4:
            out[key] = _std_conv_weight(torch.as_tensor(src.take(key)))
        else:
            out[key] = torch.as_tensor(src.take(key)).float()
    src.done(ignore=("num_batches_tracked",))
    return out
