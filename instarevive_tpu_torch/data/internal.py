"""Precomputed-feature datasets (``instarevive_tpu/data/internal.py``: PixArt
'internal data' + DMD pairs), the port's own copy, numpy only.

Parity targets: reference ``diffusion/data/datasets/InternalData.py:16-312``
(json-manifest loaders of image + precomputed T5 feature + VAE latent) and
``diffusion/data/datasets/dmd.py:20-177`` (DMD quadruples: original image,
generated image, paired noise .npy, VAE latent .npy, T5 feature — the
regression pairs for distillation).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
from PIL import Image


def _load_npz(path: str, key: Optional[str] = None) -> np.ndarray:
    arr = np.load(path)
    if hasattr(arr, "files"):
        arr = arr[key or arr.files[0]]
    return np.asarray(arr)


class InternalFeatureDataset:
    """Images + precomputed VAE latents / T5 features, json-manifest driven.

    Manifest entries: {"path": ..., "vae_feat": ..., "t5_feat": ...,
    "ratio": h/w} (the reference's data_info.json layout).
    """

    def __init__(self, manifest: str, root: str = "", load_image: bool = False):
        with open(manifest) as f:
            self.items: List[Dict] = json.load(f)
        self.root = root
        self.load_image = load_image

    def __len__(self):
        return len(self.items)

    @property
    def ratios(self) -> List[float]:
        return [float(it.get("ratio", 1.0)) for it in self.items]

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        it = self.items[idx]
        out: Dict[str, np.ndarray] = {}
        if "vae_feat" in it:
            out["latent"] = _load_npz(os.path.join(self.root, it["vae_feat"]), "latent")
        if "t5_feat" in it:
            f = np.load(os.path.join(self.root, it["t5_feat"]))
            out["txt_fea"] = np.asarray(f["caption_feature"])
            if "attention_mask" in getattr(f, "files", []):
                out["attention_mask"] = np.asarray(f["attention_mask"])
        if self.load_image and "path" in it:
            out["image"] = np.asarray(Image.open(os.path.join(self.root, it["path"])).convert("RGB"))
        return out


class DMDPairDataset:
    """DMD distillation quadruples (dmd.py:56-95): per-sample paired
    (noise.npy, latent.npy[, t5 feature]) laid out in sibling dirs."""

    def __init__(self, noise_dir: str, latent_dir: str, t5_dir: Optional[str] = None):
        names = sorted(
            os.path.splitext(f)[0] for f in os.listdir(noise_dir) if f.endswith((".npy", ".npz"))
        )
        self.names = [
            n for n in names
            if os.path.exists(os.path.join(latent_dir, n + ".npy"))
            or os.path.exists(os.path.join(latent_dir, n + ".npz"))
        ]
        self.noise_dir, self.latent_dir, self.t5_dir = noise_dir, latent_dir, t5_dir

    def __len__(self):
        return len(self.names)

    def _load(self, d: str, n: str) -> np.ndarray:
        for ext in (".npy", ".npz"):
            p = os.path.join(d, n + ext)
            if os.path.exists(p):
                return np.load(p) if ext == ".npy" else _load_npz(p)
        raise FileNotFoundError(f"{n} in {d}")

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        n = self.names[idx]
        out = {"noise": self._load(self.noise_dir, n), "latent": self._load(self.latent_dir, n)}
        if self.t5_dir:
            f = np.load(os.path.join(self.t5_dir, n + ".npz"))
            out["txt_fea"] = np.asarray(f["caption_feature"])
        return out
