"""CLIP text encoders for the LDM stack's conditioning, the PyTorch port of
``instarevive_tpu/models/clip.py``.

``FrozenCLIPEmbedder`` runs ``transformers.CLIPTextModel`` (the torch class
of the ``FlaxCLIPTextModel`` the JAX wrapper loads) in float32 and takes the
last hidden state or, with ``layer='penultimate'``, the one before it (the
OpenCLIP convention of ``configs/cldm.yaml``'s ``cond_stage``).
``build_cond_stage`` reads that block; ``ClassEmbedder`` draws its table
from the same numpy seed as the JAX one, so the two are identical.
"""

from __future__ import annotations

from typing import List

import numpy as np

from instarevive_tpu_torch.models.t5 import resolve_device

LAYERS = ("last", "penultimate")


class FrozenCLIPEmbedder:
    """CLIP text encoder from a Hugging Face directory (or a model and a
    tokenizer handed in), loaded on first use onto ``device``."""

    def __init__(self, model_dir: str = None, max_length: int = 77, layer: str = "penultimate", device="cuda",
                 model=None, tokenizer=None):
        if layer not in LAYERS:
            raise ValueError(f"unknown CLIP layer {layer!r}; one of {LAYERS}")
        if (model is None) != (tokenizer is None) or (model is None and model_dir is None):
            raise ValueError("FrozenCLIPEmbedder needs model_dir, or both a model and a tokenizer")
        self.model_dir = model_dir
        self.max_length = max_length
        self.layer = layer
        self.device = resolve_device(device)
        self._model = model
        self._tokenizer = tokenizer

    def _load(self):
        if self._model is None:
            import torch
            from transformers import AutoTokenizer, CLIPTextModel

            self._tokenizer = AutoTokenizer.from_pretrained(self.model_dir)
            model = CLIPTextModel.from_pretrained(self.model_dir, dtype=torch.float32)
            self._model = model.to(self.device).eval().requires_grad_(False)

    def encode_tensor(self, texts: List[str]):
        """(B, max_length, width) float32 on the model's device."""
        import torch

        self._load()
        tok = self._tokenizer(texts, max_length=self.max_length, padding="max_length", truncation=True,
                              return_tensors="pt")
        with torch.inference_mode():
            out = self._model(input_ids=tok["input_ids"].to(self.device),
                              attention_mask=tok["attention_mask"].to(self.device), output_hidden_states=True)
        h = out.hidden_states[-2] if self.layer == "penultimate" else out.last_hidden_state
        return h.float()

    def encode(self, texts: List[str]) -> np.ndarray:
        return self.encode_tensor(texts).cpu().numpy()


def build_cond_stage(cfg: dict, device="cuda"):
    """The cldm conditioning encoder of a ``cond_stage`` config block, or
    None when it names no ``model_dir`` (callers then take precomputed
    features or a zero context)."""
    if not cfg or not cfg.get("model_dir"):
        return None
    kind = cfg.get("type", "clip")
    if kind not in ("clip", "open_clip"):
        raise ValueError(f"unknown cond_stage type {kind!r}")
    return FrozenCLIPEmbedder(
        model_dir=cfg["model_dir"],
        max_length=int(cfg.get("max_length", 77)),
        layer=cfg.get("layer", "penultimate"),
        device=device,
    )


class ClassEmbedder:
    """Class id -> embedding, the unconditional row at ``n_classes`` for the
    ids ``drop`` marks."""

    def __init__(self, embed_dim: int, n_classes: int = 1000, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.table = rng.normal(0, 0.02, (n_classes + 1, embed_dim)).astype(np.float32)
        self.n_classes = n_classes

    def __call__(self, class_ids: np.ndarray, drop: np.ndarray = None) -> np.ndarray:
        ids = np.asarray(class_ids)
        if drop is not None:
            ids = np.where(drop, self.n_classes, ids)
        return self.table[ids]
