"""CLIP-IQA, no-reference quality from CLIP antonym prompts (Wang et al.,
AAAI 2023): ``instarevive_tpu/utils/clipiqa.py`` in PyTorch.

An image's score is the softmax, over each (positive, negative) prompt pair
(by default ("Good photo.", "Bad photo.")), of ``logit_scale.exp()`` times
the cosine similarity of its CLIP embedding to the two prompts' embeddings,
the positive's probability averaged over the pairs (pyiqa's ``clipiqa``).

The backbone is either handed in (``model=`` with ``tokenizer=``), or
loaded from ``model_dir``: a ``.pt``/``.pth`` file is an OpenAI CLIP RN50
state dict (pyiqa's default backbone, ``models/clip_rn50.py``) and needs
``tokenizer_dir``; anything else is a Hugging Face CLIP directory
(``transformers.CLIPModel``). The tokenizer and an HF directory need the
``transformers`` package; without it the loader says so, and a caller
hands in its own tokenizer (any callable with the HF tokenizer's
``(texts, padding=True, return_tensors="np") -> {"input_ids"}`` surface).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from instarevive_tpu_torch.ops.resize import pil_resize_bicubic

# CLIP preprocessing constants (openai/CLIP preprocess)
_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

DEFAULT_PROMPTS: Tuple[Tuple[str, str], ...] = (("Good photo.", "Bad photo."),)


def _transformers():
    try:
        import transformers
    except ImportError as e:
        raise ImportError("CLIP-IQA: the tokenizer and a Hugging Face CLIP directory need the `transformers` "
                          "package, which is not installed; hand in tokenizer= (and model=) instead") from e
    return transformers


class CLIPIQA:
    """Callable: (N, H, W, 3) [0, 1] images -> (N,) scores in [0, 1]."""

    def __init__(self, model_dir: str | None = None, model=None, tokenizer=None,
                 prompts: Sequence[Tuple[str, str]] = DEFAULT_PROMPTS, tokenizer_dir: str | None = None,
                 device="cuda"):
        if model is None and model_dir and model_dir.endswith((".pt", ".pth")):
            from instarevive_tpu_torch.models.clip_rn50 import load_openai_clip

            model = load_openai_clip(model_dir, device)
            if tokenizer is None and not tokenizer_dir:
                raise ValueError("RN50 checkpoints need --clipiqa_tokenizer (a local HF CLIP tokenizer dir)")
        elif model is None:
            model = _transformers().CLIPModel.from_pretrained(model_dir).to(device).eval().requires_grad_(False)
        if tokenizer is None:
            tokenizer = _transformers().AutoTokenizer.from_pretrained(tokenizer_dir or model_dir)
        self.model, self.tokenizer = model, tokenizer
        self.prompts = list(prompts)
        self.device = next(model.parameters()).device
        self.image_size = int(getattr(model, "image_size", 0) or model.config.vision_config.image_size)
        self._text_embeds = None
        # pyiqa scales the cosine similarities by the checkpoint's logit_scale.exp() (100 for OpenAI CLIP)
        scale = getattr(model, "logit_scale", None)
        self.logit_scale = 100.0 if scale is None else float(np.exp(float(scale)))

    @torch.no_grad()
    def _embed_prompts(self) -> np.ndarray:
        """(P, 2, D) unit text embeddings of the antonym pairs, computed once."""
        if self._text_embeds is None:
            flat: List[str] = [p for pair in self.prompts for p in pair]
            tok = self.tokenizer(flat, padding=True, return_tensors="np")
            ids = torch.as_tensor(np.asarray(tok["input_ids"]), dtype=torch.long, device=self.device)
            mask = tok.get("attention_mask")
            mask = None if mask is None else torch.as_tensor(np.asarray(mask), device=self.device)
            emb = self.model.get_text_features(input_ids=ids, attention_mask=mask).float().cpu().numpy()
            emb = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
            self._text_embeds = emb.reshape(len(self.prompts), 2, -1)
        return self._text_embeds

    def _preprocess(self, images01: np.ndarray) -> torch.Tensor:
        """[0, 1] NHWC -> CLIP-normalised NCHW at the tower's size (PIL
        bicubic, clipped to [0, 1]), on the model's device."""
        size = self.image_size
        x = torch.as_tensor(np.asarray(images01, np.float32), device=self.device)
        if x.shape[1] != size or x.shape[2] != size:
            x = pil_resize_bicubic(x, (size, size)).clamp(0.0, 1.0)
        x = (x - torch.from_numpy(_MEAN).to(self.device)) / torch.from_numpy(_STD).to(self.device)
        return x.permute(0, 3, 1, 2)

    @torch.no_grad()
    def __call__(self, images01: np.ndarray) -> np.ndarray:
        img = self.model.get_image_features(pixel_values=self._preprocess(images01)).float().cpu().numpy()
        img = img / np.linalg.norm(img, axis=-1, keepdims=True)
        txt = self._embed_prompts()
        sims = self.logit_scale * np.einsum("nd,pkd->npk", img, txt)
        e = np.exp(sims - sims.max(axis=-1, keepdims=True))
        return (e[..., 0] / e.sum(axis=-1)).mean(axis=-1)
