"""T5 text embedder, the PyTorch port of ``instarevive_tpu/models/t5.py``.

The encoder is ``transformers.T5EncoderModel`` (the torch class of the
``FlaxT5EncoderModel`` the JAX wrapper loads), in float32 as the Flax
wrapper computes; TF32 stays off (``pipelines.build.set_precision``). The
caption cleaning is this package's own copy, with the same optional
``ftfy`` pass. ``get_text_embeddings`` returns what the JAX wrapper
returns: numpy ``(embeddings (B, L, D), attention_mask (B, L))`` at
``model_max_length``; ``encode`` keeps both on the device for callers that
go on there (``sample.py``, ``tools/extract_features.py``).

A model and tokenizer may be handed in instead of ``model_dir``: the chip
smoke builds T5 v1.1 XXL from its config on the card with seeded weights.
"""

from __future__ import annotations

import html
import re
from typing import List, Optional, Tuple

import numpy as np

BAD_PUNCT = re.compile(
    r"[" + "#®•©™&@·º½¾¿¡§~" + r"\)" + r"\(" + r"\]" + r"\[" + r"\}" + r"\{" + r"\|" + "\\" + r"\/" + r"\*" + r"]{1,}"
)


def clean_caption(caption: str) -> str:
    """html unescape, url strip, punctuation dedup, whitespace squeeze (and
    ``ftfy.fix_text`` where ``ftfy`` is installed), as the JAX package's."""
    caption = str(caption).lower().strip()
    caption = html.unescape(html.unescape(caption))
    try:
        import ftfy

        caption = ftfy.fix_text(caption)
    except ImportError:
        pass
    caption = re.sub(r"https?://\S+", "", caption)
    caption = BAD_PUNCT.sub(" ", caption)
    caption = re.sub(r"\s+\.\s+", " ", caption)
    caption = re.sub(r"(?:\s|^)\.(?:\s|$)", " ", caption)
    caption = re.sub(r"\s+", " ", caption)
    return caption.strip()


def resolve_device(device):
    """``device`` as a ``torch.device``; asking for a card that is not there
    raises (no quiet switch to the CPU)."""
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda: no CUDA device is available")
    return device


class T5Embedder:
    """A T5 encoder checkpoint directory (``config.json``, the weights and the
    tokenizer files), loaded on first use onto ``device``."""

    def __init__(
        self,
        model_dir: Optional[str] = None,
        model_max_length: int = 120,
        use_text_preprocessing: bool = True,
        device="cuda",
        model=None,
        tokenizer=None,
    ):
        if (model is None) != (tokenizer is None) or (model is None and model_dir is None):
            raise ValueError("T5Embedder needs model_dir, or both a model and a tokenizer")
        self.model_dir = model_dir
        self.model_max_length = model_max_length
        self.use_text_preprocessing = use_text_preprocessing
        self.device = resolve_device(device)
        self._model = model
        self._tokenizer = tokenizer

    def _load(self):
        if self._model is None:
            import torch
            from transformers import AutoTokenizer, T5EncoderModel

            self._tokenizer = AutoTokenizer.from_pretrained(self.model_dir)
            model = T5EncoderModel.from_pretrained(self.model_dir, dtype=torch.float32)
            self._model = model.to(self.device).eval().requires_grad_(False)

    def encode(self, texts: List[str]):
        """-> (embeddings (B, L, D) float32, attention_mask (B, L) int64), on
        the model's device."""
        import torch

        self._load()
        if self.use_text_preprocessing:
            texts = [clean_caption(t) for t in texts]
        tok = self._tokenizer(
            texts,
            max_length=self.model_max_length,
            padding="max_length",
            truncation=True,
            return_tensors="pt",
        )
        ids = tok["input_ids"].to(self.device)
        mask = tok["attention_mask"].to(self.device)
        with torch.inference_mode():
            out = self._model(input_ids=ids, attention_mask=mask).last_hidden_state
        return out.float(), mask

    def get_text_embeddings(self, texts: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        """-> (embeddings (B, L, D), attention_mask (B, L)), numpy."""
        emb, mask = self.encode(texts)
        return emb.cpu().numpy(), mask.cpu().numpy()
