"""Text-encoder checkpoints made in code, for the tests and ``chip_smoke.py``:
a word-level tokenizer (``tokenizers`` model, saved as ``tokenizer.json``;
no ``sentencepiece`` needed), the published configurations of the towers
the port loads through ``transformers`` (T5 v1.1 XXL's encoder, the OpenCLIP
ViT-H/14 text tower, CLIP ViT-L/14's vision tower), and a directory writer
that saves a seeded model in the Hugging Face layout. No file is read or
downloaded.
"""

from __future__ import annotations

import os
from typing import Sequence

# google/t5-v1_1-xxl's config.json, encoder fields
T5_V1_1_XXL = dict(vocab_size=32128, d_model=4096, d_kv=64, d_ff=10240, num_layers=24, num_heads=64,
                   feed_forward_proj="gated-gelu", relative_attention_num_buckets=32,
                   relative_attention_max_distance=128, layer_norm_epsilon=1e-6)
# laion/CLIP-ViT-H-14's text tower (configs/cldm.yaml cond_stage: FrozenOpenCLIPEmbedder, layer penultimate)
OPENCLIP_H_TEXT = dict(vocab_size=49408, hidden_size=1024, intermediate_size=4096, num_hidden_layers=24,
                       num_attention_heads=16, max_position_embeddings=77, hidden_act="gelu", projection_dim=1024)
# openai/clip-vit-large-patch14's vision tower (LLaVA's mm_vision_tower), 224 x 224
CLIP_L14_VISION = dict(hidden_size=1024, intermediate_size=4096, num_hidden_layers=24, num_attention_heads=16,
                       image_size=224, patch_size=14, hidden_act="quick_gelu", projection_dim=768)

WORDS = ("a", "photo", "of", "the", "cat", "dog", "red", "panda", "portrait", "face", "man", "woman", "old",
         "young", "high", "quality", "detailed", "in", "on", "with", "and", "describe", "this", "image", "its",
         "style", "very", "manner", "sharp", "clean")


def word_tokenizer(vocab_size: int, model_max_length: int, kind: str = "t5", words: Sequence[str] = WORDS):
    """A ``PreTrainedTokenizerFast`` over ``words`` (lower-cased, split on
    whitespace and punctuation), every other id up to ``vocab_size`` a filler
    word ``w<i>``. ``kind`` ``t5``: ids 0/1/2 are pad, eos, unk and a text
    ends with eos; ``clip``: a text is bos ... eos, padded with eos;
    ``plain`` (the captioner's): bos, eos, unk, pad and ``<im_patch>``, no
    template."""
    from tokenizers import Tokenizer, models, normalizers, pre_tokenizers, processors
    from transformers import PreTrainedTokenizerFast

    specials = {"t5": ["<pad>", "</s>", "<unk>"],
                "clip": ["<|startoftext|>", "<|endoftext|>", "<unk>"],
                "plain": ["<s>", "</s>", "<unk>", "<pad>", "<im_patch>"]}[kind]
    names = list(specials) + list(words)
    names += [f"w{i}" for i in range(vocab_size - len(names))]
    tk = Tokenizer(models.WordLevel({w: i for i, w in enumerate(names[:vocab_size])}, unk_token="<unk>"))
    tk.normalizer = normalizers.Lowercase()
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    if kind == "t5":
        tk.post_processor = processors.TemplateProcessing(single="$A </s>", special_tokens=[("</s>", 1)])
        kw = dict(pad_token="<pad>", eos_token="</s>", unk_token="<unk>")
    elif kind == "clip":
        tk.post_processor = processors.TemplateProcessing(
            single="<|startoftext|> $A <|endoftext|>", special_tokens=[("<|startoftext|>", 0), ("<|endoftext|>", 1)])
        kw = dict(bos_token="<|startoftext|>", eos_token="<|endoftext|>", pad_token="<|endoftext|>",
                  unk_token="<unk>")
    else:
        kw = dict(bos_token="<s>", eos_token="</s>", unk_token="<unk>", pad_token="<pad>",
                  additional_special_tokens=["<im_patch>"])
    return PreTrainedTokenizerFast(tokenizer_object=tk, model_max_length=model_max_length, **kw)


def t5_config(**overrides):
    from transformers import T5Config

    kw = dict(T5_V1_1_XXL, dropout_rate=0.0, is_encoder_decoder=False, use_cache=False)
    kw.update(overrides)
    return T5Config(**kw)


def clip_text_config(**overrides):
    from transformers import CLIPTextConfig

    kw = dict(OPENCLIP_H_TEXT, bos_token_id=0, eos_token_id=1, pad_token_id=1)
    kw.update(overrides)
    return CLIPTextConfig(**kw)


def clip_vision_config(**overrides):
    from transformers import CLIPVisionConfig

    kw = dict(CLIP_L14_VISION)
    kw.update(overrides)
    return CLIPVisionConfig(**kw)


def seeded_model(make, seed: int, device="cpu"):
    """``make()`` with its weights drawn by the module's own init under
    ``torch.manual_seed(seed)`` on ``device``: float32, frozen, in eval mode."""
    import torch

    with torch.device(device):
        torch.manual_seed(seed)
        model = make()
    return model.float().eval().requires_grad_(False)


def write_dir(path: str, model, tokenizer) -> str:
    """The Hugging Face directory of ``model`` and ``tokenizer``
    (``config.json``, ``model.safetensors``, ``tokenizer.json``)."""
    os.makedirs(path, exist_ok=True)
    model.save_pretrained(path)
    tokenizer.save_pretrained(path)
    return path


def t5_dir(path: str, seed: int = 0, model_max_length: int = 120, **config) -> str:
    from transformers import T5EncoderModel

    cfg = t5_config(**config)
    return write_dir(path, seeded_model(lambda: T5EncoderModel(cfg), seed),
                     word_tokenizer(cfg.vocab_size, model_max_length, "t5"))


def clip_text_dir(path: str, seed: int = 0, **config) -> str:
    from transformers import CLIPTextModel

    cfg = clip_text_config(**config)
    return write_dir(path, seeded_model(lambda: CLIPTextModel(cfg), seed),
                     word_tokenizer(cfg.vocab_size, cfg.max_position_embeddings, "clip"))
