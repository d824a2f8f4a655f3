"""The LLaVA-MPT captioner: the MPT decoder and the CLIP-feature splice, the
PyTorch port of ``instarevive_tpu/models/llava_mpt.py``.

``MPTModel`` takes every option the JAX module takes: multi-head or
multi-query attention, ALiBi (the causal form: one bias a key, by its
distance from the last position) or learned positions with the
left-padding correction, qk-LayerNorm, ``clip_qkv``, an explicit softmax
scale, ``no_bias`` (no biases, LayerNorms without shift), the low-precision
LayerNorm or the vendored RMSNorm (which multiplies by the RMS, as that
release did), ``logit_scale`` and ``embedding_fraction``; the LLaVA
``mm_projector`` when ``mm_hidden_size`` is set. Attention is the
reference's plain form: scores plus bias, padding and future keys set to
the dtype's minimum, softmax. Parameter names are the MPT checkpoint's
(``wte``, ``blocks.N.norm_1``, ``attn.Wqkv``, ``ffn.up_proj``, ``norm_f``);
``load_mpt_checkpoint`` takes a (LLaVA-)MPT state dict, ``transformer.``
prefix and all, and ``convert/from_jax.mpt_params_to_torch`` the JAX
package's params.

``greedy_generate`` prefills a KV cache sized for the whole run, then
appends one token a step, each step attending over the cache with the
positions not yet written masked, as the JAX package's decode loop does
(a Python loop here in place of its ``lax.scan``). ``LlavaMPT`` splices
projected image features over the first run of ``<im_patch>`` tokens; its
``vision_fn`` (``tools/extract_caption.py``: a ``transformers``
``CLIPVisionModel``, a hidden layer chosen, the class token dropped) is
pluggable.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from instarevive_tpu_torch.convert.checkpoint_layouts import strip_prefixes


@dataclasses.dataclass(frozen=True)
class MPTConfig:
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    expansion_ratio: int = 4
    max_seq_len: int = 2048
    vocab_size: int = 50368
    attn_type: str = "multihead_attention"  # | multiquery_attention
    qk_ln: bool = False
    clip_qkv: Optional[float] = None
    softmax_scale: Optional[float] = None
    alibi: bool = True
    alibi_bias_max: int = 8
    no_bias: bool = True
    norm_type: str = "low_precision_layernorm"  # | rmsnorm variants
    logit_scale: Optional[float] = None
    embedding_fraction: float = 1.0
    mm_hidden_size: Optional[int] = None


# MPT-7B / LLaVA-MPT-7B (mosaicml/mpt-7b config.json)
MPT_7B = MPTConfig(d_model=4096, n_heads=32, n_layers=32, vocab_size=50432)


def gen_slopes(n_heads: int, alibi_bias_max: int = 8) -> np.ndarray:
    """The ALiBi slopes, (1, h, 1, 1)."""
    nh = 2 ** math.ceil(math.log2(n_heads))
    m = np.arange(1, nh + 1, dtype=np.float32) * (alibi_bias_max / nh)
    slopes = 1.0 / np.power(2, m)
    if nh != n_heads:
        slopes = np.concatenate([slopes[1::2], slopes[::2]])[:n_heads]
    return slopes.reshape(1, n_heads, 1, 1)


def build_alibi_bias(n_heads: int, seq_len: int, alibi_bias_max: int = 8) -> np.ndarray:
    """The causal ALiBi bias (1, h, 1, S) for keys at distances k - (S - 1)."""
    dist = np.arange(1 - seq_len, 1, dtype=np.float32).reshape(1, 1, 1, seq_len)
    return dist * gen_slopes(n_heads, alibi_bias_max)


class RMSNorm(nn.Module):
    """The vendored MPT ``rms_norm``: x * sqrt(mean(x^2) + eps) * weight, in f32."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.sqrt(xf.pow(2).mean(-1, keepdim=True) + 1e-5)
        return (y * self.weight.float()).to(x.dtype)


def _norm(cfg: MPTConfig, dim: Optional[int] = None) -> nn.Module:
    dim = dim or cfg.d_model
    if cfg.norm_type.lower().endswith("rmsnorm"):
        return RMSNorm(dim)
    return nn.LayerNorm(dim, eps=1e-5, bias=not cfg.no_bias)


def _scores_attention(q, k, v, bias, mask, scale) -> torch.Tensor:
    """Scores + bias, masked keys at the dtype's minimum, softmax, times v;
    k and v may have one head (multi-query), broadcast over q's."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.to(s.dtype)
    if mask is not None:
        s = s.masked_fill(~mask, torch.finfo(s.dtype).min)
    return torch.matmul(torch.softmax(s, dim=-1), v)


class MPTAttention(nn.Module):
    def __init__(self, cfg: MPTConfig):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.d_model, cfg.n_heads
        self.hk = 1 if cfg.attn_type == "multiquery_attention" else h
        self.dh = d // h
        self.kv_dim = self.hk * self.dh
        self.Wqkv = nn.Linear(d, d + 2 * self.kv_dim, bias=not cfg.no_bias)
        if cfg.qk_ln:
            self.q_ln = nn.LayerNorm(d, eps=1e-5, bias=not cfg.no_bias)
            self.k_ln = nn.LayerNorm(self.kv_dim, eps=1e-5, bias=not cfg.no_bias)
        self.out_proj = nn.Linear(d, d, bias=not cfg.no_bias)
        self.register_buffer("slopes", torch.tensor(gen_slopes(h, cfg.alibi_bias_max)), persistent=False)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor], cache=None, position: Optional[int] = None):
        """A full causal pass (cache None; returns its k, v) or one decode step
        at ``position`` writing into the fixed-size ``cache`` = (k, v)."""
        cfg = self.cfg
        b, s, d = x.shape
        qkv = self.Wqkv(x)
        if cfg.clip_qkv:
            qkv = qkv.clamp(-cfg.clip_qkv, cfg.clip_qkv)
        q, k, v = qkv.split([d, self.kv_dim, self.kv_dim], dim=-1)
        if cfg.qk_ln:
            q, k = self.q_ln(q), self.k_ln(k)
        q = q.reshape(b, s, cfg.n_heads, self.dh).transpose(1, 2)
        k = k.reshape(b, s, self.hk, self.dh).transpose(1, 2)
        v = v.reshape(b, s, self.hk, self.dh).transpose(1, 2)
        scale = cfg.softmax_scale or 1.0 / math.sqrt(self.dh)
        if cache is None:
            mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()[None, None]
            if key_mask is not None:
                mask = mask & key_mask[:, None, None, :]
            bias = None
            if cfg.alibi:
                bias = torch.arange(1 - s, 1, device=x.device, dtype=torch.float32) * self.slopes
            o, new_cache = _scores_attention(q, k, v, bias, mask, scale), (k, v)
        else:
            k_cache, v_cache = cache
            k_cache[:, :, position:position + 1] = k
            v_cache[:, :, position:position + 1] = v
            idx = torch.arange(k_cache.shape[2], device=x.device)
            mask = (idx <= position)[None, None, None, :]
            if key_mask is not None:
                mask = mask & key_mask[:, None, None, :]
            bias = (idx - position).float() * self.slopes if cfg.alibi else None
            o, new_cache = _scores_attention(q, k_cache, v_cache, bias, mask, scale), cache
        return self.out_proj(o.transpose(1, 2).reshape(b, s, d)), new_cache


class MPTMLP(nn.Module):
    def __init__(self, cfg: MPTConfig):
        super().__init__()
        self.up_proj = nn.Linear(cfg.d_model, cfg.expansion_ratio * cfg.d_model, bias=not cfg.no_bias)
        self.down_proj = nn.Linear(cfg.expansion_ratio * cfg.d_model, cfg.d_model, bias=not cfg.no_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.gelu(self.up_proj(x)))


class MPTBlock(nn.Module):
    def __init__(self, cfg: MPTConfig):
        super().__init__()
        self.norm_1, self.norm_2 = _norm(cfg), _norm(cfg)
        self.attn = MPTAttention(cfg)
        self.ffn = MPTMLP(cfg)

    def forward(self, x, key_mask, cache=None, position=None):
        o, new_cache = self.attn(self.norm_1(x), key_mask, cache, position)
        x = x + o
        return x + self.ffn(self.norm_2(x)), new_cache


class MPTModel(nn.Module):
    def __init__(self, cfg: MPTConfig):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.d_model)
        if not cfg.alibi:
            self.wpe = nn.Embedding(cfg.max_seq_len, cfg.d_model)
        self.blocks = nn.ModuleList(MPTBlock(cfg) for _ in range(cfg.n_layers))
        self.norm_f = _norm(cfg)
        if cfg.mm_hidden_size:
            self.mm_projector = nn.Linear(cfg.mm_hidden_size, cfg.d_model)

    def splice_images(self, tok_emb: torch.Tensor, input_ids: torch.Tensor, image_features: torch.Tensor,
                      im_patch_token: int) -> torch.Tensor:
        """The projected image features written over each row's run of
        ``<im_patch>`` tokens, from its first (clamped so that the run fits)."""
        feats = self.mm_projector(image_features).to(tok_emb.dtype)
        n, length = feats.shape[1], tok_emb.shape[1]
        start = (input_ids == im_patch_token).int().argmax(dim=1).clamp(max=length - n).tolist()
        out = tok_emb.clone()
        for i, s in enumerate(start):
            out[i, s:s + n] = feats[i]
        return out

    def forward(self, input_ids=None, key_mask=None, tok_emb=None, caches=None, position: Optional[int] = None):
        """-> (hidden after ``norm_f``, the blocks' caches)."""
        cfg = self.cfg
        x = self.wte(input_ids) if tok_emb is None else tok_emb
        if not cfg.alibi:
            s = x.shape[1]
            if position is None:
                pos = torch.arange(s, device=x.device)[None]
                if key_mask is not None:  # left padding: positions count the real tokens
                    pos = (pos - torch.cumsum((~key_mask).int(), dim=1)).clamp(min=0)
            else:
                pos = torch.full((1, s), position, device=x.device)
                if key_mask is not None:
                    pos = (pos - (~key_mask).int().sum(dim=1, keepdim=True)).clamp(min=0)
            x = x + self.wpe(pos)
        if cfg.embedding_fraction != 1.0:
            x = x * cfg.embedding_fraction + x.detach() * (1 - cfg.embedding_fraction)
        new_caches = []
        for i, blk in enumerate(self.blocks):
            x, c = blk(x, key_mask, None if caches is None else caches[i], position)
            new_caches.append(c)
        return self.norm_f(x), new_caches

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """The tied-embedding head."""
        out = F.linear(hidden, self.wte.weight)
        return out * self.cfg.logit_scale if self.cfg.logit_scale is not None else out

    def lm(self, input_ids=None, key_mask=None, tok_emb=None) -> torch.Tensor:
        return self.logits(self(input_ids, key_mask, tok_emb)[0])


def lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The next-token cross entropy: labels rolled left by one, the last and
    every -100 ignored."""
    labels = torch.roll(labels, -1, dims=1)
    labels[:, -1] = -100
    valid = labels != -100
    nll = -torch.log_softmax(logits.float(), dim=-1).gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    return (nll * valid).sum() / valid.sum().clamp(min=1)


@torch.no_grad()
def _decode_loop(model: MPTModel, tok0: torch.Tensor, caches, s0: int, key_mask, max_new_tokens: int,
                 eos_id: Optional[int]) -> torch.Tensor:
    b, total = tok0.shape[0], s0 + max_new_tokens
    full = []
    for k, v in caches:
        kf = k.new_zeros(b, k.shape[1], total, k.shape[3])
        vf = v.new_zeros(b, v.shape[1], total, v.shape[3])
        kf[:, :, :s0], vf[:, :, :s0] = k, v
        full.append((kf, vf))
    ones = torch.ones(b, max_new_tokens, dtype=torch.bool, device=tok0.device)
    mask = (torch.cat([key_mask.bool(), ones], dim=1) if key_mask is not None
            else torch.ones(b, total, dtype=torch.bool, device=tok0.device))
    tok, out = tok0, []
    done = (tok0 == eos_id) if eos_id is not None else torch.zeros(b, dtype=torch.bool, device=tok0.device)
    for i in range(max_new_tokens):
        out.append(tok)
        h, full = model(None, mask, tok_emb=model.wte(tok[:, None]), caches=full, position=s0 + i)
        nxt = model.logits(h[:, -1]).argmax(dim=-1)
        if eos_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
        tok = nxt
    return torch.stack(out, dim=1)


@torch.no_grad()
def greedy_generate(model: MPTModel, input_ids: torch.Tensor, key_mask: Optional[torch.Tensor],
                    max_new_tokens: int, eos_id: Optional[int] = None) -> torch.Tensor:
    """(B, max_new_tokens) greedy tokens after a left-padded prompt; after
    ``eos_id`` a row repeats it."""
    h, caches = model(input_ids, key_mask)
    tok0 = model.logits(h[:, -1]).argmax(dim=-1)
    return _decode_loop(model, tok0, caches, input_ids.shape[1], key_mask, max_new_tokens, eos_id)


def clip_select_features(hidden_states, select_layer: int = -1) -> torch.Tensor:
    """One hidden layer of a CLIP vision tower, its class token dropped."""
    return hidden_states[select_layer][:, 1:]


class LlavaMPT:
    """An ``MPTModel`` with ``mm_projector`` and a vision function
    ``vision_fn(images) -> (B, patches, mm_hidden_size)``."""

    def __init__(self, model: MPTModel, vision_fn: Callable[[torch.Tensor], torch.Tensor], im_patch_token: int):
        if not model.cfg.mm_hidden_size:
            raise ValueError("LlavaMPT needs cfg.mm_hidden_size")
        self.model, self.vision_fn, self.im_patch_token = model, vision_fn, im_patch_token

    def multimodal_embed(self, input_ids: torch.Tensor, images: torch.Tensor) -> torch.Tensor:
        return self.model.splice_images(self.model.wte(input_ids), input_ids, self.vision_fn(images),
                                        self.im_patch_token)

    @torch.no_grad()
    def caption_logits(self, input_ids, images, key_mask=None) -> torch.Tensor:
        return self.model.lm(None, key_mask, self.multimodal_embed(input_ids, images))

    @torch.no_grad()
    def generate(self, input_ids, images, key_mask, max_new_tokens: int, eos_id: Optional[int] = None):
        h, caches = self.model(None, key_mask, tok_emb=self.multimodal_embed(input_ids, images))
        tok0 = self.model.logits(h[:, -1]).argmax(dim=-1)
        return _decode_loop(self.model, tok0, caches, input_ids.shape[1], key_mask, max_new_tokens, eos_id)


def load_mpt_checkpoint(model: MPTModel, sd: Mapping) -> MPTModel:
    """An MPT or LLaVA-MPT state dict (``transformer.``-prefixed for the
    causal-LM wrapper; no separate head: the embeddings are tied) into
    ``model``: the keys it holds are taken, a missing one raises."""
    sd = strip_prefixes(sd, ("module.",))
    if any(k.startswith("transformer.") for k in sd):
        sd = {k[len("transformer."):]: v for k, v in sd.items() if k.startswith("transformer.")}
    state = {}
    for key in model.state_dict():
        if key not in sd:
            raise KeyError(f"MPT checkpoint: missing key {key!r}")
        v = sd[key]
        state[key] = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
    model.load_state_dict(state)
    return model
