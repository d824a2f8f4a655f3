"""The port's LLaVA-MPT captioner (``models/llava_mpt.py``) and its CLI
(``tools/extract_caption.py``) against the JAX package on the CPU, at tiny
widths: MPT logits in three configurations (multi-head with ALiBi and no
biases; multi-query with qk-LayerNorm, learned positions, biases and
RMSNorm; clip_qkv, an explicit softmax scale, a logit scale and an
embedding fraction), left-padded prompts, through both weight routes (the
JAX params through ``convert/from_jax``; a seeded MPT state dict through
``load_mpt_checkpoint`` and ``mpt_params_from_torch``), ``lm_loss``, greedy
decoding with the KV cache, the LLaVA splice and generation, and both
captioning CLIs over one folder (a tiny ``CLIPVisionModel`` directory, which
the JAX CLI converts at load as it always does, and a word-level tokenizer
built in code). Bound: f32, 1e-5 of max|JAX| for logits and loss; tokens
and captions exactly."""

import json
import os

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test worker)
from PIL import Image

import jax
import jax.numpy as jnp

from instarevive_tpu.convert.torch_import import mpt_params_from_torch
from instarevive_tpu.models import llava_mpt as jax_mpt
from instarevive_tpu_torch.convert.from_jax import mpt_params_to_torch
from instarevive_tpu_torch.models import llava_mpt as mpt
from instarevive_tpu_torch.tools import official_layouts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = {
    "mha_alibi_nobias": dict(d_model=64, n_heads=4, n_layers=3, vocab_size=97, max_seq_len=48),
    "mqa_qkln_wpe_rms": dict(d_model=64, n_heads=4, n_layers=2, vocab_size=80, max_seq_len=48,
                             attn_type="multiquery_attention", qk_ln=True, alibi=False, no_bias=False,
                             norm_type="rmsnorm"),
    "clip_scale_fraction": dict(d_model=48, n_heads=6, n_layers=2, vocab_size=70, max_seq_len=48, clip_qkv=0.5,
                                softmax_scale=0.3, logit_scale=0.7, embedding_fraction=0.4, no_bias=False),
}


def close(out, ref, rel=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0, atol=rel * max(1.0, float(np.abs(ref).max())))


def _prompt(cfg, b=2, s=12, seed=0):
    """Left-padded prompts: row 1 starts 3 tokens late."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg["vocab_size"], (b, s)).astype(np.int32)
    mask = np.ones((b, s), bool)
    mask[1, :3] = False
    return ids, mask


def _pair(name, seed=0, **extra):
    cfg = dict(CFGS[name], **extra)
    jcfg, tcfg = jax_mpt.MPTConfig(**cfg), mpt.MPTConfig(**cfg)
    ids, mask = _prompt(cfg)
    jmodel = jax_mpt.MPTModel(jcfg)
    params = jmodel.init(jax.random.key(seed), jnp.asarray(ids), jnp.asarray(mask))["params"]
    model = mpt.MPTModel(tcfg).eval()
    sd = mpt_params_to_torch(params, tcfg.n_layers)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    return jmodel, params, model, ids, mask


@pytest.mark.parametrize("name", list(CFGS))
def test_mpt_logits_match_jax(name):
    jmodel, params, model, ids, mask = _pair(name)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask), method="lm"))
    with torch.no_grad():
        got = model.lm(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (2, 12, CFGS[name]["vocab_size"])
    close(got, want)


@pytest.mark.parametrize("name", ["mha_alibi_nobias", "mqa_qkln_wpe_rms"])
def test_mpt_checkpoint_layout_matches_jax(name):
    """A seeded MPT state dict under ``transformer.`` through the port's
    loader and through ``mpt_params_from_torch``."""
    tcfg = mpt.MPTConfig(**CFGS[name])
    model = mpt.MPTModel(tcfg)
    sd = official_layouts.mpt(model, seed=4)
    mpt.load_mpt_checkpoint(model, sd).eval()
    ids, mask = _prompt(CFGS[name], seed=1)
    jcfg = jax_mpt.MPTConfig(**CFGS[name])
    want = jax_mpt.MPTModel(jcfg).apply({"params": mpt_params_from_torch(sd, jcfg)}, jnp.asarray(ids),
                                         jnp.asarray(mask), method="lm")
    with torch.no_grad():
        close(model.lm(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy(), want)
    del sd["transformer.norm_f.weight"]
    with pytest.raises(KeyError, match="norm_f"):
        mpt.load_mpt_checkpoint(mpt.MPTModel(tcfg), sd)


def test_lm_loss_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 9, 31)).astype(np.float32)
    labels = rng.integers(0, 31, (2, 9))
    labels[0, 4] = labels[1, 0] = -100
    want = float(jax_mpt.lm_loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(mpt.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want))


@pytest.mark.parametrize("name", ["mha_alibi_nobias", "mqa_qkln_wpe_rms"])
def test_greedy_generate_matches_jax(name):
    jmodel, params, model, ids, mask = _pair(name, seed=3)
    want = np.asarray(jax_mpt.greedy_generate(jmodel, params, jnp.asarray(ids), jnp.asarray(mask), 10, eos_id=5))
    got = mpt.greedy_generate(model, torch.from_numpy(ids).long(), torch.from_numpy(mask), 10, eos_id=5).numpy()
    assert got.shape == (2, 10)
    np.testing.assert_array_equal(got, want)
    # the cache's steps equal recomputing the whole sequence each step
    seq = torch.from_numpy(ids).long()
    full_mask = torch.from_numpy(mask)
    for t in range(4):
        with torch.no_grad():
            nxt = model.lm(seq, full_mask)[:, -1].argmax(-1)
        assert torch.equal(nxt, torch.from_numpy(got[:, t]).long())
        seq = torch.cat([seq, nxt[:, None]], 1)
        full_mask = torch.cat([full_mask, torch.ones(2, 1, dtype=torch.bool)], 1)


def _vision(w):
    """A stand-in tower (numpy or torch): 4 x 4 patch means of the image,
    projected by ``w``."""
    def fn(images):
        b, c, h, ww = images.shape
        x = images.reshape(b, c, h // 4, 4, ww // 4, 4).mean(axis=(3, 5)).reshape(b, c, -1)
        return x.swapaxes(1, 2) @ w
    return fn


def test_llava_generate_matches_jax():
    cfg = dict(CFGS["mha_alibi_nobias"], mm_hidden_size=24)
    jcfg, tcfg = jax_mpt.MPTConfig(**cfg), mpt.MPTConfig(**cfg)
    rng = np.random.default_rng(6)
    w = rng.standard_normal((3, 24)).astype(np.float32)
    images = rng.uniform(0, 1, (2, 3, 8, 8)).astype(np.float32)
    im_patch = 9
    ids = np.array([[3, 11, 12] + [im_patch] * 4 + [13], [20, 21, 22] + [im_patch] * 4 + [14]], np.int32)
    jmodel = jax_mpt.MPTModel(jcfg)
    params = jmodel.init(jax.random.key(7), jnp.asarray(ids), jnp.zeros((2, 4, 24)), method=lambda m, i, f: (
        m(i), m.splice_images(m.wte(i), i, f, im_patch)))["params"]
    model = mpt.MPTModel(tcfg).eval()
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in mpt_params_to_torch(params, 3).items()})
    jl = jax_mpt.LlavaMPT(jmodel, params, lambda im: jnp.asarray(_vision(w)(np.asarray(im))), im_patch)
    tl = mpt.LlavaMPT(model, _vision(torch.from_numpy(w)), im_patch)
    close(tl.caption_logits(torch.from_numpy(ids).long(), torch.from_numpy(images)).numpy(),
          jl.caption_logits(jnp.asarray(ids), jnp.asarray(images)))
    mask = np.ones(ids.shape, bool)
    want = np.asarray(jl.generate(jnp.asarray(ids), jnp.asarray(images), jnp.asarray(mask), 6))
    got = tl.generate(torch.from_numpy(ids).long(), torch.from_numpy(images), torch.from_numpy(mask), 6).numpy()
    np.testing.assert_array_equal(got, want)


def test_extract_caption_cli_matches_jax(tmp_path, monkeypatch):
    import importlib.util
    import sys

    from transformers import CLIPImageProcessor, CLIPVisionModel

    from instarevive_tpu_torch.tools import extract_caption
    from instarevive_tpu_torch.tools import text_checkpoints as tc

    vcfg = tc.clip_vision_config(hidden_size=32, intermediate_size=64, num_hidden_layers=3, num_attention_heads=4,
                                 image_size=32, patch_size=8)
    clip_dir = str(tmp_path / "clip")
    tc.seeded_model(lambda: CLIPVisionModel(vcfg), seed=1).save_pretrained(clip_dir)
    CLIPImageProcessor(size={"shortest_edge": 32}, crop_size={"height": 32, "width": 32}).save_pretrained(clip_dir)
    tok_dir = str(tmp_path / "tok")
    tc.word_tokenizer(64, 2048, "plain").save_pretrained(tok_dir)
    model = mpt.MPTModel(mpt.MPTConfig(d_model=32, n_heads=4, n_layers=2, vocab_size=64, mm_hidden_size=32))
    ckpt = str(tmp_path / "llava.pt")
    torch.save(official_layouts.mpt(model, seed=8), ckpt)
    src = tmp_path / "imgs"
    src.mkdir()
    rng = np.random.default_rng(9)
    for i, (h, w) in enumerate([(40, 48), (36, 36), (50, 44)]):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(src / f"{i}.png")
    args = ["--input", str(src), "--mpt_ckpt", ckpt, "--clip_dir", clip_dir, "--tokenizer", tok_dir,
            "--prompt", "describe this image", "--max_new_tokens", "8", "--batch_size", "2",
            "--d_model", "32", "--n_heads", "4", "--n_layers", "2", "--vocab_size", "64"]
    spec = importlib.util.spec_from_file_location("jax_tool_extract_caption", os.path.join(REPO, "tools",
                                                                                         "extract_caption.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(sys, "argv", ["extract_caption"] + args + ["--output", str(tmp_path / "jax.json")])
    tool.main()
    got = extract_caption.main(args + ["--output", str(tmp_path / "port.json"), "--device", "cpu"])
    want = json.loads((tmp_path / "jax.json").read_text())
    assert got == want and sorted(got) == ["0.png", "1.png", "2.png"]
    assert any(got.values())
    with pytest.raises(SystemExit, match="needs local weights"):
        extract_caption.main(["--input", str(src), "--output", str(tmp_path / "x.json")])
