"""The port's text encoders against the JAX package on the CPU: T5
(``models/t5.py``) and its caption cleaning, ``sample.py --t5_dir``, the CLIP
text encoder (``models/clip.py``: both layers, ``build_cond_stage``,
``ClassEmbedder``), CLIP-IQA's Hugging Face directory route
(``utils/clipiqa.py``), and the feature extractors that write T5 features
(``tools/extract_features.py``, ``extract_features_ffhq.py``).

Each checkpoint directory is written once from one set of seeded weights,
in both formats (``model.safetensors`` for the port's torch classes,
``flax_model.msgpack`` for the JAX package's Flax classes), with a
word-level tokenizer built in code, so neither side converts at load.
Widths are tiny (T5: d_model 64, the tiny DiT's caption width, 2 layers;
CLIP: width 32, 3 layers). Bound: f32, 1e-5 of max|JAX| for the embeddings,
1e-5 absolute for the CLIP-IQA scores (as the RN50 route's).
``transformers`` is imported inside the fixtures: only the worker that runs
this file pays for it.
"""

import os

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test worker)
from PIL import Image

import jax  # noqa: F401  (the JAX package's Flax classes run on the CPU)

from instarevive_tpu.models import clip as jax_clip
from instarevive_tpu.models import t5 as jax_t5
from instarevive_tpu_torch import sample
from instarevive_tpu_torch.models import clip, t5
from instarevive_tpu_torch.tools import text_checkpoints as tc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_PATH = os.path.join(REPO, "configs", "tiny.yaml")
PROMPTS = ["A photo of a red panda", "portrait of an old man, high quality", "the <b>cat</b> &amp; the dog"]
T5_TINY = dict(vocab_size=64, d_model=64, d_kv=16, d_ff=96, num_layers=2, num_heads=4,
               relative_attention_num_buckets=8, relative_attention_max_distance=16)
CLIP_TEXT_TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                      num_attention_heads=4, projection_dim=16)


def close(out, ref, rel=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0, atol=rel * max(1.0, float(np.abs(ref).max())))


def _with_flax(path, flax_cls):
    """Add the Flax format of the directory's torch weights beside them."""
    flax_cls.from_pretrained(path, from_pt=True).save_pretrained(path)
    return path


@pytest.fixture(scope="module")
def t5_dir(tmp_path_factory):
    from transformers import FlaxT5EncoderModel

    path = tc.t5_dir(str(tmp_path_factory.mktemp("t5")), seed=0, model_max_length=16, **T5_TINY)
    return _with_flax(path, FlaxT5EncoderModel)


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    from transformers import FlaxCLIPTextModel

    path = tc.clip_text_dir(str(tmp_path_factory.mktemp("clip")), seed=1, **CLIP_TEXT_TINY)
    return _with_flax(path, FlaxCLIPTextModel)


@pytest.mark.parametrize("caption", [
    "  A Photo  of http://x.y/z a CAT. ", "red &amp;amp; blue [draft] {v2} | #tag", "a . b .c", "~~***~~", "",
])
def test_clean_caption_matches_jax(caption):
    assert t5.clean_caption(caption) == jax_t5.clean_caption(caption)


@pytest.mark.parametrize("clean", [True, False], ids=["cleaned", "raw"])
def test_t5_embeddings_match_jax(t5_dir, clean):
    ref, ref_mask = jax_t5.T5Embedder(t5_dir, model_max_length=16, use_text_preprocessing=clean
                                      ).get_text_embeddings(PROMPTS)
    out, mask = t5.T5Embedder(t5_dir, model_max_length=16, use_text_preprocessing=clean,
                              device="cpu").get_text_embeddings(PROMPTS)
    assert out.shape == (3, 16, 64) and out.dtype == np.float32
    np.testing.assert_array_equal(mask, ref_mask)
    assert 0 < mask[0].sum() < 16  # padded to model_max_length
    close(out, ref)


def test_t5_embedder_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t5.T5Embedder("unused", device="cuda")


def test_sample_caption_embeddings_match_jax(t5_dir):
    """``sample.py --t5_dir``'s y: T5 at the DiT's model_max_length, as the
    JAX CLI computes it (``sample.py:76-81``)."""
    ref, ref_mask = jax_t5.T5Embedder(t5_dir, model_max_length=16).get_text_embeddings(PROMPTS[:2])
    y, mask = sample.caption_embeddings(t5_dir, PROMPTS[:2], 16, "cpu")
    assert y.dtype == torch.float32 and y.shape == (2, 16, 64)
    np.testing.assert_array_equal(mask.numpy(), ref_mask)
    close(y.numpy(), ref)


def test_sample_cli_takes_t5_dir(t5_dir, tmp_path):
    """The prompts reach the DiT: the same seed with and without --t5_dir
    gives other images."""
    def run(out, extra):
        return sample.main(["--device", "cpu", "--random_init", "--config", TINY_PATH, "--output", str(out),
                            "--step", "2", "--image_size", "64", "--prompt", "a photo of a cat", "a red panda"]
                           + extra)

    with_t5 = run(tmp_path / "t5", ["--t5_dir", t5_dir])
    null = run(tmp_path / "null", [])
    imgs = [np.asarray(Image.open(p)).astype(np.int32) for p in with_t5]
    assert all(img.shape == (64, 64, 3) for img in imgs)
    assert max(np.abs(img - np.asarray(Image.open(p))).max() for img, p in zip(imgs, null)) > 0


@pytest.mark.parametrize("layer", clip.LAYERS)
def test_clip_embedder_matches_jax(clip_dir, layer):
    ref = jax_clip.FrozenCLIPEmbedder(clip_dir, layer=layer).encode(PROMPTS)
    out = clip.FrozenCLIPEmbedder(clip_dir, layer=layer, device="cpu").encode(PROMPTS)
    assert out.shape == (3, 77, 32)
    close(out, ref)


def test_build_cond_stage_matches_jax(clip_dir):
    cfg = {"type": "open_clip", "model_dir": clip_dir, "layer": "penultimate", "max_length": 77}
    ref = jax_clip.build_cond_stage(cfg).encode(PROMPTS[:1])
    close(clip.build_cond_stage(cfg, device="cpu").encode(PROMPTS[:1]), ref)
    assert clip.build_cond_stage({"model_dir": None}) is None
    assert jax_clip.build_cond_stage({"model_dir": None}) is None
    for mod in (clip, jax_clip):
        with pytest.raises(ValueError, match="cond_stage type"):
            mod.build_cond_stage({"model_dir": clip_dir, "type": "t5"})


def test_class_embedder_matches_jax():
    ids, drop = np.array([0, 7, 999, 3]), np.array([False, True, False, True])
    ref, out = jax_clip.ClassEmbedder(16, seed=3), clip.ClassEmbedder(16, seed=3)
    np.testing.assert_array_equal(out.table, ref.table)
    np.testing.assert_array_equal(out(ids, drop), ref(ids, drop))
    np.testing.assert_array_equal(out(ids), ref(ids))


def test_clipiqa_hf_directory_matches_jax(tmp_path):
    """CLIP-IQA from a Hugging Face CLIP directory (ROADMAP C15): the port's
    ``transformers.CLIPModel`` route against the JAX package's
    ``FlaxCLIPModel``, a tiny ``CLIPConfig`` built in code."""
    from transformers import CLIPConfig, CLIPModel, FlaxCLIPModel

    from instarevive_tpu.utils.clipiqa import CLIPIQA as JaxCLIPIQA
    from instarevive_tpu_torch.utils.clipiqa import CLIPIQA

    cfg = CLIPConfig(text_config=tc.clip_text_config(**CLIP_TEXT_TINY).to_dict(),
                     vision_config=tc.clip_vision_config(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                                         num_attention_heads=4, image_size=32,
                                                         patch_size=8).to_dict(),
                     projection_dim=16)
    path = tc.write_dir(str(tmp_path / "clip"), tc.seeded_model(lambda: CLIPModel(cfg), seed=2),
                        tc.word_tokenizer(64, 77, "clip"))
    _with_flax(path, FlaxCLIPModel)
    images = np.random.default_rng(5).uniform(0, 1, (3, 40, 40, 3)).astype(np.float32)
    ref = JaxCLIPIQA(model_dir=path)(images)
    out = CLIPIQA(model_dir=path, device="cpu")(images)
    assert out.shape == (3,) and np.all((out > 0) & (out < 1))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


# ----------------------------------------------------- the feature extractors
# The root tools/extract_features.py and extract_features_ffhq.py against the
# port's, on configs/tiny.yaml with one VAE checkpoint (the JAX init through
# convert/from_jax, saved in the reference layout both loaders read) and the
# T5 directory above: the same files, the same keys; latents and caption
# features to 1e-5 of max|JAX|, masks and side info exactly.


def _run_jax_tool(name, argv, monkeypatch):
    import importlib.util
    import sys

    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [name] + list(argv))
    mod.main()


@pytest.fixture(scope="module")
def vae_ckpt(tmp_path_factory):
    from instarevive_tpu.config import load_config as jax_load_config
    from instarevive_tpu.pipelines.build import build_pipeline as jax_build_pipeline
    from instarevive_tpu.pipelines.build import init_params as jax_init_params
    from instarevive_tpu_torch.convert.from_jax import state_dicts_from_jax

    cfg = jax_load_config(TINY_PATH)
    sd = state_dicts_from_jax(jax_init_params(jax_build_pipeline(cfg), seed=3), cfg)["vae"]
    path = str(tmp_path_factory.mktemp("vae") / "vae.pth")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)
    return path


def _images(folder, sizes, seed=6):
    folder.mkdir()
    rng = np.random.default_rng(seed)
    for i, (h, w) in enumerate(sizes):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(folder / f"img{i}.png")


def _same_npz_dirs(port_dir, jax_dir):
    names = sorted(os.listdir(jax_dir))
    assert names and names == sorted(os.listdir(port_dir))
    for n in names:
        got, want = np.load(os.path.join(port_dir, n)), np.load(os.path.join(jax_dir, n))
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, (n, k)
            if k in ("latent", "caption_feature"):
                close(got[k], want[k])
            else:
                np.testing.assert_array_equal(got[k], want[k])
    return names


def test_extract_features_equals_jax(t5_dir, vae_ckpt, tmp_path, monkeypatch):
    from instarevive_tpu_torch.data.internal import InternalFeatureDataset
    from instarevive_tpu_torch.tools import extract_features

    _images(tmp_path / "imgs", [(80, 72), (64, 96), (72, 72)])
    caps = tmp_path / "caps.json"
    caps.write_text('{"img0.png": "a photo of a cat", "img2.png": "portrait of an old man"}')
    args = ["--input", str(tmp_path / "imgs"), "--config", TINY_PATH, "--vae_ckpt", vae_ckpt, "--t5_dir", t5_dir,
            "--captions", str(caps), "--size", "64", "--batch_size", "2", "--max_length", "16"]
    _run_jax_tool("extract_features", args + ["--output", str(tmp_path / "jax")], monkeypatch)
    counts = extract_features.main(args + ["--output", str(tmp_path / "port"), "--device", "cpu"])
    assert counts == {"latents": 3, "t5": 2}
    assert _same_npz_dirs(tmp_path / "port" / "vae_feat", tmp_path / "jax" / "vae_feat") == \
        ["img0.npz", "img1.npz", "img2.npz"]
    assert _same_npz_dirs(tmp_path / "port" / "t5_feat", tmp_path / "jax" / "t5_feat") == ["img0.npz", "img2.npz"]
    manifest = tmp_path / "manifest.json"
    manifest.write_text('[{"vae_feat": "port/vae_feat/img0.npz", "t5_feat": "port/t5_feat/img0.npz"}]')
    item = InternalFeatureDataset(str(manifest), root=str(tmp_path))[0]
    assert item["latent"].shape == (16, 16, 4) and item["txt_fea"].shape == (16, 64)
    assert item["attention_mask"].shape == (16,)


def test_extract_features_ffhq_equals_jax(t5_dir, vae_ckpt, tmp_path, monkeypatch):
    from instarevive_tpu_torch.tools import extract_features_ffhq, generate_data_info

    _images(tmp_path / "imgs", [(64, 64), (60, 120), (70, 66), (40, 200)])
    info = str(tmp_path / "data_info.json")
    generate_data_info.main(["--folders", str(tmp_path / "imgs"), "--output", info, "--prompt", "a red panda",
                             "--relative_to", str(tmp_path / "imgs"), "--device", "cpu"])
    args = ["--root", str(tmp_path / "imgs"), "--data_info", info, "--config", TINY_PATH, "--vae_ckpt", vae_ckpt,
            "--t5_dir", t5_dir, "--resolution", "256", "--batch_size", "2", "--max_length", "16"]
    _run_jax_tool("extract_features_ffhq", args + ["--output", str(tmp_path / "jax")], monkeypatch)
    counts = extract_features_ffhq.main(args + ["--output", str(tmp_path / "port"), "--device", "cpu"])
    assert counts["latents"] == 3 and counts["t5"] == 3  # 200/40 is above --max_ratio
    assert counts["buckets"] == {(128, 320): 1, (256, 256): 2}
    _same_npz_dirs(tmp_path / "port" / "vae_feat", tmp_path / "jax" / "vae_feat")
    _same_npz_dirs(tmp_path / "port" / "t5_feat", tmp_path / "jax" / "t5_feat")
