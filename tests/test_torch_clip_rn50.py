"""The port's CLIP RN50 towers and CLIP-IQA against the JAX package on the
CPU, at the tiny layout of ``tests/test_clip_rn50.py``'s fixture (layers
(1, 1, 1, 1), width 16, embed 32, image 64; text width 64, 2 layers, vocab
100, context 16), through both weight routes: ``convert/from_jax`` on the
flax towers' own random init, and the port's loader on a seeded OpenAI-layout
state dict (BatchNorms with running statistics, folded at import) that the
JAX importer reads too; the first route's trees are the importer's with
every value scaled by a seeded factor in [0.5, 1.5), so the two routes share
no weights. Bound 1e-5 of max|JAX| in f32 (measured ~1e-6)."""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test worker)

import jax

from instarevive_tpu.convert.torch_import import clip_rn50_params_from_torch
from instarevive_tpu.models.clip_rn50 import CLIPTextTower, ModifiedResNet, OpenAICLIP
from instarevive_tpu.utils.clipiqa import CLIPIQA as JaxCLIPIQA
from instarevive_tpu_torch.convert import from_jax
from instarevive_tpu_torch.models import clip_rn50
from instarevive_tpu_torch.tools import iqa_checkpoints
from instarevive_tpu_torch.utils.clipiqa import CLIPIQA

BOUND = 1e-5
TINY = dict(layers=(1, 1, 1, 1), width=16, embed_dim=32, image_size=64, text_width=64, text_layers=2,
            vocab_size=100, context_length=16)


def close(out, ref, bound=BOUND):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max() / np.abs(ref).max()
    assert err <= bound, err


@pytest.fixture(scope="module")
def towers():
    """{route: (port CLIP, JAX visual params, JAX text params, log logit
    scale)} and the JAX towers under "modules"."""
    sd = iqa_checkpoints.clip_rn50(0, **TINY)
    vis, txt, scale, meta = clip_rn50_params_from_torch(dict(sd))
    assert meta == clip_rn50.clip_meta(sd)
    jv = ModifiedResNet(layers=meta["layers"], output_dim=meta["embed_dim"], heads=meta["vision_heads"],
                        width=meta["vision_width"])
    jt = CLIPTextTower(width=meta["text_width"], layers=meta["text_layers"], heads=meta["text_heads"],
                       vocab_size=meta["vocab_size"], context_length=meta["context_length"],
                       embed_dim=meta["embed_dim"])
    out = {"modules": (jv, jt),
           "official": (clip_rn50.from_state_dict(clip_rn50.state_dict_from_torch(sd), "cpu", meta), vis, txt, scale)}
    rng = np.random.default_rng(1)
    vp, tp = (jax.tree_util.tree_map(lambda a: np.asarray(a) * rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32), t)
              for t in (vis, txt))
    out["from_jax"] = (clip_rn50.from_state_dict(from_jax.clip_rn50_params_to_torch(vp, tp, np.log(50.0)), "cpu", meta),
                       vp, tp, np.log(50.0))
    return out


@pytest.mark.parametrize("route", ["from_jax", "official"])
def test_image_tower_matches_jax(towers, route):
    net, vis, _, _ = towers[route]
    jv = towers["modules"][0]
    x = np.random.default_rng(2).normal(0, 1, (2, 3, 64, 64)).astype(np.float32)
    with torch.no_grad():
        out = net.get_image_features(torch.from_numpy(x)).numpy()
    close(out, jax.jit(jv.apply)({"params": vis}, x.transpose(0, 2, 3, 1)))


@pytest.mark.parametrize("route", ["from_jax", "official"])
def test_text_tower_matches_jax(towers, route):
    net, _, txt, _ = towers[route]
    jt = towers["modules"][1]
    ids = np.random.default_rng(3).integers(1, 90, (3, 16))
    ids[:, 9] = 99  # EOT = the largest id; pooling picks it
    with torch.no_grad():
        out = net.get_text_features(ids).numpy()
    close(out, jax.jit(jt.apply)({"params": txt}, ids.astype(np.int32)))


def test_loader_raises_on_missing_and_unused_keys():
    sd = iqa_checkpoints.clip_rn50(0, **TINY)
    with pytest.raises(KeyError, match="visual.layer2.0.downsample.1.running_var"):
        clip_rn50.state_dict_from_torch({k: v for k, v in sd.items() if k != "visual.layer2.0.downsample.1.running_var"})
    with pytest.raises(KeyError, match="did not use.*visual.proj"):
        clip_rn50.state_dict_from_torch(dict(sd, **{"visual.proj": torch.zeros(1)}))


def test_load_openai_clip_file(tmp_path):
    """A ``.pt`` state dict through ``load_openai_clip``, widths from its keys."""
    sd = iqa_checkpoints.clip_rn50(0, **TINY)
    torch.save(sd, tmp_path / "rn50.pt")
    net = clip_rn50.load_openai_clip(str(tmp_path / "rn50.pt"), "cpu")
    assert net.image_size == 64 and len(net.transformer.resblocks) == 2
    torch.testing.assert_close(net.logit_scale, sd["logit_scale"])


@pytest.mark.parametrize("route", ["from_jax", "official"])
def test_clipiqa_matches_jax(towers, route):
    """CLIP-IQA over each route's towers with a stub tokenizer (ids from
    the characters, EOT 99 after them): the preprocessing (PIL bicubic to
    64, clip, CLIP normalisation), the prompt embeddings and the softmax of
    logit_scale.exp() * cos."""
    net, vis, txt, scale = towers[route]
    jv, jt = towers["modules"]
    tok = iqa_checkpoints.StubTokenizer(vocab_size=100, length=12)
    ref = JaxCLIPIQA(model=OpenAICLIP(vis, txt, scale, visual=jv, text=jt, image_size=64), tokenizer=tok,
                     prompts=(("Good photo.", "Bad photo."), ("Sharp.", "Blurry.")))
    metric = CLIPIQA(model=net, tokenizer=tok, prompts=ref.prompts)
    imgs = np.random.default_rng(4).random((2, 80, 72, 3)).astype(np.float32)
    out, want = metric(imgs), ref(imgs)
    assert abs(metric.logit_scale - ref.logit_scale) <= 1e-4 and ((out > 0) & (out < 1)).all()
    np.testing.assert_allclose(out, want, rtol=0, atol=BOUND)


def test_clipiqa_names_transformers_when_absent(monkeypatch):
    """Without a handed-in tokenizer the metric needs ``transformers``, and
    says so where it is not installed."""
    monkeypatch.setitem(__import__("sys").modules, "transformers", None)
    sd = iqa_checkpoints.clip_rn50(0, **TINY)
    net = clip_rn50.from_state_dict(clip_rn50.state_dict_from_torch(sd), "cpu", clip_rn50.clip_meta(sd))
    with pytest.raises(ImportError, match="transformers"):
        CLIPIQA(model=net, tokenizer_dir="/nonexistent")
