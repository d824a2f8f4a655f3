"""The port's depth estimators (``models/dpt.py``) against the JAX package on
the CPU: DPT (hybrid and plain ViT) at tiny widths, MiDaS v2.1 at its real
stage widths with one block a stage, v2.1-small at full depth and width,
each through both weight routes (the JAX params through
``convert/from_jax``; a seeded state dict in the official layout through the
port's loader and the JAX importer), ``midas_transform_size``,
``MiDaSInference`` and its ``depth_fn`` into the depth2image conditioning.
JAX runs eagerly (``apply`` unjitted). Bound: f32, 1e-4 of max|JAX| for the
networks (tens of convolutions and, for DPT, the pos-embed resize) and for
the conditioning, which is the depth rescaled to [-1, 1]."""

import dataclasses

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test worker)

import jax
import jax.numpy as jnp

from instarevive_tpu.convert import torch_import
from instarevive_tpu.models import dpt as jax_dpt
from instarevive_tpu.train.ldm_tasks import LatentDiffusionTask as JaxLDM
from instarevive_tpu_torch.convert import from_jax
from instarevive_tpu_torch.models import dpt
from instarevive_tpu_torch.tools import official_layouts
from instarevive_tpu_torch.train.ldm_tasks import LatentDiffusionTask

TINY = {
    "hybrid": dict(vit_dim=48, vit_depth=4, vit_heads=4, hooks=(0, 1, 2, 3), layer_chs=(16, 32, 40, 48),
                   features=16, hybrid=True, rn_layers=(1, 1, 1), rn_stem_chs=8, rn_base_chs=16, gn_groups=4,
                   pos_grid=4),
    "vit": dict(vit_dim=48, vit_depth=4, vit_heads=4, hooks=(0, 1, 2, 3), layer_chs=(16, 24, 32, 40), features=16,
                hybrid=False, pos_grid=4),
}
V21 = dict(features=64, layers=(1, 1, 1, 1))


def close(out, ref, rel=1e-4):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0, atol=rel * max(1.0, float(np.abs(ref).max())))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _port(model, sd):
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    return model.eval()


def _run(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("name,size", [("hybrid", 64), ("vit", 96)])
def test_dpt_from_jax_matches_jax(name, size):
    """At 96 x 96 a 6 x 6 grid against the stored 4 x 4: the pos-embed resize runs."""
    jcfg = jax_dpt.DPTConfig(**TINY[name])
    x = _x((2, size, size, 3), 7)
    params = jax_dpt.DPTDepthModel(jcfg).init(jax.random.key(1), jnp.asarray(x))["params"]
    want = np.asarray(jax_dpt.DPTDepthModel(jcfg).apply({"params": params}, jnp.asarray(x)))
    model = _port(dpt.DPTDepthModel(dpt.DPTConfig(**TINY[name])), from_jax.dpt_params_to_torch(params, jcfg))
    got = _run(model, x)
    assert got.shape == want.shape == (2, size, size)
    close(got, want)


@pytest.mark.parametrize("name", ["hybrid", "vit"])
def test_dpt_official_layout_matches_jax(name):
    """A seeded official state dict (raw hybrid convolutions, the ViT's
    unused norm and head, refinenet4's unused unit) through the port's
    loader and through ``dpt_params_from_torch``; 64 x 64, the stored grid."""
    cfg = dpt.DPTConfig(**TINY[name])
    model = dpt.DPTDepthModel(cfg)
    sd = official_layouts.midas(model, seed=3)
    jcfg = jax_dpt.DPTConfig(**TINY[name])
    x = _x((1, 64, 64, 3), 11)
    want = np.asarray(jax_dpt.DPTDepthModel(jcfg).apply(
        {"params": torch_import.dpt_params_from_torch(sd, jcfg)}, jnp.asarray(x)))
    close(_run(dpt.load_official(model, sd).eval(), x), want)


def test_midas_v21_matches_jax():
    """ResNeXt101-32x8d at its real widths (256 ... 2048), one block a
    stage: the official route (BatchNorms folded at eps 1e-5) and from_jax."""
    model = dpt.MidasNet(**V21)
    sd = official_layouts.midas(model, seed=5)
    x = _x((1, 64, 64, 3), 13)
    jmodel = jax_dpt.MidasNet(**V21)
    params = torch_import.midas_v21_params_from_torch(sd, layers=V21["layers"])
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    got = _run(dpt.load_official(model, sd).eval(), x)
    assert got.shape == want.shape == (1, 64, 64)
    close(got, want)
    again = _port(dpt.MidasNet(**V21), from_jax.midas_v21_params_to_torch(params, layers=V21["layers"]))
    close(_run(again, x), want)


def test_midas_v21_small_matches_jax():
    """EfficientNet-lite3 at full depth and width (TF-SAME strided
    depthwise convolutions, BatchNorms folded at eps 1e-3), both routes."""
    model = dpt.MidasNetSmall()
    sd = official_layouts.midas(model, seed=7)
    x = _x((1, 96, 96, 3), 17)
    params = torch_import.midas_v21_small_params_from_torch(sd)
    want = np.asarray(jax_dpt.MidasNetSmall().apply({"params": params}, jnp.asarray(x)))
    got = _run(dpt.load_official(model, sd).eval(), x)
    assert got.shape == want.shape == (1, 96, 96)
    close(got, want)
    close(_run(_port(dpt.MidasNetSmall(), from_jax.midas_v21_small_params_to_torch(params)), x), want)


def test_official_loader_refuses_a_missing_key():
    model = dpt.MidasNetSmall()
    sd = official_layouts.midas(model, seed=1)
    del sd["scratch.layer2_rn.weight"]
    with pytest.raises(KeyError, match="layer2_rn"):
        dpt.load_official(model, sd)


@pytest.mark.parametrize("method", ["minimal", "lower_bound", "upper_bound"])
def test_midas_transform_size_matches_jax(method):
    for h, w in [(480, 640), (512, 512), (300, 1000), (1080, 720), (97, 131)]:
        for net in (256, 384):
            assert dpt.midas_transform_size(h, w, net, 32, method) == \
                jax_dpt.midas_transform_size(h, w, net, 32, method)


def test_build_midas_matches_jax():
    for model_type, backbone in dpt.DPT_TYPES.items():
        assert dataclasses.asdict(dpt.VARIANTS[backbone]) == dataclasses.asdict(jax_dpt.VARIANTS[backbone])
        with torch.device("meta"):
            assert dpt.build_midas(model_type).cfg == dpt.VARIANTS[backbone]
    with torch.device("meta"):
        assert isinstance(dpt.build_midas("midas_v21"), dpt.MidasNet)
        assert isinstance(dpt.build_midas("midas_v21_small"), dpt.MidasNetSmall)
    with pytest.raises(ValueError, match="model_type"):
        dpt.build_midas("midas_v3")


def test_midas_inference_and_depth_fn_match_jax():
    """MiDaSInference (aspect-keeping bicubic resize to 96, the DPT
    normalisation, the net, bicubic back) and ``depth_fn`` into the
    depth2image conditioning of both packages."""
    jcfg = jax_dpt.DPTConfig(**TINY["vit"])
    x01 = np.random.default_rng(0).uniform(size=(2, 80, 120, 3)).astype(np.float32)
    jmodel = jax_dpt.DPTDepthModel(jcfg)
    params = jmodel.init(jax.random.key(5), jnp.zeros((1, 64, 64, 3)))["params"]
    jmidas = jax_dpt.MiDaSInference(jmodel, params, "dpt_hybrid", net_size=96)
    midas = dpt.MiDaSInference(_port(dpt.DPTDepthModel(dpt.DPTConfig(**TINY["vit"])),
                                     from_jax.dpt_params_to_torch(params, jcfg)), "dpt_hybrid", net_size=96)
    want = np.asarray(jmidas(jnp.asarray(x01)))
    got = midas(torch.from_numpy(x01)).numpy()
    assert got.shape == want.shape == (2, 80, 120, 1)
    close(got, want)

    hq = x01 * 2.0 - 1.0
    depth = midas.depth_fn()(torch.from_numpy(hq).requires_grad_(True))
    assert not depth.requires_grad  # a frozen estimator

    class _Vae:
        ch_mult = (1, 2, 4, 4)

    jcond = JaxLDM(None, _Vae(), None).depth_conditioning(jmidas.depth_fn()(jnp.asarray(hq)), (10, 15))
    cond = LatentDiffusionTask.depth_conditioning(depth, (10, 15))
    close(cond.numpy(), jcond)


def test_midas_small_inference_settings_match_jax():
    model = dpt.MidasNetSmall()
    jm = jax_dpt.MiDaSInference(jax_dpt.MidasNetSmall(), {}, model_type="midas_v21_small")
    pm = dpt.MiDaSInference(model, model_type="midas_v21_small")
    assert (pm.net_size, pm.method) == (jm.net_size, jm.method) == (256, "upper_bound")
    np.testing.assert_array_equal(pm._mean.numpy(), np.asarray(jm._mean))
    np.testing.assert_array_equal(pm._std.numpy(), np.asarray(jm._std))
