"""The port's LPIPS, NIQE, MUSIQ and MANIQA against the JAX package on the
CPU, each network through both weight routes: ``convert/from_jax`` on the
JAX params, and the port's official-layout loader on a seeded torch state
dict (``tools/iqa_checkpoints``) that the JAX importer reads too.

Bounds, relative to max|JAX|: 1e-5 in f32 for LPIPS, MUSIQ and MANIQA on its
official-scale weights (summation order only; measured 1e-7 to 1e-6), and
NIQE's float64 features to 1e-6 (its half-scale image is an f32 resize in
both packages). MANIQA on the JAX package's own random init is compared in
float64 on both sides (1e-9): at those weights its channel attention's
logits reach the thousands and f32 rounding alone moves the score by 1e-2
(the port in f32 against itself in float64), so no f32 bound would test the
port there."""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test worker)

import jax
import jax.numpy as jnp

from instarevive_tpu.utils import maniqa as jax_maniqa
from instarevive_tpu.utils import musiq as jax_musiq
from instarevive_tpu.utils import niqe as jax_niqe
from instarevive_tpu.utils.metrics import LPIPS as JaxLPIPS
from instarevive_tpu_torch.convert import from_jax
from instarevive_tpu_torch.nn.layers import load_built
from instarevive_tpu_torch.tools import iqa_checkpoints
from instarevive_tpu_torch.utils import maniqa, musiq, niqe
from instarevive_tpu_torch.utils.metrics import LPIPS, lpips_state_dict

F32_BOUND = 1e-5


def close(out, ref, bound=F32_BOUND):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-12)
    assert err <= bound, (err, out, ref)


def tensors(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


@pytest.fixture(scope="module")
def musiq_sd():
    return iqa_checkpoints.musiq(1)


@pytest.fixture(scope="module")
def maniqa_sd():
    return iqa_checkpoints.maniqa(2)


@pytest.mark.parametrize("route", ["from_jax", "official"])
def test_lpips_matches_jax(route):
    alex, lins = iqa_checkpoints.lpips(0)
    params = JaxLPIPS.alexnet_feature_params_from_torch(alex, lins)
    net = LPIPS()
    if route == "from_jax":  # the JAX params scrambled so the route cannot pass by reading the same files
        rng = np.random.default_rng(1)
        params = {k: np.asarray(v) * rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32) for k, v in params.items()}
        net.load_state_dict(tensors(from_jax.lpips_params_to_torch(params)))
    else:
        net.load_state_dict(lpips_state_dict(alex, lins))
    rng = np.random.default_rng(2)
    a = rng.random((2, 64, 72, 3), np.float32) * 2 - 1
    b = np.clip(a + 0.3 * rng.standard_normal(a.shape).astype(np.float32), -1, 1)
    ref = JaxLPIPS(params)(jnp.asarray(a), jnp.asarray(b))
    with torch.no_grad():
        close(net(torch.from_numpy(a), torch.from_numpy(b)).numpy(), ref)
    assert (np.asarray(ref) > 0).all()


def test_lpips_loader_raises_on_missing_and_unused_keys():
    alex, lins = iqa_checkpoints.lpips(0, classifier=False)
    with pytest.raises(KeyError, match="lin4.model.1.weight"):
        lpips_state_dict(alex, {k: v for k, v in lins.items() if not k.startswith("lin4")})
    with pytest.raises(KeyError, match="did not use.*features.12.weight"):
        lpips_state_dict(dict(alex, **{"features.12.weight": torch.zeros(1)}), lins)


def test_niqe_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    pristine = [rng.random((200, 230)) * 255 for _ in range(2)]
    ref_model, model = jax_niqe.fit_pristine_model(pristine), niqe.fit_pristine_model(pristine)
    np.testing.assert_allclose(model.mu, ref_model.mu, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(model.cov, ref_model.cov, rtol=1e-6, atol=1e-6 * np.abs(ref_model.cov).max())
    path = str(tmp_path / "pris.npz")
    np.savez(path, mu_pris_param=ref_model.mu[None], cov_pris_param=ref_model.cov)
    loaded = niqe.load_pris_params(path)
    img = rng.random((150, 200, 3), np.float32)
    close(niqe.niqe(img, loaded), jax_niqe.niqe(img, jax_niqe.load_pris_params(path)), 1e-6)


@pytest.mark.parametrize("hw", [(100, 150), (700, 420)])
def test_musiq_prepare_matches_jax(hw):
    """The multi-scale patches, hash grid and masks (the native scale of the
    larger image fills more than its 512 slots and is cut)."""
    img = np.random.default_rng(4).random((*hw, 3), np.float32)
    for out, ref in zip(musiq.musiq_prepare(img), jax_musiq.musiq_prepare(img)):
        assert out.dtype == ref.dtype and out.shape == ref.shape
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("route", ["from_jax_npz", "official"])
def test_musiq_matches_jax(route, tmp_path, musiq_sd):
    if route == "official":
        params = jax_musiq.params_from_torch(dict(musiq_sd))
        net = musiq.MUSIQ.from_state_dict(musiq.state_dict_from_torch(musiq_sd), "cpu")
    else:  # the JAX package's own .npz, as --musiq_params takes it
        params = jax_musiq.init_random_params(0)
        jax_musiq.save_params_npz(str(tmp_path / "musiq.npz"), params)
        net = musiq.MUSIQ.from_state_dict(from_jax.musiq_params_to_torch(musiq.params_from_npz(str(tmp_path / "musiq.npz"))),
                                          "cpu")
    img = np.random.default_rng(5).random((100, 150, 3), np.float32)
    close(net.score(img), jax_musiq.MUSIQ(params)(img))


def test_musiq_loader_standardises_and_raises(musiq_sd):
    sd = musiq_sd
    w = musiq.state_dict_from_torch(sd)["conv_root.weight"]
    torch.testing.assert_close(w.mean(dim=(1, 2, 3)), torch.zeros(64), atol=1e-5, rtol=0)
    with pytest.raises(KeyError, match="head.bias"):
        musiq.state_dict_from_torch({k: v for k, v in sd.items() if k != "head.bias"})
    with pytest.raises(KeyError, match="did not use.*extra"):
        musiq.state_dict_from_torch(dict(sd, extra=torch.zeros(1)))


def test_maniqa_matches_jax_float64():
    """Route from_jax on the JAX package's random init, one 224x224 crop,
    float64 on both sides."""
    params = jax_maniqa.init_random_params(0)
    img = np.random.default_rng(6).random((1, 224, 224, 3))
    with jax.enable_x64():
        ref = jax.jit(jax_maniqa.maniqa_forward)({k: jnp.asarray(np.asarray(v), jnp.float64) for k, v in params.items()},
                                                 jnp.asarray(img))
        ref = np.asarray(ref)
    net = load_built(maniqa.MANIQA, from_jax.maniqa_params_to_torch(params), "cpu").double()
    with torch.no_grad():
        close(net(torch.from_numpy(img)).numpy(), ref, 1e-9)


def test_maniqa_official_matches_jax_with_crops(maniqa_sd):
    """Route official on a 240x260 image with two crops drawn from the seed
    (the same draws as the JAX package's), in f32."""
    sd = maniqa_sd
    ref = jax_maniqa.MANIQA(jax_maniqa.params_from_torch(dict(sd)), num_crops=2, seed=3)
    net = load_built(lambda: maniqa.MANIQA(num_crops=2, seed=3), maniqa.state_dict_from_torch(sd), "cpu")
    img = np.random.default_rng(7).random((1, 240, 260, 3), np.float32)
    close(net.score(img), ref(img))


def test_maniqa_loader_raises(maniqa_sd):
    sd = maniqa_sd
    with pytest.raises(KeyError, match="fc_weight.3.bias"):
        maniqa.state_dict_from_torch({k: v for k, v in sd.items() if k != "fc_weight.3.bias"})
    with pytest.raises(KeyError, match="did not use.*tablock3"):
        maniqa.state_dict_from_torch(dict(sd, **{"tablock3.0.c_q.weight": torch.zeros(1)}))
