"""The port's degradation synthesis (instarevive_tpu_torch/ops/{degradation,
resize,diffjpeg,color}.py, data/{realesrgan,codeformer}.py) against the JAX
package on the CPU. ``jax.random`` and ``torch.Generator`` give different
numbers from one seed, so every comparison makes the JAX package's draws
itself, from the same key splits as the JAX code, and hands them to the port
through its ``draws`` arguments; the port's own drawing is tested for ranges
and repeatability."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from instarevive_tpu.data import codeformer as jax_codeformer
from instarevive_tpu.data import realesrgan as jax_realesrgan
from instarevive_tpu.ops import color as jax_color
from instarevive_tpu.ops import degradation as jax_deg
from instarevive_tpu.ops import diffjpeg as jax_jpeg
from instarevive_tpu.ops import resize as jax_resize
from instarevive_tpu_torch.data import codeformer, realesrgan
from instarevive_tpu_torch.ops import color, degradation as deg, diffjpeg, resize


def _t(x):
    return torch.from_numpy(np.array(x))


def _err(got, want):
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())


# ---------------------------------------------------------------------------
# kernels


def test_bessel_j1_matches_jax():
    x = np.concatenate([np.linspace(-30, 30, 2001), [0.0, 1e-12, 7.999, 8.0, 8.001, -8.0]]).astype(np.float32)
    assert _err(deg.bessel_j1(_t(x)), jax_deg.bessel_j1(jnp.asarray(x))) <= 1e-6


FAMILIES = {
    "gaussian_iso": ("bivariate_gaussian", dict(sig_x=1.7, sig_y=0.9, theta=0.6, isotropic=True)),
    "gaussian_aniso": ("bivariate_gaussian", dict(sig_x=2.3, sig_y=0.7, theta=-1.1, isotropic=False)),
    "generalized_iso": ("bivariate_generalized_gaussian", dict(sig_x=1.2, sig_y=2.0, theta=0.3, beta=0.7, isotropic=True)),
    "generalized_aniso": ("bivariate_generalized_gaussian", dict(sig_x=0.5, sig_y=2.8, theta=2.5, beta=3.1, isotropic=False)),
    "plateau_iso": ("bivariate_plateau", dict(sig_x=2.9, sig_y=1.0, theta=0.0, beta=1.4, isotropic=True)),
    "plateau_aniso": ("bivariate_plateau", dict(sig_x=1.1, sig_y=2.2, theta=-2.0, beta=1.9, isotropic=False)),
}


@pytest.mark.parametrize("active", [None, 7, 21])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_kernel_family_matches_jax(name, active):
    fn, kw = FAMILIES[name]
    want = getattr(jax_deg, fn)(21, active_size=active, **kw)
    got = getattr(deg, fn)(21, active_size=active, **kw)
    assert got.shape == (21, 21) and _err(got, want) <= 1e-6
    # a batch of parameters gives the batch of kernels
    batched = getattr(deg, fn)(21, active_size=active, **{k: (torch.tensor([v, v]) if isinstance(v, float) else v)
                                                          for k, v in kw.items()})
    assert batched.shape == (2, 21, 21) and _err(batched[1], want) <= 1e-6


@pytest.mark.parametrize("cutoff,size,active", [(math.pi / 3, 21, 13), (2.9, 21, None), (0.7, 41, 41)])
def test_sinc_and_pulse_kernels_match_jax(cutoff, size, active):
    want = jax_deg.circular_lowpass_kernel(cutoff, size, active_size=active)
    assert _err(deg.circular_lowpass_kernel(cutoff, size, active_size=active), want) <= 1e-6
    assert np.array_equal(deg.pulse_kernel(size).numpy(), np.asarray(jax_deg.pulse_kernel(size)))


def _jax_mixed_draws(key, cfg):
    """The draws of ``random_mixed_kernel`` for one sample, split as it splits."""
    keys = jax.random.split(key, 6)
    probs = jnp.zeros((len(jax_deg.KERNEL_TYPES),))
    for name, p in zip(cfg.kernel_list, cfg.kernel_prob):
        probs = probs.at[jax_deg.KERNEL_TYPES.index(name)].set(p)
    return dict(
        ktype=jax.random.choice(keys[0], len(jax_deg.KERNEL_TYPES), p=probs / probs.sum()),
        sx=jax.random.uniform(keys[1], minval=cfg.blur_sigma[0], maxval=cfg.blur_sigma[1]),
        sy=jax.random.uniform(keys[2], minval=cfg.blur_sigma[0], maxval=cfg.blur_sigma[1]),
        theta=jax.random.uniform(keys[3], minval=cfg.rotation_range[0], maxval=cfg.rotation_range[1]),
        betag=jax_deg._sample_beta(keys[4], *cfg.betag_range), betap=jax_deg._sample_beta(keys[5], *cfg.betap_range))


def _mixed(d):
    return deg.MixedKernelDraws(**{k: _t(v) for k, v in d.items()})


def _jax_stage_draws(key, cfg):
    k_sz, k_sinc, k_cut, k_mix = jax.random.split(key, 4)
    sizes = jnp.asarray(cfg.kernel_range, dtype=jnp.int32)
    size = sizes[jax.random.randint(k_sz, (), 0, len(sizes))]
    lo = jnp.where(size < 13, jnp.pi / 3.0, jnp.pi / 5.0)
    return dict(size=size, cutoff=jax.random.uniform(k_cut, minval=0.0, maxval=1.0) * (jnp.pi - lo) + lo,
                use_sinc=jax.random.uniform(k_sinc) < cfg.sinc_prob, mixed=_jax_mixed_draws(k_mix, cfg))


def _jax_final_draws(key, cfg, prob):
    k_sz, k_p, k_cut = jax.random.split(key, 3)
    sizes = jnp.asarray(cfg.kernel_range, dtype=jnp.int32)
    return dict(size=sizes[jax.random.randint(k_sz, (), 0, len(sizes))],
                cutoff=jax.random.uniform(k_cut, minval=jnp.pi / 3.0, maxval=jnp.pi),
                use_sinc=jax.random.uniform(k_p) < prob)


@pytest.mark.parametrize("sinc_prob", [0.1, 0.6])
def test_kernel_samplers_with_the_jax_draws_match_jax(sinc_prob):
    jcfg, tcfg = jax_deg.KernelConfig(sinc_prob=sinc_prob), deg.KernelConfig(sinc_prob=sinc_prob)
    keys = jax.random.split(jax.random.key(5), 24)
    d = jax.vmap(lambda k: _jax_stage_draws(k, jcfg))(keys)
    want = jax.vmap(lambda k: jax_deg.sample_stage_kernel(k, jcfg))(keys)
    draws = deg.StageKernelDraws(size=_t(d["size"]).long(), cutoff=_t(d["cutoff"]), use_sinc=_t(d["use_sinc"]),
                                 mixed=_mixed(d["mixed"]))
    got = deg.sample_stage_kernel(draws, tcfg)
    assert got.shape == (24, 21, 21) and _err(got, want) <= 1e-6
    assert 0 < int(draws.use_sinc.sum()) < 24 or sinc_prob == 0.1  # both branches at the larger probability
    assert len(set(draws.mixed.ktype.tolist())) >= 4  # several families

    want = jax.vmap(lambda k: jax_deg.random_mixed_kernel(k, jcfg, 13))(keys)
    assert _err(deg.random_mixed_kernel(_mixed(jax.vmap(lambda k: _jax_mixed_draws(k, jcfg))(keys)), tcfg, 13), want) <= 1e-6

    f = jax.vmap(lambda k: _jax_final_draws(k, jcfg, 0.8))(keys)
    want = jax.vmap(lambda k: jax_deg.sample_final_sinc_kernel(k, jcfg, 0.8))(keys)
    got = deg.sample_final_sinc_kernel(deg.FinalSincDraws(size=_t(f["size"]).long(), cutoff=_t(f["cutoff"]),
                                                          use_sinc=_t(f["use_sinc"])), tcfg)
    assert _err(got, want) <= 1e-6


def test_own_kernel_draws_are_in_range_and_repeat():
    cfg = realesrgan.RealESRGANDegradationConfig()
    a = realesrgan.draw_batch_kernels(torch.Generator().manual_seed(3), cfg, 64)
    b = realesrgan.draw_batch_kernels(torch.Generator().manual_seed(3), cfg, 64)
    c = realesrgan.draw_batch_kernels(torch.Generator().manual_seed(4), cfg, 64)
    assert torch.equal(a[0].cutoff, b[0].cutoff) and not torch.equal(a[0].cutoff, c[0].cutoff)
    stage, _, final = a
    assert set(stage.size.tolist()) <= set(cfg.kernel1.kernel_range) and len(set(stage.size.tolist())) > 3
    lo = torch.where(stage.size < 13, math.pi / 3, math.pi / 5)
    assert bool(((stage.cutoff >= lo) & (stage.cutoff <= math.pi)).all())
    m = stage.mixed
    assert bool(((m.sx >= 0.2) & (m.sx <= 3.0) & (m.theta >= -math.pi) & (m.theta <= math.pi)).all())
    assert bool(((m.betag >= 0.5) & (m.betag <= 4.0) & (m.betap >= 1.0) & (m.betap <= 2.0)).all())
    assert 0.6 < float(final.use_sinc.float().mean()) < 0.95 and float(stage.use_sinc.float().mean()) < 0.3
    k1, k2, sinc = realesrgan.sample_batch_kernels(a, cfg)
    for k in (k1, k2, sinc):
        assert k.shape == (64, 21, 21) and _err(k.sum(dim=(1, 2)), np.ones(64)) <= 1e-4


# ---------------------------------------------------------------------------
# resizing

SCALE_CASES = {  # (in hw, out hw, scale (h, w), translation)
    "down_fractional": ((40, 56), (48, 48), (0.3137, 0.41), (0.0, 0.0)),
    "up_fractional": ((24, 32), (64, 64), (1.37, 1.2), (0.0, 0.0)),
    "canvas_partly_empty": ((64, 64), (96, 96), (0.55, 0.55), (0.0, 0.0)),
    "translated": ((32, 32), (40, 40), (0.8, 1.1), (1.5, -2.25)),
    "identity": ((16, 20), (16, 20), (1.0, 1.0), (0.0, 0.0)),
}


@pytest.mark.parametrize("method", ["linear", "cubic"])
@pytest.mark.parametrize("name", list(SCALE_CASES))
def test_scale_and_translate_matches_jax(name, method):
    in_hw, out_hw, scale, translation = SCALE_CASES[name]
    x = np.random.default_rng(len(name)).random((2, *in_hw, 3), dtype=np.float32)
    for antialias in (True, False):
        want = jax.image.scale_and_translate(jnp.asarray(x), (2, *out_hw, 3), (1, 2), jnp.asarray(scale, jnp.float32),
                                             jnp.asarray(translation, jnp.float32), method=method, antialias=antialias)
        got = resize.scale_and_translate(_t(x), out_hw, scale, translation, method=method, antialias=antialias)
        assert got.shape == (2, *out_hw, 3) and got.is_contiguous() and _err(got, want) <= 1e-5, antialias


def test_resize_traced_matches_jax():
    x = np.random.default_rng(0).random((2, 96, 96, 3), dtype=np.float32)
    for mode in (0, 1, 2):
        src, dst = (64.0, 64.0), (np.float32(0.4021) * np.float32(64), np.float32(0.4021) * np.float32(64))
        want = jax_realesrgan._resize_traced(jnp.asarray(x), (48, 48), src, (jnp.float32(dst[0]), jnp.float32(dst[1])),
                                             jnp.asarray(mode))
        assert _err(realesrgan._resize_traced(_t(x), (48, 48), src, dst, mode), want) <= 1e-5


INTERPOLATE_CASES = {
    "nearest_up_integer": dict(out_hw=(48, 64), mode="nearest"),
    "nearest_ragged": dict(out_hw=(17, 45), mode="nearest"),
    "bilinear_up": dict(out_hw=(40, 50), mode="bilinear"),
    "bilinear_down": dict(out_hw=(11, 13), mode="bilinear"),
    "bilinear_down_antialias": dict(out_hw=(11, 13), mode="bilinear", antialias=True),
    "bilinear_align_corners": dict(out_hw=(40, 50), mode="bilinear", align_corners=True),
    "bicubic_up": dict(out_hw=(40, 50), mode="bicubic"),
    "bicubic_down": dict(out_hw=(10, 19), mode="bicubic"),
    "bicubic_down_antialias": dict(out_hw=(10, 19), mode="bicubic", antialias=True),
    "bicubic_align_corners": dict(out_hw=(31, 47), mode="bicubic", align_corners=True),
    "area_integer": dict(out_hw=(12, 16), mode="area"),
    "area_ragged": dict(out_hw=(10, 19), mode="area"),
    "scale_factor": dict(scale_factor=1.5, mode="bilinear"),
    "same_size": dict(out_hw=(24, 32), mode="bicubic"),
}


@pytest.mark.parametrize("name", list(INTERPOLATE_CASES))
def test_interpolate_matches_jax(name):
    kw = INTERPOLATE_CASES[name]
    x = np.random.default_rng(1).random((2, 24, 32, 3), dtype=np.float32)
    if name == "area_integer":
        # the JAX package's integer-factor branch of 'area' raises on its default (negative) axes
        # (its moveaxis pair misplaces W); torch's own area mode, whose semantics both follow, stands in
        want = torch.nn.functional.interpolate(_t(x).permute(0, 3, 1, 2), size=kw["out_hw"], mode="area").permute(0, 2, 3, 1)
    else:
        want = jax_resize.interpolate(jnp.asarray(x), **kw)
    got = resize.interpolate(_t(x), **kw)
    assert tuple(got.shape) == tuple(want.shape) and _err(got, want) <= 1e-5
    nchw = resize.interpolate(_t(x).permute(0, 3, 1, 2), spatial_axes=(-2, -1), **kw)
    assert _err(nchw.permute(0, 2, 3, 1), want) <= 1e-5


def test_interpolate_refusals_and_bf16():
    x = torch.rand(1, 8, 8, 3)
    with pytest.raises(ValueError):
        resize.interpolate(x, (4, 4), mode="nearest", align_corners=True)
    with pytest.raises(ValueError):
        resize.interpolate(x, (4, 4), mode="bilinear", align_corners=True, antialias=True)
    with pytest.raises(ValueError):
        resize.interpolate(x, mode="bilinear")
    assert resize.interpolate(x.bfloat16(), (12, 12), mode="bicubic").dtype == torch.bfloat16


@pytest.mark.parametrize("out_hw", [(17, 23), (64, 80), (40, 40)])
def test_matlab_and_pil_resize_match_jax(out_hw):
    x = np.random.default_rng(2).random((2, 40, 52, 3), dtype=np.float32)
    assert _err(resize.imresize_matlab(_t(x), out_hw), jax_resize.imresize_matlab(jnp.asarray(x), out_hw)) <= 1e-5
    assert _err(resize.pil_resize_bicubic(_t(x), out_hw), jax_resize.pil_resize_bicubic(jnp.asarray(x), out_hw)) <= 1e-5
    assert _err(resize.imresize_matlab(_t(x), out_hw, kernel="linear", antialias=False),
                jax_resize.imresize_matlab(jnp.asarray(x), out_hw, kernel="linear", antialias=False)) <= 1e-5
    for mode in ("bicubic", "matlab_bicubic", "bilinear"):
        assert _err(resize.resize_by_scale(_t(x), 0.6, mode=mode), jax_resize.resize_by_scale(jnp.asarray(x), 0.6, mode=mode)) <= 1e-5


# ---------------------------------------------------------------------------
# noise, colour, JPEG


def _image(shape, seed=0):
    """A smooth image with texture, on 8-bit levels."""
    rng = np.random.default_rng(seed)
    b, h, w, c = shape
    base = np.linspace(0, 1, h, dtype=np.float32)[None, :, None, None] * rng.random((b, 1, 1, c), dtype=np.float32) \
        + np.linspace(0, 1, w, dtype=np.float32)[None, None, :, None] * rng.random((b, 1, 1, c), dtype=np.float32)
    img = np.clip(base / 2 + 0.3 * rng.random(shape, dtype=np.float32), 0, 1)
    return (np.round(img * 255) / 255).astype(np.float32)


def test_gaussian_noise_with_the_jax_fields_matches_jax():
    img = _image((3, 32, 48, 3))
    key = jax.random.key(2)
    kc, kg = jax.random.split(key)
    sigma, gray = np.array([3.0, 25.0, 11.0], np.float32), np.array([0.0, 1.0, 0.0], np.float32)
    want = jax_deg.generate_gaussian_noise(key, jnp.asarray(img), jnp.asarray(sigma), jnp.asarray(gray))
    fields = (_t(jax.random.normal(kc, img.shape, dtype=jnp.float32)), _t(jax.random.normal(kg, (3, 32, 48, 1), dtype=jnp.float32)))
    got = deg.generate_gaussian_noise(None, _t(img), _t(sigma), _t(gray), fields)
    assert _err(got, want) <= 1e-6
    assert float(got[1].std(dim=-1).max()) == 0.0 and float(got[0].std(dim=-1).min()) > 0.0  # gray noise is one field


def test_poisson_noise_with_the_jax_draws_matches_jax():
    img = _image((3, 32, 48, 3), seed=1)
    img[2] = np.round(img[2] * 15) / 15  # few levels: another power of two
    key = jax.random.key(3)
    scale, gray = np.array([0.5, 2.0, 1.0], np.float32), np.array([1.0, 0.0, 0.0], np.float32)
    want = jax_deg.generate_poisson_noise(key, jnp.asarray(img), jnp.asarray(scale), jnp.asarray(gray))
    got = deg.generate_poisson_noise(None, _t(img), _t(scale), _t(gray),
                                     draw=lambda lam: _t(jax.random.poisson(key, jnp.asarray(lam.numpy())).astype(jnp.float32)))
    assert _err(got, want) <= 1e-6
    counts = deg._count_unique_vals(_t(img))
    assert np.array_equal(counts.numpy(), np.asarray(jax_deg._count_unique_vals(jnp.asarray(img))))
    assert counts[2] == 16 and counts[0] == 256


def test_own_noise_draws_have_the_right_moments():
    img = torch.full((2, 64, 64, 3), 0.5)
    gens = deg.make_generators(0, "cpu")
    noise = deg.generate_gaussian_noise(gens.device, img, torch.tensor([10.0, 20.0]), torch.zeros(2))
    assert abs(float(noise[0].std()) - 10 / 255) < 2e-3 and abs(float(noise[1].std()) - 20 / 255) < 3e-3
    shot = deg.generate_poisson_noise(gens.device, img, torch.ones(2), torch.zeros(2))
    # 0.5 quantises to 128 / 255: one level, so the rate is 128 / 255 * 1 and the draw's variance equals it
    assert abs(float(shot.mean())) < 1e-2 and abs(float(shot.var()) - 128 / 255) < 3e-2
    for fn, rng in ((deg.random_add_gaussian_noise, (1.0, 30.0)), (deg.random_add_poisson_noise, (0.05, 3.0))):
        out = fn(deg.make_generators(1, "cpu"), img, rng, 0.4)
        again = fn(deg.make_generators(1, "cpu"), img, rng, 0.4)
        assert torch.equal(out, again) and float(out.min()) >= 0 and float(out.max()) <= 1 and not torch.equal(out, img)


def test_jpeg_colour_transforms_match_jax():
    x = np.random.default_rng(0).random((2, 8, 8, 3), dtype=np.float32) * 255
    assert _err(color.rgb_to_ycbcr(_t(x)), jax_color.rgb_to_ycbcr(jnp.asarray(x))) <= 1e-4
    assert _err(color.ycbcr_to_rgb(_t(x)), jax_color.ycbcr_to_rgb(jnp.asarray(x))) <= 1e-4
    q = np.array([1.0, 30.0, 49.9, 50.0, 95.0, 100.0], np.float32)
    assert _err(diffjpeg.quality_to_factor(_t(q)), jax_jpeg.quality_to_factor(jnp.asarray(q))) <= 1e-6


@pytest.mark.parametrize("differentiable", [False, True])
def test_jpeg_round_trip_matches_jax(differentiable):
    """A coefficient that sits on a rounding boundary may round the other way
    in the two packages and move its 8x8 block by one quantisation step: at
    least 99.9% of pixels agree to 1e-4 and none differs by more than such a
    flip (the largest step, 121 * 1.67 at quality 30, times the largest
    basis value 1/4, over 255: 0.2)."""
    img = _image((3, 64, 96, 3), seed=4)
    quality = np.array([30.0, 62.5, 95.0], np.float32)
    want = np.asarray(jax_jpeg.jpeg_compress_decompress(jnp.asarray(img), jnp.asarray(quality), differentiable=differentiable))
    got = diffjpeg.jpeg_compress_decompress(_t(img), _t(quality), differentiable=differentiable).numpy()
    diff = np.abs(got - want)
    assert got.shape == img.shape and (diff <= 1e-4).mean() >= 0.999 and diff.max() <= 0.2, ((diff <= 1e-4).mean(), diff.max())
    assert np.abs(got - img).mean() > 1e-3  # it did compress
    one = diffjpeg.jpeg_compress_decompress(_t(img), 50.0, differentiable=differentiable)  # a scalar quality
    assert _err(one, jax_jpeg.jpeg_compress_decompress(jnp.asarray(img), 50.0, differentiable=differentiable)) <= 0.2
    with pytest.raises(ValueError):
        diffjpeg.jpeg_compress_decompress(torch.rand(1, 24, 32, 3), 50.0)


def test_differentiable_jpeg_passes_a_gradient():
    img = _t(_image((1, 32, 32, 3), seed=5)).requires_grad_(True)
    diffjpeg.jpeg_compress_decompress(img, 70.0, differentiable=True).sum().backward()
    assert torch.isfinite(img.grad).all() and float(img.grad.abs().sum()) > 0


# ---------------------------------------------------------------------------
# the two programs as a whole


def _jax_noise_draws(key, shape, g_prob, sigma_range, poisson_range, gray_prob):
    """The draws of ``_add_random_noise`` on a canvas of ``shape``, split as it splits."""
    kp, ks, ks2, kg, kn1, kn2 = jax.random.split(key, 6)
    b = shape[0]
    kc, kgray = jax.random.split(kn1)
    return realesrgan.NoiseDraws(
        use_g=bool(jax.random.uniform(kp) < g_prob),
        sigma=_t(jax.random.uniform(ks, (b,), minval=sigma_range[0], maxval=sigma_range[1])),
        pscale=_t(jax.random.uniform(ks2, (b,), minval=poisson_range[0], maxval=poisson_range[1])),
        gray=_t((jax.random.uniform(kg, (b,)) < gray_prob).astype(jnp.float32)),
        fields=(_t(jax.random.normal(kc, shape, dtype=jnp.float32)),
                _t(jax.random.normal(kgray, shape[:3] + (1,), dtype=jnp.float32))),
        poisson=lambda lam: _t(jax.random.poisson(kn2, jnp.asarray(lam.numpy())).astype(jnp.float32)))


def _jax_degrade_draws(key, cfg, b, h, w):
    """Every draw of the JAX ``degrade_batch`` for this key, and its kernels."""
    keys = jax.random.split(key, 12)
    c1 = (jax_realesrgan._round16(h * cfg.resize_range[1]), jax_realesrgan._round16(w * cfg.resize_range[1]))
    c2 = (jax_realesrgan._round16(h / cfg.stage2_scale * cfg.resize_range2[1]),
          jax_realesrgan._round16(w / cfg.stage2_scale * cfg.resize_range2[1]))
    draws = realesrgan.DegradeDraws(
        kernels=None,
        s1=float(jax_realesrgan._rand_scale(keys[1], cfg.resize_prob, cfg.resize_range)),
        mode1=int(jax.random.randint(keys[2], (), 0, 3)),
        noise1=_jax_noise_draws(keys[3], (b, *c1, 3), cfg.gaussian_noise_prob, cfg.noise_range,
                                cfg.poisson_scale_range, cfg.gray_noise_prob),
        q1=_t(jax.random.uniform(keys[4], (b,), minval=cfg.jpeg_range[0], maxval=cfg.jpeg_range[1])),
        blur2=bool(jax.random.uniform(keys[5]) < cfg.second_blur_prob), stage2_scale=float(cfg.stage2_scale),
        s2=float(jax_realesrgan._rand_scale(keys[7], cfg.resize_prob2, cfg.resize_range2)),
        mode2=int(jax.random.randint(keys[8], (), 0, 3)),
        noise2=_jax_noise_draws(keys[9], (b, *c2, 3), cfg.gaussian_noise_prob2, cfg.noise_range2,
                                cfg.poisson_scale_range2, cfg.gray_noise_prob2),
        q2=_t(jax.random.uniform(keys[10], (b,), minval=cfg.jpeg_range2[0], maxval=cfg.jpeg_range2[1])),
        mode3=int(jax.random.randint(keys[11], (), 0, 3)), use_a=bool(jax.random.uniform(keys[0]) < 0.5))
    kernels = tuple(_t(k) for k in jax_realesrgan.sample_batch_kernels(keys[0], cfg, b))
    return draws, kernels


_JITTED = {}


def _jax_program(name, fn, cfg):
    if name not in _JITTED:
        _JITTED[name] = jax.jit(lambda k, x: fn(k, x, cfg))
    return _JITTED[name]


# What the seeds draw (first noise Gaussian?, second?, second blur?, resize-back before the JPEG?):
# 1: P G blur -; 3: G G blur a; 10: G P - -; 25: P P - -; 21: P G blur a; 2: G G blur -; 26: P G - a.
WHOLE_CASES = [(64, 1), (64, 3), (64, 10), (64, 25), (64, 21), (128, 2), (128, 26)]


@pytest.mark.parametrize("size,seed", WHOLE_CASES)
def test_degrade_batch_with_the_jax_draws_matches_jax(size, seed):
    """The whole Real-ESRGAN program. JPEG rounding and the final 8-bit
    rounding flip on f32 noise, so the bound is statistical: lq within one
    8-bit level on at least 99% of pixels and a mean absolute difference under
    2e-3 (measured over these cases: all pixels within one level, mean 1e-8 to
    5e-7); hq exact."""
    jcfg, tcfg = jax_realesrgan.RealESRGANDegradationConfig(), realesrgan.RealESRGANDegradationConfig()
    hq = _image((2, size, size, 3), seed=seed)
    key = jax.random.key(seed)
    want = _jax_program("realesrgan", jax_realesrgan.degrade_batch, jcfg)(key, jnp.asarray(hq))
    draws, kernels = _jax_degrade_draws(key, jcfg, 2, size, size)
    got = realesrgan.degrade_batch(None, _t(hq), tcfg, kernels=kernels, draws=draws)
    assert np.array_equal(got["hq"].numpy(), np.asarray(want["hq"]))
    lq = got["lq"].numpy()
    diff = np.abs(lq - np.asarray(want["lq"]))
    assert lq.shape == hq.shape and (diff <= 1 / 255 + 1e-6).mean() >= 0.99 and diff.mean() < 2e-3, \
        ((diff <= 1 / 255 + 1e-6).mean(), diff.mean())
    assert np.abs(lq * 255 - np.round(lq * 255)).max() < 1e-4 and np.abs(lq - hq).mean() > 0.02


def test_the_whole_cases_take_every_branch():
    jcfg = jax_realesrgan.RealESRGANDegradationConfig()
    seen = [_jax_degrade_draws(jax.random.key(seed), jcfg, 1, 16, 16)[0] for _, seed in WHOLE_CASES]
    for attr in ("blur2", "use_a"):
        assert {getattr(d, attr) for d in seen} == {True, False}, attr
    assert {d.noise1.use_g for d in seen} == {True, False} and {d.noise2.use_g for d in seen} == {True, False}
    assert {d.mode1 for d in seen} | {d.mode2 for d in seen} == {0, 1, 2}


def _jax_codeformer_draws(key, cfg, b, h, w):
    kk, ks, kn, kq = jax.random.split(key, 4)
    mixed = jax.vmap(lambda k: _jax_mixed_draws(k, cfg.kernel))(jax.random.split(kk, b))
    canvas = (b, jax_realesrgan._round16(h / cfg.downsample_range[0]), jax_realesrgan._round16(w / cfg.downsample_range[0]), 3)
    kc, kg = jax.random.split(kn)  # the program draws sigma and the noise fields from the same key
    return codeformer.CodeformerDraws(
        kernel=_mixed(mixed),
        scale=float(jax.random.uniform(ks, minval=cfg.downsample_range[0], maxval=cfg.downsample_range[1])),
        sigma=_t(jax.random.uniform(kn, (b,), minval=cfg.noise_range[0], maxval=cfg.noise_range[1])),
        q=_t(jax.random.uniform(kq, (b,), minval=cfg.jpeg_range[0], maxval=cfg.jpeg_range[1])),
        fields=(_t(jax.random.normal(kc, canvas, dtype=jnp.float32)), _t(jax.random.normal(kg, canvas[:3] + (1,), dtype=jnp.float32))))


@pytest.mark.parametrize("size,seed", [(64, 0), (64, 7), (128, 3)])
def test_degrade_batch_codeformer_with_the_jax_draws_matches_jax(size, seed):
    """The whole CodeFormer program, same bound (its lq is not rounded to 8
    bits; measured: all pixels within one level, mean under 1e-6)."""
    jcfg, tcfg = jax_codeformer.CodeformerDegradationConfig(), codeformer.CodeformerDegradationConfig()
    hq = _image((2, size, size, 3), seed=seed)
    key = jax.random.key(seed)
    want = _jax_program("codeformer", jax_codeformer.degrade_batch_codeformer, jcfg)(key, jnp.asarray(hq))
    got = codeformer.degrade_batch_codeformer(None, _t(hq), tcfg, draws=_jax_codeformer_draws(key, jcfg, 2, size, size))
    assert np.array_equal(got["hq"].numpy(), np.asarray(want["hq"]))
    diff = np.abs(got["lq"].numpy() - np.asarray(want["lq"]))
    assert (diff <= 1 / 255 + 1e-6).mean() >= 0.99 and diff.mean() < 2e-3, ((diff <= 1 / 255 + 1e-6).mean(), diff.mean())
    assert np.abs(got["lq"].numpy() - hq).mean() > 0.01


@pytest.mark.parametrize("which", ["realesrgan", "codeformer"])
def test_own_draws_repeat_with_the_seed_and_differ_between_seeds(which):
    hq = _t(_image((2, 64, 64, 3), seed=9))
    if which == "realesrgan":
        run = lambda seed: realesrgan.degrade_batch(deg.make_generators(seed, "cpu"), hq, realesrgan.RealESRGANDegradationConfig())  # noqa: E731
    else:
        run = lambda seed: codeformer.degrade_batch_codeformer(deg.make_generators(seed, "cpu"), hq, codeformer.CodeformerDegradationConfig())  # noqa: E731
    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a["lq"], b["lq"]) and not torch.equal(a["lq"], c["lq"])
    for out in (a, c):
        assert out["lq"].shape == hq.shape and torch.isfinite(out["lq"]).all()
        assert float(out["lq"].min()) >= 0 and float(out["lq"].max()) <= 1
        assert torch.equal(out["hq"], hq * 2 - 1) and float((out["lq"] - hq).abs().mean()) > 0.01


def test_real_esrgan_options_sharpener_and_stage2_range():
    hq = _t(_image((1, 64, 64, 3), seed=2))
    cfg = realesrgan.RealESRGANDegradationConfig(use_sharpener=True, stage2_scale=(3.0, 5.0))
    out = realesrgan.degrade_batch(deg.make_generators(0, "cpu"), hq, cfg)
    assert out["lq"].shape == hq.shape and not torch.equal(out["hq"], hq * 2 - 1)  # the clean image is the sharpened one
    draws = realesrgan.draw_degradation(torch.Generator().manual_seed(0), cfg, 1)
    assert 3.0 <= draws.stage2_scale <= 5.0 and draws.kernels is not None
    assert realesrgan.draw_degradation(torch.Generator().manual_seed(0), cfg, 1, with_kernels=False).kernels is None
