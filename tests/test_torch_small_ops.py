"""The port's small pure modules against the JAX package on the CPU, from the
same numpy inputs: token masking (ops/masking.py), patch fold/unfold
(ops/patching.py), the RAW/ISP pipeline (ops/isp.py), brush-stroke masks and
the dihedral augmentation (data/masks.py), and the native-loader binding with
the dataset branch that uses it (data/native_loader.py, data/dataset.py)."""

import os

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test worker)
from PIL import Image

import jax
import jax.numpy as jnp

from instarevive_tpu.data import masks as jax_masks, native_loader as jax_native
from instarevive_tpu.ops import isp as jax_isp, masking as jax_masking, patching as jax_patching
from instarevive_tpu_torch.data import masks, native_loader
from instarevive_tpu_torch.data.dataset import ImageFolderDataset
from instarevive_tpu_torch.ops import isp, masking, patching

TOL = 1e-5  # f32 arithmetic in another order; exact where only indices or copies are compared


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# masking


@pytest.mark.parametrize("mask_type", ["random", "laplacian", "fft"])
def test_mask_indices_match_jax_with_the_same_noise(mask_type):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 48, 8)).astype(np.float32)
    key = jax.random.key(3)
    noise = np.asarray(jax.random.uniform(key, (2, 48)))  # what the JAX function draws from this key
    want_keep, want_restore = jax_masking.get_mask_indices(key, jnp.asarray(x), 0.4, mask_type, hw=(6, 8))
    keep, restore = masking.get_mask_indices(None, _t(x), 0.4, mask_type, hw=(6, 8), noise=_t(noise))
    assert keep.shape == (2, 19) and restore.shape == (2, 48)
    assert np.array_equal(keep.numpy(), np.asarray(want_keep))
    assert np.array_equal(restore.numpy(), np.asarray(want_restore))


@pytest.mark.parametrize("which", ["laplacian", "fft"])
def test_token_importance_matches_jax(which):
    x = np.random.default_rng(1).standard_normal((2, 80, 4)).astype(np.float32)
    want = getattr(jax_masking, f"_importance_{which}")(jnp.asarray(x), (8, 10))
    got = getattr(masking, f"_importance_{which}")(_t(x), (8, 10))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL


def test_mask_out_and_unmask_match_jax_and_round_trip():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 32, 6)).astype(np.float32)
    token = rng.standard_normal((6,)).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    keep, restore = masking.get_mask_indices(gen, _t(x), 0.25)
    kept = masking.mask_out_tokens(_t(x), keep)
    full = masking.unmask_tokens(kept, restore, _t(token), 32)
    want_kept = jax_masking.mask_out_tokens(jnp.asarray(x), jnp.asarray(keep.numpy()))
    want_full = jax_masking.unmask_tokens(want_kept, jnp.asarray(restore.numpy()), jnp.asarray(token), 32)
    assert np.array_equal(kept.numpy(), np.asarray(want_kept)) and np.array_equal(full.numpy(), np.asarray(want_full))
    # the kept tokens are back in place, every other position holds the mask token
    is_kept = torch.zeros(3, 32, dtype=torch.bool).scatter_(1, keep, True)
    assert torch.equal(full[is_kept], _t(x)[is_kept]) and torch.equal(full[~is_kept], _t(token).expand(3 * 24, 6))
    # the same generator state draws the same indices; another seed draws others
    again, _ = masking.get_mask_indices(torch.Generator().manual_seed(0), _t(x), 0.25)
    other, _ = masking.get_mask_indices(torch.Generator().manual_seed(1), _t(x), 0.25)
    assert torch.equal(again, keep) and not torch.equal(other, keep)


# ---------------------------------------------------------------------------
# patching


def test_patch_weighting_is_the_jax_packages():
    for args in ((8, 12, 3, 2), (16, 16, 1, 1), (6, 4, 4, 5)):
        assert np.array_equal(patching.patch_weighting(*args), jax_patching.patch_weighting(*args))
        assert np.array_equal(patching.patch_weighting(*args, tie_braker=False),
                              jax_patching.patch_weighting(*args, tie_braker=False))


@pytest.mark.parametrize("shape,kernel,stride", [((2, 24, 32, 3), (8, 16), (4, 8)), ((1, 20, 20, 2), (12, 12), (8, 8))])
def test_unfold_and_fold_match_jax(shape, kernel, stride):
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    want = jax_patching.unfold(jnp.asarray(x), kernel, stride)
    got = patching.unfold(_t(x), kernel, stride)
    assert np.array_equal(got.numpy(), np.asarray(want))
    l = got.shape[1]
    w = np.random.default_rng(5).random((l, *kernel)) + 0.1
    for normalize in (True, False):
        back = patching.fold(got, shape[1:3], stride, weighting=w, normalize=normalize)
        ref = jax_patching.fold(want, shape[1:3], stride, weighting=w, normalize=normalize)
        assert np.abs(back.numpy() - np.asarray(ref)).max() <= TOL
    assert np.abs(patching.fold(got, shape[1:3], stride, weighting=w).numpy() - x).max() <= TOL  # fold(unfold(x)) == x
    with pytest.raises(ValueError, match="cannot tile"):
        patching.fold(got[:, :-1], shape[1:3], stride)
    with pytest.raises(ValueError, match="larger than size"):
        patching.unfold(_t(x), (shape[1] + 1, 4), stride)


@pytest.mark.parametrize("uf,df", [(1, 1), (2, 1), (1, 2)])
def test_patched_apply_matches_jax(uf, df):
    x = np.random.default_rng(6).standard_normal((2, 24, 32, 3)).astype(np.float32)

    def fn_np(p):  # scale the patch grid by uf / df and mix the channels
        p = p.repeat(uf, axis=1).repeat(uf, axis=2)[:, ::df, ::df]
        return p * 0.5 + p[..., ::-1] * 0.25

    got = patching.patched_apply(lambda p: _t(fn_np(p.numpy()).copy()), _t(x), (8, 16), (4, 8), uf=uf, df=df)
    want = jax_patching.patched_apply(lambda p: jnp.asarray(fn_np(np.asarray(p))), jnp.asarray(x), (8, 16), (4, 8),
                                      uf=uf, df=df)
    assert got.shape == (2, 24 * uf // df, 32 * uf // df, 3)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL
    with pytest.raises(ValueError, match="expected scale"):
        patching.patched_apply(lambda p: p[:, :4], _t(x), (8, 16), (4, 8))
    with pytest.raises(ValueError, match="mutually exclusive"):
        patching.patched_apply(lambda p: p, _t(x), (8, 16), (4, 8), uf=2, df=2)


# ---------------------------------------------------------------------------
# ISP


def test_interp1d_matches_jax_and_numpy_and_takes_a_gradient():
    rng = np.random.default_rng(7)
    x = np.sort(rng.random((3, 16)).astype(np.float32), axis=1)
    x[1, 5] = x[1, 4]  # a repeated knot
    y = rng.standard_normal((3, 16)).astype(np.float32)
    xn = (rng.random((3, 40)).astype(np.float32) * 1.4 - 0.2)  # some outside the knots on both sides
    got = isp.interp1d(_t(xn), _t(x), _t(y))
    want = np.asarray(jax_isp.interp1d(jnp.asarray(xn), jnp.asarray(x), jnp.asarray(y)))
    assert np.abs(got.numpy() - want).max() <= TOL
    assert np.abs(got[0].numpy() - np.interp(xn[0], x[0], y[0])).max() <= TOL
    q = _t(xn).clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(isp.interp1d(q, _t(x), _t(y)).sum(), q)
    want_grad = np.asarray(jax.grad(lambda v: jax_isp.interp1d(v, jnp.asarray(x), jnp.asarray(y)).sum())(jnp.asarray(xn)))
    inside = (xn > x[:, :1]) & (xn < x[:, -1:])
    assert np.abs(grad.numpy() - want_grad)[inside].max() <= 1e-3 * np.abs(want_grad).max()
    assert np.all(grad.numpy()[~inside] == 0)


@pytest.mark.parametrize("with_crf", [False, True])
def test_raw2rgb_matches_jax(with_crf):
    rng = np.random.default_rng(8)
    bayer = rng.random((2, 12, 10, 4)).astype(np.float32)
    red, blue = np.asarray([1.9, 2.1], np.float32), np.asarray([1.5, 1.6], np.float32)
    ccm = (np.eye(3, dtype=np.float32)[None] + 0.1 * rng.standard_normal((2, 3, 3)).astype(np.float32))
    crf = {}
    if with_crf:
        crf = {"crf_i": np.linspace(0, 1, 32, dtype=np.float32), "crf_b": np.linspace(0, 1, 32, dtype=np.float32) ** 0.45}
    got = isp.raw2rgb(_t(bayer), _t(red), _t(blue), _t(ccm), **{k: _t(v) for k, v in crf.items()})
    want = jax_isp.raw2rgb(jnp.asarray(bayer), jnp.asarray(red), jnp.asarray(blue), jnp.asarray(ccm),
                           **{k: jnp.asarray(v) for k, v in crf.items()})
    assert got.shape == (2, 12, 10, 3) and np.abs(got.numpy() - np.asarray(want)).max() <= TOL
    assert np.abs(isp.apply_ccm(_t(bayer[..., :3]), _t(ccm)).numpy()
                  - np.asarray(jax_isp.apply_ccm(jnp.asarray(bayer[..., :3]), jnp.asarray(ccm)))).max() <= TOL


# ---------------------------------------------------------------------------
# masks, augmentation


def test_brush_stroke_mask_is_the_jax_packages_for_the_same_generator():
    for seed, hw in ((0, (128, 128)), (5, (96, 160))):
        got = masks.brush_stroke_mask(np.random.default_rng(seed), hw)
        want = jax_masks.brush_stroke_mask(np.random.default_rng(seed), hw)
        assert got.shape == hw and got.dtype == np.float32 and np.array_equal(got, want)
        assert set(np.unique(got)) <= {0.0, 1.0} and 0 < got.mean() < 1


@pytest.mark.parametrize("mode", range(8))
def test_dihedral_augmentation_matches_jax_and_inverts(mode):
    x = np.random.default_rng(9).standard_normal((2, 6, 10, 3)).astype(np.float32)
    got = masks.augment_dihedral(_t(x), mode)
    assert np.array_equal(got.numpy(), np.asarray(jax_masks.augment_dihedral(jnp.asarray(x), mode)))
    assert torch.equal(masks.invert_augment_dihedral(got, mode), _t(x))


# ---------------------------------------------------------------------------
# the native loader


def _jpegs(folder, n=3, size=(80, 112)):
    rng = np.random.default_rng(10)
    paths = []
    for i in range(n):
        ramp = np.linspace(0, 255, size[1])[None, :, None] * np.ones((size[0], 1, 3))
        img = np.clip(ramp * rng.random(3) + 20 * rng.standard_normal((*size, 3)), 0, 255).astype(np.uint8)
        paths.append(os.path.join(folder, f"{i}.jpg"))
        Image.fromarray(img).save(paths[-1], quality=92)
    return paths


def test_native_loader_binding_is_the_jax_packages(tmp_path):
    """Both bindings load one library (``native/libfastloader.so``); where it
    is not built both say so and every function returns None."""
    assert native_loader._LIB_PATH == jax_native._LIB_PATH
    assert native_loader.available() == jax_native.available()
    paths = _jpegs(str(tmp_path))
    arr = np.random.default_rng(1).standard_normal((4, 8, 8, 4)).astype(np.float32)
    np.save(tmp_path / "a.npy", arr)
    calls = [
        lambda m: m.decode_crop(paths[0], 64, crop="center"),
        lambda m: m.decode_crop(paths[1], 48, crop="random", seed=7, hflip=True),
        lambda m: m.batch_decode(paths, 32, crop="random", seeds=[1, 2, 3], hflips=[True, False, True], num_threads=2),
        lambda m: m.load_npy_f32(str(tmp_path / "a.npy")),
    ]
    for call in calls:
        got, want = call(native_loader), call(jax_native)
        if not native_loader.available():
            assert got is None and want is None
        else:
            assert np.array_equal(got, want)
    if native_loader.available():
        ref = np.asarray(Image.open(paths[0]).convert("RGB"))
        assert np.array_equal(calls[0](native_loader), ref[8:72, 24:88])  # the centre crop of PIL's decode
        assert np.array_equal(calls[3](native_loader), arr)
        assert native_loader.decode_crop(str(tmp_path / "missing.jpg"), 64) is None


@pytest.mark.parametrize("native", [True, False])
def test_dataset_reads_jpegs_through_the_native_loader_or_pil(tmp_path, monkeypatch, native):
    """With the library the JPEG branch answers; without it (or when it
    fails) the PIL path does, with the same crop of the same decode."""
    _jpegs(str(tmp_path))
    if not native:
        monkeypatch.setattr(native_loader, "decode_crop", lambda *a, **k: None)
    ds = ImageFolderDataset(str(tmp_path), out_size=64, crop_type="center", use_hflip=False)
    assert len(ds) == 3
    for i in range(3):
        ref = np.asarray(Image.open(ds.files[i]).convert("RGB"))
        assert np.array_equal(ds[i]["hq"], ref[8:72, 24:88])
    flipped = ImageFolderDataset(str(tmp_path), out_size=64, crop_type="random", use_hflip=True, seed=3)
    sample = flipped[0]["hq"]
    assert sample.shape == (64, 64, 3) and sample.dtype == np.uint8 and sample.flags["C_CONTIGUOUS"]
