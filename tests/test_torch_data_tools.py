"""The port's data-preparation CLIs (``instarevive_tpu_torch/tools/``:
``generate_data_info``, ``make_file_list``, ``pickout_img``, ``lq``) against
the root tools of the JAX package, each run as its ``main`` on the same
folder and seed: the manifest and the lists byte for byte, the copies file
for file, and ``lq``'s images with the JAX tool's draws handed to the port
(``jax.random`` and ``torch.Generator`` give other numbers from one seed):
blur, downsample and noise to 1e-5 absolute in f32, and the written PNGs
within one JPEG rounding flip (at least 99% of the levels within 1, none
further than 52 = 0.2 * 255, the bound of ``test_torch_degradation.py``'s
JPEG round trip)."""

import importlib.util
import json
import math
import os
import sys

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test worker)
from PIL import Image

import jax
import jax.numpy as jnp

from instarevive_tpu.ops import degradation as jax_deg
from instarevive_tpu_torch.ops.degradation import MixedKernelDraws
from instarevive_tpu_torch.tools import generate_data_info, lq, make_file_list, pickout_img

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_LQ_KERNELS = jax_deg.KernelConfig(kernel_list=("iso", "aniso"), kernel_prob=(0.5, 0.5), sinc_prob=0.0,
                                      blur_sigma=(0.1, 10.0), kernel_range=(41,), pad_to=41)  # tools/lq.py's


def run_jax_tool(name, argv, monkeypatch):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [name] + list(argv))
    mod.main()


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """Two folders of seeded images of several sizes, one nested subfolder."""
    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    sizes = {"a": [(48, 40), (40, 56), (64, 64)], "b": [(32, 72), (56, 48)]}
    for folder, hw in sizes.items():
        (root / folder / "nested").mkdir(parents=True)
        for i, (h, w) in enumerate(hw):
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            ext = ".png" if i % 2 == 0 else ".jpg"
            Image.fromarray(img).save(root / folder / f"{folder}{i}{ext}")
        Image.fromarray(rng.integers(0, 256, (24, 24, 3), dtype=np.uint8)).save(root / folder / "nested" / "n.png")
    (root / "a" / "notes.txt").write_text("not an image")
    return root


@pytest.mark.parametrize("extra", [[], ["--prompt", "a photo", "--sort"],
                                   ["--captions", "CAPS", "--relative_to", "ROOT"]],
                         ids=["absolute", "prompt_sorted", "captions_relative"])
def test_generate_data_info_equals_jax(folders, tmp_path, monkeypatch, extra):
    caps = tmp_path / "caps.json"
    caps.write_text(json.dumps({"a0.png": "first", "b1.jpg": "second"}))
    extra = [str(caps) if e == "CAPS" else str(folders) if e == "ROOT" else e for e in extra]
    args = ["--folders", str(folders / "b"), str(folders / "a")] + extra
    run_jax_tool("generate_data_info", args + ["--output", str(tmp_path / "jax.json")], monkeypatch)
    records = generate_data_info.main(args + ["--output", str(tmp_path / "port.json"), "--device", "cpu"])
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert len(records) == 5 and all(r["ratio"] == r["width"] / r["height"] for r in records)


@pytest.mark.parametrize("val_size,seed", [(0, 231), (2, 7)])
def test_make_file_list_equals_jax(folders, tmp_path, monkeypatch, val_size, seed):
    args = ["--img_folder", str(folders / "a"), str(folders / "b"), "--val_size", str(val_size), "--seed", str(seed)]
    run_jax_tool("make_file_list", args + ["--save_folder", str(tmp_path / "jax")], monkeypatch)
    splits = make_file_list.main(args + ["--save_folder", str(tmp_path / "port")])
    for name in ("train.list", "val.list"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert len(splits["val.list"]) == val_size and len(splits["train.list"]) == 7 - val_size


def test_pickout_img_equals_jax(folders, tmp_path, monkeypatch):
    lst = tmp_path / "test.list"
    lst.write_text(f"a/a0.png\n\n{folders / 'b' / 'b1.jpg'}\na/nested/n.png\n")
    args = ["--list", str(lst), "--root", str(folders)]
    run_jax_tool("pickout_img", args + ["--output", str(tmp_path / "jax")], monkeypatch)
    assert pickout_img.main(args + ["--output", str(tmp_path / "port")]) == 3
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == ["a0.png", "b1.jpg", "n.png"]
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes()


def jax_lq_draws(seed, i, lhw):
    """The JAX tool's draws for image ``i`` (``tools/lq.py``'s key, split as
    ``random_mixed_kernel`` and ``random_add_gaussian_noise`` split it), as
    the port's ``LQDraws``."""
    cfg = JAX_LQ_KERNELS
    kk, kn = jax.random.split(jax.random.key(seed * 100003 + i))
    keys = jax.random.split(kk, 6)
    probs = np.zeros(len(jax_deg.KERNEL_TYPES), np.float32)
    probs[:2] = 0.5
    ktype = jax.random.choice(keys[0], len(jax_deg.KERNEL_TYPES), p=jnp.asarray(probs))
    sx, sy = (jax.random.uniform(k, minval=0.1, maxval=10.0) for k in keys[1:3])
    theta = jax.random.uniform(keys[3], minval=cfg.rotation_range[0], maxval=cfg.rotation_range[1])
    betag, betap = jax_deg._sample_beta(keys[4], *cfg.betag_range), jax_deg._sample_beta(keys[5], *cfg.betap_range)
    ks, _, kf = jax.random.split(kn, 3)
    sigma = jax.random.uniform(ks, (1,), minval=0.0, maxval=20.0 / 255.0)
    kc, kg = jax.random.split(kf)
    fields = (jax.random.normal(kc, (1, *lhw, 3)), jax.random.normal(kg, (1, *lhw, 1)))

    def t(x):
        return torch.from_numpy(np.array(x)).reshape(-1)

    kernel = MixedKernelDraws(ktype=t(ktype), sx=t(sx), sy=t(sy), theta=t(theta), betag=t(betag), betap=t(betap))
    return lq.LQDraws(kernel=kernel, sigma=t(sigma), fields=tuple(torch.from_numpy(np.array(f)) for f in fields))


def test_lq_blur_downsample_noise_match_jax():
    """The stage before JPEG, on the JAX tool's own composition."""
    from instarevive_tpu.ops.filters import filter2d as jax_filter2d
    from instarevive_tpu.ops.resize import interpolate as jax_interpolate

    img = np.random.default_rng(3).uniform(0, 1, (1, 60, 52, 3)).astype(np.float32)
    lhw = lq.lq_size(60, 52, 2.7)
    draws = jax_lq_draws(5, 1, lhw)
    kk, kn = jax.random.split(jax.random.key(5 * 100003 + 1))
    kernel = jax_deg.random_mixed_kernel(kk, JAX_LQ_KERNELS, active_size=41)
    x = jax_interpolate(jax_filter2d(jnp.asarray(img), kernel[None]), lhw, mode="bilinear")
    want = np.asarray(jax_deg.random_add_gaussian_noise(kn, x, (0.0, 20.0 / 255.0), gray_prob=0.0))
    got = lq.blur_down_noise(torch.from_numpy(img), lhw, draws).numpy()
    assert got.shape == want.shape == (1, *lhw, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_lq_cli_matches_jax(folders, tmp_path, monkeypatch):
    """Both CLIs over one folder and seed (scale and quality from the same
    numpy generator), the JAX tool's draws handed to the port."""
    src = tmp_path / "hq"
    src.mkdir()
    for name in ("a0.png", "a1.jpg"):
        Image.open(folders / "a" / name).save(src / name.replace(".jpg", ".png"))
    run_jax_tool("lq", ["--input", str(src), "--output", str(tmp_path / "jax"), "--seed", "3"], monkeypatch)
    paths = lq.main(["--input", str(src), "--output", str(tmp_path / "port"), "--seed", "3", "--device", "cpu"],
                    draws=lambda i, lhw: jax_lq_draws(3, i, lhw))
    assert [os.path.basename(p) for p in paths] == sorted(os.listdir(tmp_path / "jax")) == ["a0.png", "a1.png"]
    for p in paths:
        got = np.asarray(Image.open(p)).astype(np.int32)
        want = np.asarray(Image.open(tmp_path / "jax" / os.path.basename(p))).astype(np.int32)
        diff = np.abs(got - want)
        assert got.shape == want.shape and (diff <= 1).mean() >= 0.99 and diff.max() <= 52, \
            ((diff <= 1).mean(), diff.max())
    own = lq.main(["--input", str(src), "--output", str(tmp_path / "own"), "--seed", "3", "--device", "cpu"])
    again = lq.main(["--input", str(src), "--output", str(tmp_path / "again"), "--seed", "3", "--device", "cpu"])
    for a, b in zip(own, again):  # the port's own draws: one seed, the same images
        assert np.array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))
    assert not math.isclose(float(np.asarray(Image.open(own[0])).std()), 0.0)
