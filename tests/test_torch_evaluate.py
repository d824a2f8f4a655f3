"""The port's evaluation CLI against the JAX package's root ``evaluate_img.py``
on the CPU: both ``main()``s on the same two seeded output/reference PNG
pairs (one reference matched by its stem under another extension, the pairs
of unequal sizes) with the same checkpoints: ``--alexnet_ckpt/--lpips_ckpt``
and ``--maniqa_ckpt`` in the official layouts (``tools/iqa_checkpoints``),
``--musiq_params`` written by the JAX package's ``save_params_npz``, and
``--niqe_fit`` on a folder of pristine images. Every printed line must name
the same metric and count, and every printed mean must agree to its last
printed digit (1e-4); the networks' own bounds are in the module tests."""

import re
import sys

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test worker)
from PIL import Image

import evaluate_img as jax_cli
from instarevive_tpu.utils import musiq as jax_musiq
from instarevive_tpu_torch import evaluate_img
from instarevive_tpu_torch.tools import iqa_checkpoints

LINE = re.compile(r"^(\w+): (-?[\d.]+)  \(n=(\d+)\)$")


def metric_lines(text):
    """{metric: (mean, n)} of the printed ``name: mean  (n=k)`` lines."""
    found = {}
    for line in text.splitlines():
        m = LINE.match(line.strip())
        if m:
            found[m.group(1)] = (float(m.group(2)), int(m.group(3)))
    return found


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(0)
    for sub in ("out", "ref", "pristine"):
        (root / sub).mkdir()
    for name, ext in (("a", "png"), ("b", "bmp")):  # one common size: the JAX CLI compiles once a shape
        h, w = 100, 120
        ref = rng.integers(0, 256, (h + 4, w - 4, 3), dtype=np.uint8)
        out = np.clip(ref[:h, : w - 4].astype(np.int64) + rng.integers(-20, 21, (h, w - 4, 3)), 0, 255)
        Image.fromarray(np.pad(out, ((0, 0), (0, 4), (0, 0))).astype(np.uint8)).save(root / "out" / f"{name}.png")
        Image.fromarray(ref).save(root / "ref" / f"{name}.{ext}")
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (200, 230, 3), dtype=np.uint8)).save(root / "pristine" / f"{i}.png")
    alex, lins = iqa_checkpoints.lpips(0, classifier=False)
    torch.save(alex, root / "alexnet.pth")
    torch.save(lins, root / "lpips.pth")
    torch.save({"state_dict": iqa_checkpoints.maniqa(2)}, root / "maniqa.pt")
    jax_musiq.save_params_npz(str(root / "musiq.npz"), jax_musiq.init_random_params(0))
    return root


def test_cli_matches_jax(folders, monkeypatch, capsys):
    r = folders
    argv = ["--folder", str(r / "out"), "--ref_folder", str(r / "ref"), "--alexnet_ckpt", str(r / "alexnet.pth"),
            "--lpips_ckpt", str(r / "lpips.pth"), "--musiq_params", str(r / "musiq.npz"),
            "--maniqa_ckpt", str(r / "maniqa.pt"), "--niqe_fit", str(r / "pristine")]
    monkeypatch.setattr(sys, "argv", ["evaluate_img.py", *argv])
    jax_cli.main()
    ref = metric_lines(capsys.readouterr().out)
    results = evaluate_img.main([*argv, "--device", "cpu"])
    out = metric_lines(capsys.readouterr().out)
    assert set(out) == set(ref) == {"psnr", "ssim", "lpips", "niqe", "musiq", "maniqa"}
    for name, (mean, n) in ref.items():
        assert out[name][1] == n == 2, name
        assert abs(out[name][0] - mean) <= 1e-4 + 1e-5 * abs(mean), (name, out[name], mean)
        assert abs(np.mean(results[name]) - out[name][0]) <= 5e-5
    assert all(np.isfinite(v).all() for v in results.values())


def test_cli_on_the_card_without_one_exits(folders, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        evaluate_img.main(["--folder", str(folders / "out")])


def test_reference_by_stem(folders):
    assert evaluate_img.find_reference(str(folders / "out" / "b.png"), str(folders / "ref")).endswith("b.bmp")
    assert evaluate_img.find_reference(str(folders / "out" / "c.png"), str(folders / "ref")) is None
