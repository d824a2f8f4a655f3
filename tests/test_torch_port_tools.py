"""The last refusals of modules already ported, on the CPU: SwinIR's residual
head (``upsampler=""``) against the JAX SwinIR at tiny width (f32, 1e-4
absolute on [0, 1] images, as ``test_torch_models.py``), the
``activation_stats`` line against the JAX package's, ``utils/profiling``
(``time_fn``, ``pipeline_stage_times``, ``trace``), and the trainer's
``--trace_steps/--trace_at``."""

import json
import os

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test worker)

import jax
import jax.numpy as jnp

from instarevive_tpu.models.swinir import SwinIR as JaxSwinIR
from instarevive_tpu.utils import debug as jax_debug
from instarevive_tpu_torch.convert.from_jax import swinir_params_to_torch
from instarevive_tpu_torch.models.swinir import SwinIR
from instarevive_tpu_torch.utils import debug, profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "tiny.yaml")
RESIDUAL = dict(embed_dim=60, depths=(2, 2), num_heads=(6, 6), window=8, sf=1, upsampler="", unshuffle=False)


@pytest.mark.parametrize("hw", [(32, 40), (36, 44)])
def test_swinir_residual_head_matches_jax(hw):
    """32x40: shifted windows over 4x5 of them; 36x44: the reflect pad to a
    multiple of 8 and the crop back."""
    jnet = JaxSwinIR(**RESIDUAL)
    params = jax.jit(jnet.init)(jax.random.key(3), jnp.zeros((1, 32, 32, 3)))["params"]
    net = SwinIR(**RESIDUAL)
    sd = swinir_params_to_torch(params, depths=RESIDUAL["depths"], upsampler="", sf=1, unshuffle=False)
    net.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    assert "conv_before_upsample.0.weight" not in net.state_dict() and net.conv_last.in_channels == 60
    x = np.random.default_rng(0).random((2, *hw, 3), np.float32)
    with torch.no_grad():
        out = net.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jax.jit(jnet.apply)({"params": params}, jnp.asarray(x))), rtol=0, atol=1e-4)


def test_swinir_refuses_an_unknown_upsampler():
    with pytest.raises(ValueError, match="pixelshuffle"):
        SwinIR(upsampler="pixelshuffle")


@pytest.mark.parametrize("case", ["finite", "inf", "nan", "inf_and_nan"])
def test_activation_stats_line_matches_jax(case, capsys):
    x = np.random.default_rng(1).standard_normal((3, 5)).astype(np.float32)
    if "inf" in case:
        x[0, 1] = -np.inf
    if "nan" in case:
        x[2, 2] = np.nan
    jax_debug.activation_stats("blk", jnp.asarray(x))
    jax.effects_barrier()
    want = capsys.readouterr().out
    t = torch.from_numpy(x)
    assert debug.activation_stats("blk", t) is t
    assert capsys.readouterr().out == want and want.startswith("[activation] blk: absmin=")


def test_time_fn_waits_warms_and_takes_the_median():
    calls = []

    def fn(x):
        calls.append(x)
        return torch.ones(2) * x

    seconds = profiling.time_fn(fn, 3.0, iters=3, warmup=2)
    assert calls == [3.0] * 5 and 0 <= seconds < 1


def test_pipeline_stage_times_times_each_stage_on_its_input():
    """Each stage alone on what the one before it gave, warmed once and
    timed ``iters`` times, under the JAX package's stage names (a stand-in
    pipeline that records its calls)."""
    calls = []

    class Pipe:
        def clean(self, x):
            calls.append(("clean", x))
            return x + 1

        def encode(self, x):
            calls.append(("encode", x))
            return x * 2

        def one_step(self, z, y):
            calls.append(("one_step", z, y))
            return z

        def decode(self, z):
            calls.append(("decode", z))
            return z

        def process(self, x, y):
            calls.append(("process", x, y))
            return x

    lq, y = torch.zeros(1), torch.ones(1)
    times = profiling.pipeline_stage_times(Pipe(), lq, y, iters=3)
    assert list(times) == ["swinir", "vae_encode", "dit_one_step", "vae_decode", "full_pipeline"]
    assert all(t >= 0 for t in times.values())
    by_stage = {}
    for name, *args in calls:
        by_stage.setdefault(name, []).append([float(a) for a in args])
    assert by_stage["clean"] == [[0.0]] * 5 and by_stage["encode"] == [[1.0]] * 5  # the set-up's call and 1 + 3
    assert by_stage["one_step"] == [[2.0, 1.0]] * 4 and by_stage["decode"] == [[2.0]] * 4
    assert by_stage["process"] == [[0.0, 1.0]] * 4


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as path:
        torch.ones(16, 16) @ torch.ones(16, 16)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert path == str(tmp_path / "t" / "trace.json") and "aten::mm" in names


def test_trainer_traces_the_asked_steps(tmp_path):
    """``--trace_steps 1 --trace_at 1`` on a 2-step SwinIR run: the trace of
    step 1 is written and the log says where."""
    from instarevive_tpu_torch.tools.time_train import write_images
    from instarevive_tpu_torch.train import launcher

    data = write_images(str(tmp_path / "hq"), n=2, size=72)
    out = str(tmp_path / "run")
    run = launcher.main(["--device", "cpu", "--config", TINY, "--task", "swinir", "--data", data, "--out", out,
                         "--batch_size", "2", "--crop_size", "64", "--steps", "2", "--warmup", "1",
                         "--trace_steps", "1", "--trace_at", "1"])
    assert run.end_step == 2
    path = os.path.join(out, "trace", "trace.json")
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names or "aten::addmm" in names
    with open(os.path.join(out, "train.log")) as f:
        log = f.read()
    assert "trace started at step 1 (1 steps)" in log and f"trace stopped at step 2: {path}" in log
