"""The trainer under data parallelism and FSDP2 (``parallel/mesh.TrainMesh``,
``train/launcher.py``) on gloo ranks against the port's own one-process
run on the same global batches, ``--resume`` across world sizes, the
``--fsdp`` flag's rules, and one FSDP2 step against the JAX package's
sharded step (``tests/test_parallel_train.py``).

The images are 64x64 and mirror-symmetric, so the loader's random crop and
flip (which follow thread order, ROADMAP C14) give the same batches in every
run. One world of 4 ranks (``torch_parallel_jobs.training``) runs DDP(2) and
FSDP2(2) side by side on its two pairs, then HSDP 2 x 2, then a resume on 4
FSDP2 ranks; each test asserts its own part.

Bounds (f32 on the CPU). The losses: 1e-5 relative, since the ranks' sums
(the local forward at another batch size, the gradient all-reduce or
reduce-scatter) come in other orders, and 1e-10 absolute for the
distribution-matching loss of the first step, which is 0 (the fake score
starts as the teacher, and the null caption is the caption). The parameters and the EMA after two
AdamW steps at lr 1e-4: an AdamW step moves a weight by lr m/(sqrt(v) + eps),
flat in the gradient where it is large and steepest (lr/eps) where the
gradient is near 0, where a rounding error of the gradient can flip the
step's sign. So all but a thousandth of a model's weights are held to 1e-7,
and every weight to 4e-4, the gap two flipped steps can open (2 x 2 lr). The JAX step (the test's
own values: ones, lr 1e-2): its losses (about 250) to 1e-6 relative, the
weights and the EMA to 1e-6 absolute.
"""

import os

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test worker)
from PIL import Image
from torch_parallel_jobs import came_steps, train_argv
from torch_world import run_world

import jax
import jax.numpy as jnp

from instarevive_tpu.parallel.mesh import make_mesh, shard_batch, shard_params
from instarevive_tpu.train.optim import build_optimizer as jax_build_optimizer
from instarevive_tpu.train.optim import constant_with_warmup as jax_constant_with_warmup
from instarevive_tpu.train.state import TrainState as JaxTrainState
from instarevive_tpu_torch.parallel.mesh import TrainMesh
from instarevive_tpu_torch.train import launcher
from instarevive_tpu_torch.train.checkpoint import load_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL, LOSS_ATOL, PARAM_ATOL, PARAM_BULK, JAX_ATOL = 1e-5, 1e-10, 4e-4, 1e-7, 1e-6
MODES = ("ddp", "fsdp", "hsdp")


def _jax_sharded_step():
    """test_parallel_train.py::test_fsdp_train_step_runs_sharded's two steps."""
    mesh = make_mesh(data=4, fsdp=2)
    with mesh:
        params = shard_params({"w": jnp.ones((16, 32)), "b": jnp.zeros((32,))}, mesh)
        state = JaxTrainState.create(params, jax_build_optimizer("adamw", jax_constant_with_warmup(1e-2, 1)), ema=True)
        batch = shard_batch({"x": jnp.ones((8, 16)), "y": jnp.zeros((8, 32))}, mesh)

        @jax.jit
        def step(state, batch):
            def loss(p):
                return jnp.mean((batch["x"] @ p["w"] + p["b"] - batch["y"]) ** 2)

            l, g = jax.value_and_grad(loss)(state.params)
            return state.apply_gradients(g), l

        losses = []
        for _ in range(2):
            state, l = step(state, batch)
            losses.append(float(l))
    p, e = state.params, state.ema_params
    return {"losses": losses, "params": {"weight": np.asarray(p["w"]).T, "bias": np.asarray(p["b"])},
            "ema": {"weight": np.asarray(e["w"]).T, "bias": np.asarray(e["b"])}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_train")
    (root / "hq").mkdir()
    rng = np.random.default_rng(7)
    for i in range(4):
        half = rng.integers(0, 256, (64, 32, 3), dtype=np.uint8)
        Image.fromarray(np.concatenate([half, half[:, ::-1]], axis=1)).save(root / "hq" / f"{i}.png")
    for name in ("tiny.yaml", "cldm_tiny.yaml"):
        with open(os.path.join(REPO, "configs", name)) as src, open(root / name, "w") as dst:
            dst.write(src.read())
    ref = {f"{task}": launcher.main(train_argv(root, task, f"{task}_one", 2)).history for task in ("dmd", "swinir")}
    ref["dmd3"] = launcher.main(train_argv(root, "dmd", "dmd_one3", 3)).history
    ref["cldm"] = launcher.main(train_argv(root, "cldm", "cldm_one", 2, "--config", f"{root}/cldm_tiny.yaml")).history
    ref["came"] = came_steps(TrainMesh())
    ranks = run_world(4, "torch_parallel_jobs:training", {"root": str(root)})
    return root, ref, ranks


def _close_history(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, atol=LOSS_ATOL, err_msg=k)


def _close_state(got_dir, want_dir):
    got, want = load_checkpoint(got_dir), load_checkpoint(want_dir)
    assert got["step_i"] == want["step_i"]
    for gs, ws in zip(got["states"], want["states"]):
        if ws is None:  # a plain carry the task does not use (cldm's sampler state)
            assert gs is None
            continue
        assert gs["step"] == ws["step"] and set(gs["params"]) == set(ws["params"])
        for tree in ("params", "ema"):
            if ws[tree] is None:
                assert gs[tree] is None
                continue
            off = total = 0
            for k, w in ws[tree].items():
                np.testing.assert_allclose(gs[tree][k].numpy(), w.numpy(), atol=PARAM_ATOL, rtol=0, err_msg=k)
                off += int(np.sum(np.abs(gs[tree][k].numpy() - w.numpy()) > PARAM_BULK))
                total += w.numel()
            assert off <= 1e-3 * total, (tree, off, total)
        for k in ("mu", "nu"):
            for g, w in zip(gs["opt_state"]["inner"][k], ws["opt_state"]["inner"][k]):
                assert g.shape == w.shape  # the one-card layout at every world size


@pytest.mark.parametrize("task", ["dmd", "swinir"])
@pytest.mark.parametrize("mode", MODES)
def test_step_matches_one_process(runs, task, mode):
    """Two steps on the same global batches: the losses every rank logs, the
    updated parameters, the EMA, the step and the optimizer state's layout of
    the checkpoint rank 0 writes."""
    root, ref, ranks = runs
    holders = {"ddp": (0, 1), "fsdp": (2, 3), "hsdp": (0, 1, 2, 3)}[mode]
    for r in holders:
        _close_history(ranks[r][f"{task}_{mode}"], ref[task])
    _close_state(root / f"{task}_{mode}" / "final", root / f"{task}_one" / "final")


@pytest.mark.parametrize("mode", ["ddp", "fsdp"])
def test_cldm_step_matches_one_process(runs, mode):
    """The cldm trainer (UNet and ControlNet, its frozen encoder inside the
    sharded UNet) under DDP(2) and FSDP2(2): the losses, the trained weights
    and the EMA of two steps, as above."""
    root, ref, ranks = runs
    for r in {"ddp": (0, 1), "fsdp": (2, 3)}[mode]:
        _close_history(ranks[r][f"cldm_{mode}"], ref["cldm"])
    _close_state(root / f"cldm_{mode}" / "final", root / "cldm_one" / "final")


def test_resume_at_another_world_size(runs):
    """The FSDP2(2) DMD checkpoint of step 2 resumed on 4 FSDP2 ranks takes
    the step a one-process run takes from step 2 to 3."""
    root, ref, ranks = runs
    for r in range(4):
        _close_history(ranks[r]["dmd_resume4"], ref["dmd3"][2:])
    _close_state(root / "dmd_resume4" / "final", root / "dmd_one3" / "final")


@pytest.mark.parametrize("mode", ["linear_fsdp2", "linear_hsdp"])
def test_fsdp_step_matches_jax_sharded_step(runs, mode):
    want = _jax_sharded_step()
    _, _, ranks = runs
    for r in range(4):
        got = ranks[r][mode]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=JAX_ATOL, atol=0)
        for tree in ("params", "ema"):
            for k in ("weight", "bias"):
                np.testing.assert_allclose(got[tree][k].numpy(), want[tree][k], rtol=0, atol=JAX_ATOL)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in _flat(t)]
    return [tree]


@pytest.mark.parametrize("mode", ["came_fsdp2", "came_hsdp"])
def test_came_on_shards_matches_one_process(runs, mode):
    """CAME's cross-shard means (a 2-D weight's column statistics, the mean
    of its row statistics, every update's RMS) and the global-norm clip over
    the shard group: three steps on sharded weights give the one-process
    losses (1e-5 relative), weights, EMA and factored moments in the one-card
    layout (1e-6 absolute; CAME's update is clipped by its RMS, not flat in
    the gradient as Adam's)."""
    _, ref, ranks = runs
    want = ref["came"]
    for r in range(4):
        got = ranks[r][mode]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL, atol=0)
        for tree in ("params", "ema"):
            for k in want[tree]:
                np.testing.assert_allclose(got[tree][k].numpy(), want[tree][k].numpy(), atol=JAX_ATOL, rtol=0)
        for g, w in zip(_flat(got["opt"]), _flat(want["opt"])):
            if isinstance(w, torch.Tensor):
                assert g.shape == w.shape
                np.testing.assert_allclose(g.numpy(), w.numpy(), atol=JAX_ATOL, rtol=1e-5)
            else:
                assert int(g) == int(w)


@pytest.mark.parametrize("mode", ["came_fsdp2", "came_hsdp"])
def test_a_non_finite_shard_skips_the_step_on_every_rank(runs, mode):
    """A gradient that is not finite on one rank's shard only (rank 0's): the
    flag is all ranks' (TrainState.agree), so every rank, of every replica
    under HSDP, keeps its weights."""
    _, _, ranks = runs
    for r in range(4):
        assert ranks[r][mode]["skipped"] and ranks[r][mode]["kept"]


def test_fsdp_flag_rules(tmp_path):
    """The world is data x --fsdp, data what --fsdp leaves of the cards (or of
    a torchrun world): on the card more ranks than cards is an error, never a
    CPU run; the global batch must split evenly."""
    with pytest.raises(SystemExit, match=f"this host has {torch.cuda.device_count()} CUDA devices"):
        launcher.train_mesh(launcher.parse_args(["--task", "dmd", "--data", "x", "--out", "y", "--fsdp",
                                                 str(torch.cuda.device_count() + 2)]), [])
    args = launcher.parse_args(["--task", "dmd", "--data", "x", "--out", "y", "--device", "cpu"])
    assert launcher.train_mesh(args, []).size == 1 and not args.launched
    from instarevive_tpu_torch.parallel.mesh import mesh_shape

    assert mesh_shape(8, -1, 2) == (4, 2, 1) and mesh_shape(4, 2, 2) == (2, 2, 1)
    with pytest.raises(ValueError, match="not divisible"):
        mesh_shape(6, -1, 4)


def test_torchrun_world_is_data_times_fsdp(runs):
    """Under torchrun (WORLD_SIZE 4) the data axis is what --fsdp leaves:
    4 x 1 at --fsdp 1 (data parallelism), 2 x 2 at --fsdp 2 (HSDP), the
    ranks in batch order."""
    _, _, ranks = runs
    for r in range(4):
        assert ranks[r]["torchrun_mesh"] == {1: (4, 1, r, False), 2: (2, 2, r, True)}


def test_cli_starts_its_own_fsdp_ranks(runs):
    """``python -m instarevive_tpu_torch.train --fsdp 2`` without WORLD_SIZE
    starts two ranks itself (gloo on the CPU); rank 0 writes the one-card
    checkpoint, which the export tool reads."""
    import subprocess
    import sys

    root, _, _ = runs
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    proc = subprocess.run([sys.executable, "-m", "instarevive_tpu_torch.train", *train_argv(root, "swinir", "cli", 1),
                           "--fsdp", "2"], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(root / "cli" / "train.log") as f:
        assert "rank 0 of data 1 x fsdp 2" in f.read()
    from instarevive_tpu_torch.tools import export_checkpoint

    sd = export_checkpoint.export(load_checkpoint(root / "cli" / "final"), "swinir")
    want = load_checkpoint(root / "swinir_one" / "final")["states"][0]["params"]
    assert sorted(sd) == sorted(want) and all(sd[k].shape == want[k].shape for k in want)
