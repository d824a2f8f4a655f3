"""The port's parallel inference (``parallel/{tp,sp,pp}.py`` and
``RestorationPipeline.sharded/tp/sp/pp``) on gloo ranks against the JAX
package's parallel counterparts on the conftest's 8 virtual CPU devices, the
same seeded weights (carried across by ``convert/from_jax.py``) and inputs.

One world of 4 ranks runs every case (``torch_parallel_jobs.inference``);
each test asserts its own part. Bounds: the tiny restoration pipeline at
atol 2e-4 (``tests/test_torch_pipeline.py``'s bound against the JAX
pipeline, f32 on the CPU); the toy DiT at atol/rtol 1e-5, the JAX package's
own bound for its sp and pp forwards against the one-device forward.
"""

import os

import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a test worker)
from torch_world import run_world

import jax
import jax.numpy as jnp

from instarevive_tpu.config import load_config
from instarevive_tpu.models.pixart import PixArt as JaxPixArt
from instarevive_tpu.parallel.mesh import make_mesh
from instarevive_tpu.parallel.pp import make_pipe_mesh, pixart_pp_forward
from instarevive_tpu.parallel.sp import make_seq_mesh, pixart_sp_forward
from instarevive_tpu.pipelines.build import build_pipeline, init_params
from instarevive_tpu_torch.convert.from_jax import pixart_params_to_torch, state_dicts_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = load_config(os.path.join(REPO, "configs", "tiny.yaml"))
PIPE_ATOL = 2e-4
TOY_TOL = 1e-5
TOY = dict(input_size=8, patch_size=2, hidden_size=64, num_heads=4, caption_channels=32, model_max_length=6,
           mlp_ratio=2.0)


def _toy(depth, b, **over):
    """test_parallel_pp.py's / test_parallel_sp.py's toy DiT, inputs and a
    ragged caption mask, and the port's state dict of the same weights."""
    cfg = dict(TOY, depth=depth, **over)
    model = JaxPixArt(**cfg)
    x = jax.random.normal(jax.random.key(0), (b, 8, 8, 4))
    t = jnp.full((b,), 400.0)
    y = jax.random.normal(jax.random.key(1), (b, cfg["model_max_length"], cfg["caption_channels"])) * 0.1
    params = model.init(jax.random.key(2), x[:1], t[:1], y[:1])["params"]
    mask = np.random.default_rng(3).random((b, cfg["model_max_length"])) < 0.7
    mask[:, 0] = True
    spec = {"cfg": cfg, "sd": pixart_params_to_torch(params, depth), "x": np.asarray(x), "t": np.asarray(t),
            "y": np.asarray(y), "mask": mask}
    return model, params, spec


@pytest.fixture(scope="module")
def cases():
    """The JAX references and the world's results, by case."""
    pipe = build_pipeline(TINY)
    params = init_params(pipe, seed=0)
    rng = np.random.default_rng(0)
    lq4 = rng.uniform(0.2, 0.8, (4, 64, 64, 3)).astype(np.float32)
    lq2 = rng.uniform(0.2, 0.8, (2, 64, 64, 3)).astype(np.float32)
    L, C = TINY["dit"]["model_max_length"], TINY["dit"]["caption_channels"]
    y4, y2 = np.zeros((4, L, C), np.float32), np.zeros((2, L, C), np.float32)
    kw = dict(color_fix="wavelet")
    dev = jax.devices()
    ref = {
        "sharded": pipe.jitted_sharded(make_mesh(data=2, devices=dev[:2]), **kw)(params, lq4, y4),
        "tp": pipe.jitted_tp(make_mesh(data=1, tensor=2, devices=dev[:2]), **kw)(params, lq4, y4),
        "tp_dp": pipe.jitted_tp(make_mesh(data=2, tensor=2, devices=dev[:4]), **kw)(params, lq4, y4),
        "sp4_process": pipe.jitted_sp(make_seq_mesh(4), **kw)(params, lq2, y2),
        "pp2_process": pipe.jitted_pp(make_pipe_mesh(2), microbatches=2, **kw)(params, lq2, y2),
    }
    sp_model, sp_params, toy_sp = _toy(3, 2)
    pp_model, pp_params, toy_pp = _toy(4, 4)
    sp_in = [jnp.asarray(toy_sp[k]) for k in ("x", "t", "y")]
    pp_in = [jnp.asarray(toy_pp[k]) for k in ("x", "t", "y")]
    for s in (2, 4):
        ref[f"sp{s}"] = pixart_sp_forward(sp_model, sp_params, make_seq_mesh(s), *sp_in)
    ref["sp2_masked"] = pixart_sp_forward(sp_model, sp_params, make_seq_mesh(2), *sp_in, jnp.asarray(toy_sp["mask"]))
    for s, m in ((4, 2), (2, 4), (4, 1)):
        ref[f"pp_{s}_{m}"] = pixart_pp_forward(pp_model, pp_params, make_pipe_mesh(s), *pp_in, microbatches=m)
    ref["pp_4_2_masked"] = pixart_pp_forward(pp_model, pp_params, make_pipe_mesh(4), *pp_in,
                                             jnp.asarray(toy_pp["mask"]), microbatches=2)
    _, _, toy_het = _toy(3, 2, kv_compress_sampling="uniform", kv_compress_ratio=2, kv_compress_layers=(1,))
    payload = {"tiny": TINY, "sds": state_dicts_from_jax(params, TINY), "lq4": lq4, "y4": y4, "lq2": lq2,
               "y2": y2, "toy_sp": toy_sp, "toy_pp": toy_pp, "toy_het": toy_het}
    ranks = run_world(4, "torch_parallel_jobs:inference", payload)
    return {k: np.asarray(v) for k, v in ref.items()}, ranks


# case -> (the ranks that hold it, bound)
PIPE_CASES = {"sharded": ((0, 1), PIPE_ATOL), "tp": ((2, 3), PIPE_ATOL), "tp_dp": ((0, 1, 2, 3), PIPE_ATOL),
              "sp4_process": ((0, 1, 2, 3), PIPE_ATOL), "pp2_process": ((0, 1, 2, 3), PIPE_ATOL)}
TOY_CASES = {"sp2": (0, 1, 2, 3), "sp4": (0, 1, 2, 3), "sp2_masked": (0, 1, 2, 3), "pp_4_2": (0, 1, 2, 3),
             "pp_2_4": (0, 1, 2, 3), "pp_4_1": (0, 1, 2, 3), "pp_4_2_masked": (0, 1, 2, 3)}


@pytest.mark.parametrize("case", sorted(PIPE_CASES))
def test_process_mode_matches_jax(cases, case):
    """sharded / tp (t = 2) / tp x dp (2 x 2) / sp (4) / pp (2 stages, 2
    microbatches) of the tiny restoration pipeline against jitted_sharded /
    jitted_tp / jitted_sp / jitted_pp; every rank of the group holds the
    whole batch."""
    ref, ranks = cases
    holders, atol = PIPE_CASES[case]
    for r in holders:
        np.testing.assert_allclose(ranks[r][case], ref[case], atol=atol, rtol=0)


@pytest.mark.parametrize("case", sorted(TOY_CASES))
def test_dit_forward_matches_jax(cases, case):
    """pixart_sp_forward at 2 and 4 shards (and a caption mask) and the
    pipeline at (stages, microbatches) (4, 2), (2, 4), (4, 1) (and a mask)
    against the JAX package's forwards of the same names."""
    ref, ranks = cases
    for r in TOY_CASES[case]:
        np.testing.assert_allclose(ranks[r][case], ref[case], atol=TOY_TOL, rtol=TOY_TOL)


def test_pipeline_rank_holds_its_stage_only_and_reuses_it(cases):
    """A pipeline rank's module tree lacks the other stage's blocks (tiny
    depth 2 over 2 stages: one block each), and a second call on the same
    stage modules (no per-call cache of weights) restores the flipped batch."""
    ref, ranks = cases
    for r in range(4):
        assert ranks[r]["pp2_blocks_held"] == 1
        np.testing.assert_allclose(ranks[r]["pp2_process_again"], ref["pp2_process"][::-1], atol=PIPE_ATOL, rtol=0)


@pytest.mark.parametrize("case,ranks_held,words", [
    ("refuse_sp_heterogeneous", (0, 1, 2, 3), "homogeneous"),
    ("refuse_pp_heterogeneous", (0, 1, 2, 3), "homogeneous"),
    ("refuse_sp_tokens", (0, 1, 2), "16 tokens not divisible by seq shards 3"),
    ("refuse_pp_depth", (0, 1, 2), "depth 4 not divisible by pipe stages 3"),
    ("refuse_pp_batch", (0, 1, 2, 3), "batch 4 not divisible by microbatches 3"),
])
def test_refusals(cases, case, ranks_held, words):
    """Where the JAX package raises (sp.py:62-72, pp.py:148-153, 225-232),
    the port raises, before any collective."""
    _, ranks = cases
    for r in ranks_held:
        assert ranks[r][case] is not None and words in ranks[r][case], ranks[r][case]


def test_tp_state_dict_round_trip():
    """shard_params_tp cuts a one-card state dict into parts with the same
    keys; gather_params_tp joins them back bit for bit."""
    import torch

    from instarevive_tpu_torch.models.pixart import PixArt
    from instarevive_tpu_torch.parallel.tp import gather_params_tp, shard_params_tp

    sd = PixArt(**dict(TOY, depth=2)).state_dict()
    parts = [shard_params_tp(sd, r, 2) for r in range(2)]
    assert all(set(p) == set(sd) for p in parts)
    assert parts[0]["blocks.0.mlp.fc1.weight"].shape[0] == sd["blocks.0.mlp.fc1.weight"].shape[0] // 2
    assert parts[1]["blocks.1.attn.proj.weight"].shape[1] == 32
    assert parts[1]["blocks.1.attn.proj.bias"].shape[0] == 64  # added once, after the all-reduce
    back = gather_params_tp(parts)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_tp_dit_lays_out_what_shard_params_tp_cuts(cases):
    """Each tensor rank's DiT after ``tp_dit`` holds exactly its
    ``shard_params_tp`` part of the one-card state dict, and
    ``gather_params_tp`` of the two ranks' state dicts is the one-card one."""
    import torch

    from instarevive_tpu_torch.parallel.tp import gather_params_tp, shard_params_tp

    _, ranks = cases
    full = {k: torch.from_numpy(v) for k, v in ranks[2]["tp_one_card_state"].items()}
    parts = [{k: torch.from_numpy(v) for k, v in ranks[r]["tp_state"].items()} for r in (2, 3)]
    for i, part in enumerate(parts):
        want = shard_params_tp(full, i, 2)
        assert set(part) == set(want) and all(torch.equal(part[k], want[k]) for k in want)
    back = gather_params_tp(parts)
    assert all(torch.equal(back[k], full[k]) for k in full)
