"""The port's checkpoint tools (``instarevive_tpu_torch/tools/export_checkpoint.py``
and ``convert_checkpoint.py``) against the JAX package's (``tools/``), on
seeded weights built in code at the structures the JAX tool's importers
assume (SwinIR 8 x 6 blocks, VAE and UNet channel_mult (1, 2, 4, 4) with 2
res blocks; the tiny DiT with ``--depth 2``) and small widths.

For every ``--kind``: the foreign state dict (reference keys under a
``module.`` prefix, with the buffers the reference stores and the port
computes) goes through the JAX tool's importer and, separately, the port's
``convert``; the JAX params carried across by ``convert/from_jax.py`` equal
the port's result key for key and bit for bit. A port train-state checkpoint
of the same weights then goes through the port's ``export`` and equals the
JAX tool's export of the JAX params, and ``convert(export(x))`` gives ``x``
back bit for bit. The CLIs run in-process on files; ``--weights ema`` and
``--state_index`` pick from a full train state."""

import os
import sys

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test worker)
import yaml

from instarevive_tpu.convert import torch_export as jax_export
from instarevive_tpu.convert import torch_import as jax_import
from instarevive_tpu_torch.convert import from_jax
from instarevive_tpu_torch.models.pixart import PixArt
from instarevive_tpu_torch.models.swinir import SwinIR
from instarevive_tpu_torch.models.unet import UNetBackbone
from instarevive_tpu_torch.models.vae import AutoencoderKL
from instarevive_tpu_torch.tools import convert_checkpoint, export_checkpoint
from instarevive_tpu_torch.train.checkpoint import save_train_state
from instarevive_tpu_torch.train.optim import build_optimizer
from instarevive_tpu_torch.train.state import TrainState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools.export_checkpoint import _select_params  # noqa: E402  (the JAX tool's own selection)

TINY = yaml.safe_load(open(os.path.join(REPO, "configs", "tiny.yaml")))
UNET = dict(in_channels=4, out_channels=4, model_channels=32, num_res_blocks=2, attention_ds=[1, 2, 4],
            channel_mult=[1, 2, 4, 4], num_head_channels=16, context_dim=32, transformer_depth=1)
CONTROLNET = dict(UNET, in_channels=8, is_controlnet=True)
CONTROLNET.pop("out_channels")


def _model(kind):
    torch.manual_seed({"swinir": 0, "vae": 1, "pixart": 2, "dit-diffusers": 2, "unet": 3, "controlnet": 4}[kind])
    if kind == "swinir":
        return SwinIR(embed_dim=12, depths=[6] * 8, num_heads=[2] * 8, window=8, mlp_ratio=2.0, sf=8,
                      unshuffle=True, unshuffle_scale=8)
    if kind == "vae":
        return AutoencoderKL(ch=32, ch_mult=[1, 2, 4, 4], num_res_blocks=2)
    if kind in ("pixart", "dit-diffusers"):
        model = PixArt(**TINY["dit"])
        with torch.no_grad():
            for name, t in model.named_parameters():
                t.normal_(0.0, 0.05)  # scale_shift tables and y_embedding random too
            model.y_embedder.y_embedding.normal_()
        return model
    return UNetBackbone(**(UNET if kind == "unet" else CONTROLNET))


def _jax_params(kind, sd):
    """The JAX tool's importer, with the tool's arguments (convert_checkpoint.py)."""
    return {
        "swinir": lambda: jax_import.swinir_params_from_torch(sd),
        "vae": lambda: jax_import.vae_params_from_torch(sd),
        "pixart": lambda: jax_import.pixart_params_from_torch(sd, depth=2),
        "dit-diffusers": lambda: jax_import.pixart_params_from_diffusers(sd, depth=2),
        "unet": lambda: jax_import.unet_params_from_torch(sd),
        "controlnet": lambda: jax_import.unet_params_from_torch(sd, is_controlnet=True),
    }[kind]()


def _carried(kind, params):
    """JAX params in the port's layout (``convert/from_jax.py``)."""
    return {
        "swinir": lambda: from_jax.swinir_params_to_torch(params, depths=(6,) * 8, sf=8),
        "vae": lambda: from_jax.vae_params_to_torch(params),
        "pixart": lambda: from_jax.pixart_params_to_torch(params, depth=2),
        "dit-diffusers": lambda: from_jax.pixart_params_to_torch(params, depth=2),
        "unet": lambda: from_jax.unet_params_to_torch(params),
        "controlnet": lambda: from_jax.unet_params_to_torch(params, is_controlnet=True),
    }[kind]()


def _jax_export(kind, params):
    """The JAX tool's exporter, with its default arguments (export_checkpoint.py)."""
    return {
        "swinir": lambda: jax_export.swinir_params_to_torch(params, depths=(6,) * 8, sf=8),
        "vae": lambda: jax_export.vae_params_to_torch(params),
        "pixart": lambda: jax_export.pixart_params_to_torch(params, depth=2),
        "dit-diffusers": lambda: jax_export.pixart_params_to_diffusers(params, depth=2),
        "unet": lambda: jax_export.unet_params_to_torch(params),
        "controlnet": lambda: jax_export.unet_params_to_torch(params, is_controlnet=True),
    }[kind]()


def _foreign(kind, model):
    """The reference checkpoint: native (or diffusers) keys under ``module.``,
    with the buffers the reference stores."""
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    if kind == "dit-diffusers":
        sd = export_checkpoint.pixart_to_diffusers(sd)
    if kind == "swinir":
        sd["layers.0.residual_group.blocks.1.attn_mask"] = torch.zeros(4, 64, 64)
        sd["layers.0.residual_group.blocks.0.attn.relative_position_index"] = torch.zeros(64, 64, dtype=torch.int64)
    if kind == "pixart":
        sd["pos_embed"] = torch.zeros(1, 1024, 64)
    return {f"module.{k}": v for k, v in sd.items()}


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        w = want[k] if isinstance(want[k], torch.Tensor) else torch.from_numpy(np.ascontiguousarray(want[k]))
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


KINDS = convert_checkpoint.KINDS


@pytest.mark.parametrize("kind", KINDS)
def test_convert_matches_the_jax_tool(kind):
    model = _model(kind)
    foreign = _foreign(kind, model)
    got = convert_checkpoint.convert(foreign, kind, depth=2)
    _same(got, _carried(kind, _jax_params(kind, {k: v.numpy() for k, v in foreign.items()})))


@pytest.mark.parametrize("kind", KINDS)
def test_export_matches_the_jax_tool_and_round_trips(kind, tmp_path):
    """A port train state of the weights -> export == the JAX tool's export of
    the same JAX params; convert(export) gives the state dict back."""
    model = _model(kind)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    params = _jax_params(kind, {k: v.numpy() for k, v in _foreign(kind, model).items()})
    state = TrainState.create(model, build_optimizer("adamw", 1e-3), ema=True)
    save_train_state(str(tmp_path / "ckpt"), (state,), None, 0)
    exported = export_checkpoint.main(["--kind", kind, "--src", str(tmp_path / "ckpt"), "--dst",
                                       str(tmp_path / "out.pth")])
    _same(exported, _jax_export(kind, params))
    _same(torch.load(tmp_path / "out.pth", weights_only=True), exported)
    back = convert_checkpoint.main(["--kind", kind, "--src", str(tmp_path / "out.pth"), "--dst",
                                    str(tmp_path / "back.pth"), "--depth", "2"])
    _same(back, {k: v for k, v in sd.items() if not k.endswith(convert_checkpoint.COMPUTED)})


def test_export_picks_state_and_weights(tmp_path):
    """--state_index and --weights ema from a DMD-like pair of states, as the
    JAX tool's ``_select_params`` picks from its train-state tree; the EMA
    takes the trained weights' place, the buffers stay the state's."""
    gen, fake = _model("pixart"), _model("pixart")
    with torch.no_grad():
        for p in fake.parameters():
            p.add_(1.0)
    states = [TrainState.create(m, build_optimizer("adamw", 1e-2), ema=m is gen) for m in (gen, fake)]
    states[0].apply_gradients([torch.ones_like(p) for p in states[0].params])
    save_train_state(str(tmp_path / "ckpt"), states, None, 1)
    from instarevive_tpu_torch.train.checkpoint import load_checkpoint

    tree = load_checkpoint(str(tmp_path / "ckpt"))
    for index, weights in ((0, "params"), (0, "ema"), (1, "params")):
        got = export_checkpoint.export(tree, "pixart", index, weights)
        want = dict(_select_params(tree, index, "params"))
        if weights == "ema":
            want.update(_select_params(tree, index, "ema"))
        _same(got, want)
    ema = export_checkpoint.export(tree, "pixart", 0, "ema")
    online = export_checkpoint.export(tree, "pixart", 0, "params")
    assert not torch.equal(ema["blocks.0.attn.qkv.weight"], online["blocks.0.attn.qkv.weight"])
    assert torch.equal(ema["y_embedder.y_embedding"], online["y_embedder.y_embedding"])
    with pytest.raises(SystemExit, match="no 'ema'"):
        export_checkpoint.export(tree, "pixart", 1, "ema")
