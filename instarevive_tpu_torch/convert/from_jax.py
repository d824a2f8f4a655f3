"""Weight bridge from the JAX package: its param tree -> the port's three
state dicts (SwinIR, VAE, PixArt native), in the reference key layout.

``train_state_from_jax`` carries a training state across (parameters, EMA,
AdamW moments, the step); any tree with the parameters' structure goes
through the same map as the parameters themselves.

The exporters below are the port's own numpy-only copy of the three maps in
``instarevive_tpu/convert/torch_export.py`` (conv HWIO -> OIHW, dense
(in, out) -> (out, in), norm scale -> weight); ``tests/test_torch_convert.py``
holds them bit for bit against the JAX package's. Nothing here imports JAX
or the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import numpy as np


def _np(t) -> np.ndarray:
    return np.asarray(t)


def _get(tree: Mapping[str, Any], path: str):
    node = tree
    for part in path.split("/"):
        node = node[part]
    return node


def _has(tree: Mapping[str, Any], path: str) -> bool:
    node = tree
    for part in path.split("/"):
        if not isinstance(node, Mapping) or part not in node:
            return False
        node = node[part]
    return True


def _conv(sd, torch_path, tree, flax_path):
    sd[torch_path + ".weight"] = _np(_get(tree, flax_path + "/kernel")).transpose(3, 2, 0, 1)
    sd[torch_path + ".bias"] = _np(_get(tree, flax_path + "/bias"))


def _dense(sd, torch_path, tree, flax_path):
    sd[torch_path + ".weight"] = _np(_get(tree, flax_path + "/kernel")).transpose(1, 0)
    sd[torch_path + ".bias"] = _np(_get(tree, flax_path + "/bias"))


def _norm(sd, torch_path, tree, flax_path):
    sd[torch_path + ".weight"] = _np(_get(tree, flax_path + "/scale"))
    sd[torch_path + ".bias"] = _np(_get(tree, flax_path + "/bias"))


# ------------------------------------------------------------------- SwinIR


def swinir_params_to_torch(
    p: Mapping[str, Any],
    depths=(6,) * 8,
    upsampler: str = "nearest+conv",
    sf: int = 8,
    unshuffle: bool = True,
) -> Dict[str, np.ndarray]:
    """SwinIR param tree -> reference keys. ``unshuffle=True`` emits
    conv_first under the reference's Sequential index (conv_first.1)."""
    sd: Dict[str, np.ndarray] = {}
    first = "conv_first.1" if unshuffle else "conv_first"
    _conv(sd, first, p, "conv_first")
    _norm(sd, "patch_embed.norm", p, "patch_norm")
    for i, depth in enumerate(depths):
        for j in range(depth):
            blk = f"layers_{i}/blocks_{j}"
            t = f"layers.{i}.residual_group.blocks.{j}"
            _norm(sd, f"{t}.norm1", p, f"{blk}/norm1")
            _norm(sd, f"{t}.norm2", p, f"{blk}/norm2")
            _dense(sd, f"{t}.attn.qkv", p, f"{blk}/attn/qkv")
            _dense(sd, f"{t}.attn.proj", p, f"{blk}/attn/proj")
            sd[f"{t}.attn.relative_position_bias_table"] = _np(
                _get(p, f"{blk}/attn/relative_position_bias_table")
            )
            _dense(sd, f"{t}.mlp.fc1", p, f"{blk}/mlp/fc1")
            _dense(sd, f"{t}.mlp.fc2", p, f"{blk}/mlp/fc2")
        _conv(sd, f"layers.{i}.conv", p, f"layers_{i}/conv")
    _norm(sd, "norm", p, "norm")
    _conv(sd, "conv_after_body", p, "conv_after_body")
    if upsampler == "nearest+conv":
        _conv(sd, "conv_before_upsample.0", p, "conv_before_upsample")
        ups = {4: ("conv_up1", "conv_up2"), 8: ("conv_up1", "conv_up2", "conv_up3")}.get(
            sf, ("conv_up1",)
        )
        for name in ups:
            _conv(sd, name, p, name)
        _conv(sd, "conv_hr", p, "conv_hr")
    _conv(sd, "conv_last", p, "conv_last")
    return sd


# ---------------------------------------------------------------------- VAE


def _resblock(sd, torch_path, p, flax_path):
    _norm(sd, f"{torch_path}.norm1", p, f"{flax_path}/norm1")
    _conv(sd, f"{torch_path}.conv1", p, f"{flax_path}/conv1")
    _norm(sd, f"{torch_path}.norm2", p, f"{flax_path}/norm2")
    _conv(sd, f"{torch_path}.conv2", p, f"{flax_path}/conv2")
    if _has(p, f"{flax_path}/nin_shortcut"):
        _conv(sd, f"{torch_path}.nin_shortcut", p, f"{flax_path}/nin_shortcut")


def _attnblock(sd, torch_path, p, flax_path):
    _norm(sd, f"{torch_path}.norm", p, f"{flax_path}/norm")
    for n in ("q", "k", "v", "proj_out"):
        _conv(sd, f"{torch_path}.{n}", p, f"{flax_path}/{n}")


def vae_params_to_torch(
    p: Mapping[str, Any],
    ch_mult=(1, 2, 4, 4),
    num_res_blocks: int = 2,
) -> Dict[str, np.ndarray]:
    """VAE param tree -> CompVis/SD AutoencoderKL keys."""
    sd: Dict[str, np.ndarray] = {}
    _conv(sd, "encoder.conv_in", p, "encoder/conv_in")
    for i in range(len(ch_mult)):
        for j in range(num_res_blocks):
            _resblock(sd, f"encoder.down.{i}.block.{j}", p, f"encoder/down_{i}_block_{j}")
        if _has(p, f"encoder/down_{i}_downsample"):
            _conv(sd, f"encoder.down.{i}.downsample.conv", p, f"encoder/down_{i}_downsample")
    _resblock(sd, "encoder.mid.block_1", p, "encoder/mid_block_1")
    _attnblock(sd, "encoder.mid.attn_1", p, "encoder/mid_attn_1")
    _resblock(sd, "encoder.mid.block_2", p, "encoder/mid_block_2")
    _norm(sd, "encoder.norm_out", p, "encoder/norm_out")
    _conv(sd, "encoder.conv_out", p, "encoder/conv_out")

    _conv(sd, "decoder.conv_in", p, "decoder/conv_in")
    _resblock(sd, "decoder.mid.block_1", p, "decoder/mid_block_1")
    _attnblock(sd, "decoder.mid.attn_1", p, "decoder/mid_attn_1")
    _resblock(sd, "decoder.mid.block_2", p, "decoder/mid_block_2")
    for i in range(len(ch_mult)):
        for j in range(num_res_blocks + 1):
            if _has(p, f"decoder/up_{i}_block_{j}"):
                _resblock(sd, f"decoder.up.{i}.block.{j}", p, f"decoder/up_{i}_block_{j}")
        if _has(p, f"decoder/up_{i}_upsample"):
            _conv(sd, f"decoder.up.{i}.upsample.conv", p, f"decoder/up_{i}_upsample")
    _norm(sd, "decoder.norm_out", p, "decoder/norm_out")
    _conv(sd, "decoder.conv_out", p, "decoder/conv_out")

    _conv(sd, "quant_conv", p, "quant_conv")
    _conv(sd, "post_quant_conv", p, "post_quant_conv")
    return sd


# ------------------------------------------------------------------- PixArt


def _pixart_block(sd, torch_blk, p, flax_blk):
    sd[f"{torch_blk}.scale_shift_table"] = _np(_get(p, f"{flax_blk}/scale_shift_table"))
    _dense(sd, f"{torch_blk}.attn.qkv", p, f"{flax_blk}/attn/qkv")
    _dense(sd, f"{torch_blk}.attn.proj", p, f"{flax_blk}/attn/proj")
    if _has(p, f"{flax_blk}/attn/sr"):
        _conv(sd, f"{torch_blk}.attn.sr", p, f"{flax_blk}/attn/sr")
        _norm(sd, f"{torch_blk}.attn.norm", p, f"{flax_blk}/attn/norm")
    if _has(p, f"{flax_blk}/attn/q_norm"):
        _norm(sd, f"{torch_blk}.attn.q_norm", p, f"{flax_blk}/attn/q_norm")
        _norm(sd, f"{torch_blk}.attn.k_norm", p, f"{flax_blk}/attn/k_norm")
    _dense(sd, f"{torch_blk}.cross_attn.q_linear", p, f"{flax_blk}/cross_attn/q_linear")
    _dense(sd, f"{torch_blk}.cross_attn.kv_linear", p, f"{flax_blk}/cross_attn/kv_linear")
    _dense(sd, f"{torch_blk}.cross_attn.proj", p, f"{flax_blk}/cross_attn/proj")
    _dense(sd, f"{torch_blk}.mlp.fc1", p, f"{flax_blk}/mlp/fc1")
    _dense(sd, f"{torch_blk}.mlp.fc2", p, f"{flax_blk}/mlp/fc2")


def pixart_params_to_torch(p: Mapping[str, Any], depth: int = 28) -> Dict[str, np.ndarray]:
    """PixArt param tree -> the reference's native .pth keys; pos_embed
    buffers are computed, not stored, as the reference itself loads them."""
    sd: Dict[str, np.ndarray] = {}
    _conv(sd, "x_embedder.proj", p, "x_embedder")
    _dense(sd, "t_embedder.mlp.0", p, "t_embedder/fc1")
    _dense(sd, "t_embedder.mlp.2", p, "t_embedder/fc2")
    _dense(sd, "t_block.1", p, "t_block")
    _dense(sd, "y_embedder.y_proj.fc1", p, "y_embedder/y_proj/fc1")
    _dense(sd, "y_embedder.y_proj.fc2", p, "y_embedder/y_proj/fc2")
    if _has(p, "y_embedder/y_embedding"):
        sd["y_embedder.y_embedding"] = _np(_get(p, "y_embedder/y_embedding"))
    for i in range(depth):
        _pixart_block(sd, f"blocks.{i}", p, f"blocks_{i}")
    sd["final_layer.scale_shift_table"] = _np(_get(p, "final_scale_shift_table"))
    _dense(sd, "final_layer.linear", p, "final_linear")
    if _has(p, "csize_embedder"):
        _dense(sd, "csize_embedder.mlp.0", p, "csize_embedder/fc1")
        _dense(sd, "csize_embedder.mlp.2", p, "csize_embedder/fc2")
        _dense(sd, "ar_embedder.mlp.0", p, "ar_embedder/fc1")
        _dense(sd, "ar_embedder.mlp.2", p, "ar_embedder/fc2")
    j = 0
    while _has(p, f"controlnet_{j}"):
        _pixart_block(sd, f"controlnet.{j}.copied_block", p, f"controlnet_{j}")
        _dense(sd, f"controlnet.{j}.after_proj", p, f"controlnet_{j}_after_proj")
        if j == 0:
            _dense(sd, "controlnet.0.before_proj", p, "controlnet_before_proj")
        j += 1
    return sd


def state_dicts_from_jax(params: Mapping[str, Any], cfg: Mapping[str, Any]) -> Dict[str, Dict[str, np.ndarray]]:
    """``params``: the JAX pipeline's param tree ({'swinir', 'vae', 'dit'}, any
    subset); ``cfg``: the config it was built from. Returns
    {'swinir': sd, 'vae': sd, 'dit': sd} for ``pipelines.build.load_state_dicts``."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    if "swinir" in params:
        sw = cfg.get("swinir", {})
        out["swinir"] = swinir_params_to_torch(
            params["swinir"],
            depths=tuple(sw.get("depths", (6,) * 8)),
            upsampler=sw.get("upsampler", "nearest+conv"),
            sf=sw.get("sf", 8),
            unshuffle=sw.get("unshuffle", True),
        )
    if "vae" in params:
        vae = cfg.get("vae", {})
        out["vae"] = vae_params_to_torch(
            params["vae"],
            ch_mult=tuple(vae.get("ch_mult", (1, 2, 4, 4))),
            num_res_blocks=vae.get("num_res_blocks", 2),
        )
    if "dit" in params:
        out["dit"] = pixart_params_to_torch(params["dit"], depth=cfg.get("dit", {}).get("depth", 28))
    return out


def train_state_from_jax(
    params: Mapping[str, Any],
    ema: Any,
    mu: Mapping[str, Any],
    nu: Mapping[str, Any],
    count: int,
    names: Sequence[str],
    depth: int = 28,
    step: int = 0,
) -> Dict[str, Any]:
    """A PixArt training state of the JAX package (its ``TrainState.params``
    and ``ema_params``, the ``mu``, ``nu`` and ``count`` of its AdamW state;
    numpy in) as the tree ``train.checkpoint.load_state_tree`` loads into the
    port's ``TrainState``. ``names`` is that state's ``names``: the order of
    its parameter list, which the moment lists follow. Without clipping's or
    accumulation's own state: build the port's optimizer with the same
    options and load this into it."""
    def as_dict(tree):
        return pixart_params_to_torch(tree, depth=depth)

    mu_sd, nu_sd = as_dict(mu), as_dict(nu)
    return {
        "step": int(step),
        "params": as_dict(params),
        "ema": None if ema is None else as_dict(ema),
        "opt_state": {"inner": {"count": int(count),
                                "mu": [mu_sd[n] for n in names], "nu": [nu_sd[n] for n in names]}},
    }
