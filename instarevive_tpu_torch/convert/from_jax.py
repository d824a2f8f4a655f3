"""Weight bridge from the JAX package: its param tree -> the port's state
dicts (SwinIR, VAE, PixArt native; the LDM stack's UNet and ControlNet), in
the reference key layouts.

``train_state_from_jax`` carries a training state across (parameters, EMA,
AdamW moments, the step); any tree with the parameters' structure goes
through the same map as the parameters themselves.

The exporters below are the port's own numpy-only copy of the maps in
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


def _dense_nobias(sd, torch_path, tree, flax_path):
    sd[torch_path + ".weight"] = _np(_get(tree, flax_path + "/kernel")).transpose(1, 0)


def _unet_resblock(sd, tp, p, flax_path):
    _norm(sd, f"{tp}.in_layers.0", p, f"{flax_path}/in_norm")
    _conv(sd, f"{tp}.in_layers.2", p, f"{flax_path}/in_conv")
    _dense(sd, f"{tp}.emb_layers.1", p, f"{flax_path}/emb_proj")
    _norm(sd, f"{tp}.out_layers.0", p, f"{flax_path}/out_norm")
    _conv(sd, f"{tp}.out_layers.3", p, f"{flax_path}/out_conv")
    if _has(p, f"{flax_path}/skip"):
        _conv(sd, f"{tp}.skip_connection", p, f"{flax_path}/skip")


def _unet_st(sd, tp, p, flax_path, depth=1):
    _norm(sd, f"{tp}.norm", p, f"{flax_path}/norm")
    _dense(sd, f"{tp}.proj_in", p, f"{flax_path}/proj_in")
    for d in range(depth):
        bb = f"{tp}.transformer_blocks.{d}"
        fb = f"{flax_path}/block_{d}"
        for n in ("norm1", "norm2", "norm3"):
            _norm(sd, f"{bb}.{n}", p, f"{fb}/{n}")
        for an in ("attn1", "attn2"):
            _dense_nobias(sd, f"{bb}.{an}.to_q", p, f"{fb}/{an}_q")
            _dense_nobias(sd, f"{bb}.{an}.to_k", p, f"{fb}/{an}_k")
            _dense_nobias(sd, f"{bb}.{an}.to_v", p, f"{fb}/{an}_v")
            _dense(sd, f"{bb}.{an}.to_out.0", p, f"{fb}/{an}_out")
        _dense(sd, f"{bb}.ff.net.0.proj", p, f"{fb}/ff_proj")
        _dense(sd, f"{bb}.ff.net.2", p, f"{fb}/ff_out")
    _dense(sd, f"{tp}.proj_out", p, f"{flax_path}/proj_out")


def unet_params_to_torch(
    p: Mapping[str, Any],
    channel_mult=(1, 2, 4, 4),
    num_res_blocks: int = 2,
    attention_ds=(1, 2, 4),
    is_controlnet: bool = False,
) -> Dict[str, np.ndarray]:
    """UNet (or, with ``is_controlnet``, ControlNet) param tree -> the
    openaimodel keys that ``models/unet.UNetBackbone`` carries."""
    sd: Dict[str, np.ndarray] = {}
    _dense(sd, "time_embed.0", p, "time_embed_0")
    _dense(sd, "time_embed.2", p, "time_embed_2")
    _conv(sd, "input_blocks.0.0", p, "input_conv")
    if is_controlnet:
        _conv(sd, "zero_convs.0.0", p, "zero_conv_0")

    ds, ti, zi = 1, 1, 1
    for level in range(len(channel_mult)):
        for j in range(num_res_blocks):
            _unet_resblock(sd, f"input_blocks.{ti}.0", p, f"in_{ti}_res")
            if ds in attention_ds:
                _unet_st(sd, f"input_blocks.{ti}.1", p, f"in_{ti}_st")
            if is_controlnet:
                _conv(sd, f"zero_convs.{zi}.0", p, f"zero_conv_{zi}")
            ti += 1
            zi += 1
        if level != len(channel_mult) - 1:
            _conv(sd, f"input_blocks.{ti}.0.op", p, f"down_{level}")
            if is_controlnet:
                _conv(sd, f"zero_convs.{zi}.0", p, f"zero_conv_{zi}")
            ds *= 2
            ti += 1
            zi += 1

    _unet_resblock(sd, "middle_block.0", p, "mid_res1")
    _unet_st(sd, "middle_block.1", p, "mid_st")
    _unet_resblock(sd, "middle_block.2", p, "mid_res2")
    if is_controlnet:
        _conv(sd, "middle_block_out.0", p, "zero_conv_mid")
        return sd

    oi = 0
    for level in reversed(range(len(channel_mult))):
        for j in range(num_res_blocks + 1):
            _unet_resblock(sd, f"output_blocks.{oi}.0", p, f"out_{oi}_res")
            sub = 1
            if ds in attention_ds:
                _unet_st(sd, f"output_blocks.{oi}.1", p, f"out_{oi}_st")
                sub = 2
            if level and j == num_res_blocks:
                _conv(sd, f"output_blocks.{oi}.{sub}.conv", p, f"up_{level}")
                ds //= 2
            oi += 1

    _norm(sd, "out.0", p, "out_norm")
    _conv(sd, "out.2", p, "out_conv")
    return sd


def unet_kw(model_cfg: Mapping[str, Any]) -> Dict[str, Any]:
    """``unet_params_to_torch``'s options from a ``unet`` / ``controlnet`` config section."""
    return dict(channel_mult=tuple(model_cfg.get("channel_mult", (1, 2, 4, 4))),
                num_res_blocks=model_cfg.get("num_res_blocks", 2),
                attention_ds=tuple(model_cfg.get("attention_ds", (1, 2, 4))),
                is_controlnet=bool(model_cfg.get("is_controlnet", False)))


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
    for name in ("unet", "controlnet"):  # the LDM stack (configs/cldm.yaml)
        if name in params:
            out[name] = unet_params_to_torch(params[name], **unet_kw(cfg.get(name, {})))
    return out


def _train_state_tree(as_dict, params, ema, mu, nu, count: int, names: Sequence[str], step: int) -> Dict[str, Any]:
    mu_sd, nu_sd = as_dict(mu), as_dict(nu)
    return {
        "step": int(step),
        "params": as_dict(params),
        "ema": None if ema is None else as_dict(ema),
        "opt_state": {"inner": {"count": int(count),
                                "mu": [mu_sd[n] for n in names], "nu": [nu_sd[n] for n in names]}},
    }


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
    return _train_state_tree(lambda tree: pixart_params_to_torch(tree, depth=depth),
                             params, ema, mu, nu, count, names, step)


def swinir_train_state_from_jax(
    params: Mapping[str, Any],
    ema: Any,
    mu: Mapping[str, Any],
    nu: Mapping[str, Any],
    count: int,
    names: Sequence[str],
    step: int = 0,
    **swinir_kw,
) -> Dict[str, Any]:
    """The same for the single-model SwinIR training state (``--task
    swinir``); ``swinir_kw`` are ``swinir_params_to_torch``'s options
    (depths, upsampler, sf, unshuffle)."""
    return _train_state_tree(lambda tree: swinir_params_to_torch(tree, **swinir_kw),
                             params, ema, mu, nu, count, names, step)


def cldm_train_state_from_jax(
    params: Mapping[str, Any],
    ema: Any,
    mu: Mapping[str, Any],
    nu: Mapping[str, Any],
    count: int,
    names: Sequence[str],
    cfg: Mapping[str, Any],
    step: int = 0,
) -> Dict[str, Any]:
    """The same for the LDM/ControlNet training state (``--task
    cldm|reflow``): trees {'unet', 'controlnet'} in, keys ``unet.*`` and
    ``controlnet.*`` out, as the port's ``train.cldm.ControlLDM`` holds them.
    ``mu``, ``nu`` and ``ema`` are read at the trainable leaves only, which
    ``names`` lists; their other leaves may be anything."""
    def as_dict(tree):
        out = {}
        for name in ("unet", "controlnet"):
            sd = unet_params_to_torch(tree[name], **unet_kw(cfg[name]))
            out.update({f"{name}.{k}": v for k, v in sd.items()})
        return out

    state = _train_state_tree(as_dict, params, None, mu, nu, count, names, step)
    if ema is not None:
        flat = as_dict(ema)
        state["ema"] = {n: flat[n] for n in names}
    return state
