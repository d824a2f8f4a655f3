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


# ------------------------------------------------------ evaluation networks
# The JAX package keeps these as flat {"a/b/kernel": array} dicts (CLIP RN50:
# flax trees); each map below gives the port's module its state dict, one
# tensor for one, with conv HWIO -> OIHW and dense (in, out) -> (out, in).


def _flat_conv(sd, torch_path, p, name, bias=True):
    sd[f"{torch_path}.weight"] = _np(p[f"{name}/kernel"]).transpose(3, 2, 0, 1)
    if bias:
        sd[f"{torch_path}.bias"] = _np(p[f"{name}/bias"])


def _flat_dense(sd, torch_path, p, name):
    sd[f"{torch_path}.weight"] = _np(p[f"{name}/kernel"]).transpose(1, 0)
    sd[f"{torch_path}.bias"] = _np(p[f"{name}/bias"])


def _flat_norm(sd, torch_path, p, name):
    sd[f"{torch_path}.weight"] = _np(p[f"{name}/scale"])
    sd[f"{torch_path}.bias"] = _np(p[f"{name}/bias"])


def lpips_params_to_torch(p: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX ``LPIPS.params`` -> ``utils.metrics.LPIPS``."""
    sd: Dict[str, np.ndarray] = {}
    for i in range(5):
        _flat_conv(sd, f"convs.{i}", p, f"conv{i}")
        sd[f"lins.{i}"] = _np(p[f"lin{i}"])
    return sd


def musiq_params_to_torch(p: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX MUSIQ params (``utils/musiq.py``, what its ``.npz`` holds) ->
    ``utils.musiq.MUSIQ``. The embedding's input axis goes from the JAX
    package's (H, W, C) flattening to the port's (C, H, W)."""
    sd: Dict[str, np.ndarray] = {}
    _flat_conv(sd, "conv_root", p, "conv_root", bias=False)
    _flat_norm(sd, "gn_root", p, "gn_root")
    for c in ("conv1", "conv2", "conv3", "downsample"):
        _flat_conv(sd, f"block1.unit1.{c}", p, f"unit1/{c}", bias=False)
    for g in ("gn1", "gn2", "gn3", "gn_proj"):
        _flat_norm(sd, f"block1.unit1.{g}", p, f"unit1/{g}")
    kernel = _np(p["embed/kernel"])  # (8 * 8 * 256, D), rows (h, w, c)
    hw = int(round((kernel.shape[0] // 256) ** 0.5))
    sd["embedding.weight"] = kernel.reshape(hw, hw, 256, -1).transpose(3, 2, 0, 1).reshape(kernel.shape[1], -1)
    sd["embedding.bias"] = _np(p["embed/bias"])
    enc = "transformer_encoder"
    sd[f"{enc}.cls_token"] = _np(p["cls"])[None]
    sd[f"{enc}.pos_emb"] = _np(p["spatial_embed"])[None]
    sd[f"{enc}.scale_emb"] = _np(p["scale_embed"])
    i = 0
    while f"block{i}/qkv/kernel" in p:
        t, b = f"{enc}.layers.{i}", f"block{i}"
        _flat_norm(sd, f"{t}.attention_norm", p, f"{b}/norm1")
        qkv, qkv_b = _np(p[f"{b}/qkv/kernel"]), _np(p[f"{b}/qkv/bias"])
        d = qkv.shape[0]
        for j, name in enumerate(("query", "key", "value")):
            sd[f"{t}.attn.{name}.weight"] = qkv[:, j * d:(j + 1) * d].T
            sd[f"{t}.attn.{name}.bias"] = qkv_b[j * d:(j + 1) * d]
        _flat_dense(sd, f"{t}.attn.out", p, f"{b}/proj")
        _flat_norm(sd, f"{t}.ffn_norm", p, f"{b}/norm2")
        _flat_dense(sd, f"{t}.ffn.fc1", p, f"{b}/mlp1")
        _flat_dense(sd, f"{t}.ffn.fc2", p, f"{b}/mlp2")
        i += 1
    _flat_norm(sd, f"{enc}.encoder_norm", p, "norm")
    _flat_dense(sd, "head", p, "head")
    return sd


def maniqa_params_to_torch(p: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX MANIQA params (``utils/maniqa.py``) -> ``utils.maniqa.MANIQA``."""
    sd: Dict[str, np.ndarray] = {}
    _flat_conv(sd, "vit.patch_embed.proj", p, "vit/patch_embed")
    sd["vit.cls_token"] = _np(p["vit/cls_token"])[None]
    sd["vit.pos_embed"] = _np(p["vit/pos_embed"])
    for i in range(12):
        t, b = f"vit.blocks.{i}", f"vit/block{i}"
        _flat_norm(sd, f"{t}.norm1", p, f"{b}/norm1")
        _flat_dense(sd, f"{t}.attn.qkv", p, f"{b}/attn/qkv")
        _flat_dense(sd, f"{t}.attn.proj", p, f"{b}/attn/proj")
        _flat_norm(sd, f"{t}.norm2", p, f"{b}/norm2")
        _flat_dense(sd, f"{t}.mlp.fc1", p, f"{b}/mlp1")
        _flat_dense(sd, f"{t}.mlp.fc2", p, f"{b}/mlp2")
    for i in range(2):
        for t, b in (("tablock1", "tab1"), ("tablock2", "tab2")):
            for qkv in ("c_q", "c_k", "c_v"):
                _flat_dense(sd, f"{t}.{i}.{qkv}", p, f"{b}_{i}/{qkv}")
    _flat_conv(sd, "conv1", p, "conv1")
    _flat_conv(sd, "conv2", p, "conv2")
    for t, b in (("swintransformer1", "swin1"), ("swintransformer2", "swin2")):
        for layer in range(2):
            for d in range(2):
                tb, bb = f"{t}.layers.{layer}.blocks.{d}", f"{b}/layer{layer}/block{d}"
                _flat_norm(sd, f"{tb}.norm1", p, f"{bb}/norm1")
                _flat_dense(sd, f"{tb}.attn.qkv", p, f"{bb}/attn/qkv")
                _flat_dense(sd, f"{tb}.attn.proj", p, f"{bb}/attn/proj")
                sd[f"{tb}.attn.relative_position_bias_table"] = _np(p[f"{bb}/attn/rel_bias_table"])
                _flat_norm(sd, f"{tb}.norm2", p, f"{bb}/norm2")
                _flat_dense(sd, f"{tb}.mlp.fc1", p, f"{bb}/mlp1")
                _flat_dense(sd, f"{tb}.mlp.fc2", p, f"{bb}/mlp2")
    for head in ("fc_score", "fc_weight"):
        _flat_dense(sd, f"{head}.0", p, f"{head}1")
        _flat_dense(sd, f"{head}.3", p, f"{head}2")
    return sd


def clip_rn50_params_to_torch(visual: Mapping[str, Any], text: Mapping[str, Any],
                              logit_scale: float) -> Dict[str, np.ndarray]:
    """The JAX CLIP RN50 towers (``models/clip_rn50.py``: the
    ``ModifiedResNet`` and ``CLIPTextTower`` param trees, BatchNorm already
    folded) and the log logit scale -> ``models.clip_rn50.CLIP``."""
    sd: Dict[str, np.ndarray] = {}
    for ci in (1, 2, 3):
        _conv(sd, f"visual.conv{ci}", visual, f"conv{ci}")
    for name in sorted(visual):
        if name.startswith("layer"):  # layer{L}_block{B}
            layer, block = name[5:].split("_block")
            for conv in ("conv1", "conv2", "conv3", "downsample"):
                if conv in visual[name]:
                    _conv(sd, f"visual.layer{layer}.{block}.{conv}", visual, f"{name}/{conv}")
    sd["visual.attnpool.positional_embedding"] = _np(_get(visual, "attnpool/positional_embedding"))
    for proj in ("q_proj", "k_proj", "v_proj", "c_proj"):
        _dense(sd, f"visual.attnpool.{proj}", visual, f"attnpool/{proj}")
    sd["token_embedding.weight"] = _np(text["token_embedding"])
    sd["positional_embedding"] = _np(text["positional_embedding"])
    i = 0
    while f"resblock_{i}" in text:
        t, b = f"transformer.resblocks.{i}", f"resblock_{i}"
        _norm(sd, f"{t}.ln_1", text, f"{b}/ln_1")
        _norm(sd, f"{t}.ln_2", text, f"{b}/ln_2")
        sd[f"{t}.attn.in_proj_weight"] = _np(_get(text, f"{b}/in_proj/kernel")).transpose(1, 0)
        sd[f"{t}.attn.in_proj_bias"] = _np(_get(text, f"{b}/in_proj/bias"))
        _dense(sd, f"{t}.attn.out_proj", text, f"{b}/out_proj")
        _dense(sd, f"{t}.mlp.c_fc", text, f"{b}/c_fc")
        _dense(sd, f"{t}.mlp.c_proj", text, f"{b}/c_proj")
        i += 1
    _norm(sd, "ln_final", text, "ln_final")
    sd["text_projection"] = _np(text["text_projection"])
    sd["logit_scale"] = np.asarray(logit_scale, np.float32)
    return sd


def retinaface_params_to_torch(p: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX RetinaFace params (``utils/retinaface.py``, BatchNorm folded)
    -> ``utils.retinaface.RetinaFaceNet``: a body conv ``stage{s}/{i}`` (or
    its ``_dw``/``_pw`` pair) to ``body.stage{s}.{i}.0`` (and ``.3``), the
    FPN's and SSH's convs to index 0 of their Sequential."""
    sd: Dict[str, np.ndarray] = {}
    for name in {k.rsplit("/", 1)[0] for k in p}:
        parts = name.split("/")
        if parts[0].startswith("stage"):
            i, _, kind = parts[1].partition("_")
            _flat_conv(sd, f"body.{parts[0]}.{i}.{3 if kind == 'pw' else 0}", p, name)
        elif parts[0].endswith("Head"):
            _flat_conv(sd, f"{parts[0]}.{parts[1]}.conv1x1", p, name)
        else:
            _flat_conv(sd, f"{'.'.join(parts)}.0", p, name)
    return sd


# ----------------------------------------------- RRDBNet, MiDaS, LLaVA-MPT
# The inverses of the JAX importers' key maps (``rrdbnet`` keeps flax's own
# names; ``dpt_params_from_torch``, ``midas_v21_params_from_torch``,
# ``midas_v21_small_params_from_torch``, ``mpt_params_from_torch``): the JAX
# params -> the port's modules, whose names are the official checkpoints'
# (folded convolutions keep the bias the fold gave them).


def _conv_nobias(sd, torch_path, tree, flax_path):
    sd[torch_path + ".weight"] = _np(_get(tree, flax_path + "/kernel")).transpose(3, 2, 0, 1)


def rrdbnet_params_to_torch(p: Mapping[str, Any], num_block: int) -> Dict[str, np.ndarray]:
    """The JAX ``RRDBNet`` params -> ``models.rrdbnet.RRDBNet``."""
    sd: Dict[str, np.ndarray] = {}
    for name in ("conv_first", "conv_body", "conv_up1", "conv_up2", "conv_hr", "conv_last"):
        _conv(sd, name, p, name)
    for i in range(num_block):
        for r in (1, 2, 3):
            for c in range(1, 6):
                _conv(sd, f"body.{i}.rdb{r}.conv{c}", p, f"body_{i}/rdb{r}/conv{c}")
    return sd


def _midas_scratch(sd, p, out_conv: bool):
    for li in range(1, 5):
        _conv_nobias(sd, f"scratch.layer{li}_rn", p, f"layer{li}_rn")
    for ri in range(1, 5):
        units = (2,) if ri == 4 else (1, 2)
        for u in units:
            for c in (1, 2):
                _conv(sd, f"scratch.refinenet{ri}.resConfUnit{u}.conv{c}", p, f"refinenet{ri}/rcu{u}/conv{c}")
        if out_conv:
            _conv(sd, f"scratch.refinenet{ri}.out_conv", p, f"refinenet{ri}/out_conv")
    for idx, name in ((0, "head_conv1"), (2, "head_conv2"), (4, "head_conv3")):
        _conv(sd, f"scratch.output_conv.{idx}", p, name)


def dpt_params_to_torch(p: Mapping[str, Any], cfg) -> Dict[str, np.ndarray]:
    """The JAX ``DPTDepthModel`` params -> ``models.dpt.DPTDepthModel``
    (``cfg`` a ``DPTConfig`` of either package). The dense up-projection and
    depth-to-space go back to a ``ConvTranspose2d`` (I, O, k, k)."""
    vit, sd = "pretrained.model.", {}
    sd[vit + "cls_token"], sd[vit + "pos_embed"] = _np(p["cls_token"]), _np(p["pos_embed"])
    kernel, d = _np(p["patch_proj"]["kernel"]), cfg.vit_dim
    if cfg.hybrid:
        bb = vit + "patch_embed.backbone."
        _conv_nobias(sd, bb + "stem.conv", p, "backbone/stem_conv")
        _norm(sd, bb + "stem.norm", p, "backbone/stem_norm/gn")
        for si, depth in enumerate(cfg.rn_layers):
            for bi in range(depth):
                tb, fb = f"{bb}stages.{si}.blocks.{bi}.", f"backbone/stage{si}_block{bi}"
                for c in (1, 2, 3):
                    _conv_nobias(sd, f"{tb}conv{c}", p, f"{fb}/conv{c}")
                    _norm(sd, f"{tb}norm{c}", p, f"{fb}/norm{c}/gn")
                if _has(p, f"{fb}/downsample_conv"):
                    _conv_nobias(sd, tb + "downsample.conv", p, f"{fb}/downsample_conv")
                    _norm(sd, tb + "downsample.norm", p, f"{fb}/downsample_norm/gn")
        sd[vit + "patch_embed.proj.weight"] = kernel.T[:, :, None, None]
    else:
        k = cfg.patch
        sd[vit + "patch_embed.proj.weight"] = kernel.reshape(k, k, -1, d).transpose(3, 2, 0, 1)
    sd[vit + "patch_embed.proj.bias"] = _np(p["patch_proj"]["bias"])
    for i in range(cfg.vit_depth):
        tb, fb = f"{vit}blocks.{i}.", f"block{i}"
        for n in ("norm1", "norm2"):
            _norm(sd, tb + n, p, f"{fb}/{n}")
        for t, f in (("attn.qkv", "qkv"), ("attn.proj", "proj"), ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
            _dense(sd, tb + t, p, f"{fb}/{f}")
    for li in range(2 if cfg.hybrid else 0, 4):
        ap, fb = f"pretrained.act_postprocess{li + 1}.", f"post{li + 1}"
        if cfg.readout == "project":
            _dense(sd, ap + "0.project.0", p, f"{fb}/readout/project")
        _conv(sd, ap + "3", p, f"{fb}/conv")
        if li < 2:
            up, c = _np(_get(p, f"{fb}/up/kernel")), cfg.layer_chs[li]
            k = 4 // (li + 1)
            sd[ap + "4.weight"] = up.reshape(c, k, k, c).transpose(0, 3, 1, 2)
            sd[ap + "4.bias"] = _np(_get(p, f"{fb}/up/bias"))[:c]
        elif li == 3:
            _conv(sd, ap + "4", p, f"{fb}/down")
    _midas_scratch(sd, p, out_conv=True)
    return sd


def midas_v21_params_to_torch(p: Mapping[str, Any], layers=(3, 4, 23, 3)) -> Dict[str, np.ndarray]:
    """The JAX ``MidasNet`` params (BatchNorms folded) -> ``models.dpt.MidasNet``."""
    sd: Dict[str, np.ndarray] = {}
    _conv(sd, "pretrained.layer1.0", p, "backbone/stem_conv")
    for si, depth in enumerate(layers):
        base = f"pretrained.layer{si + 1}." + ("4." if si == 0 else "")
        for bi in range(depth):
            fb = f"backbone/layer{si + 1}_block{bi}"
            for c in (1, 2, 3):
                _conv(sd, f"{base}{bi}.conv{c}", p, f"{fb}/conv{c}")
            if _has(p, f"{fb}/downsample"):
                _conv(sd, f"{base}{bi}.downsample.0", p, f"{fb}/downsample")
    _midas_scratch(sd, p, out_conv=False)
    return sd


def midas_v21_small_params_to_torch(p: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX ``MidasNetSmall`` params -> ``models.dpt.MidasNetSmall``."""
    from instarevive_tpu_torch.models.dpt import LITE3_SLOTS, LITE3_STAGES

    sd: Dict[str, np.ndarray] = {}
    _conv(sd, "pretrained.layer1.0", p, "backbone/conv_stem")
    for si, (reps, _, _, _, e) in enumerate(LITE3_STAGES):
        for bi in range(reps):
            for name in (("conv_dw", "conv_pw") if e == 1 else ("conv_pw", "conv_dw", "conv_pwl")):
                _conv(sd, f"pretrained.{LITE3_SLOTS[si]}.{bi}.{name}", p, f"backbone/stage{si}_block{bi}/{name}")
    _midas_scratch(sd, p, out_conv=True)
    return sd


def mpt_params_to_torch(p: Mapping[str, Any], n_layers: int) -> Dict[str, np.ndarray]:
    """The JAX ``MPTModel`` params -> ``models.llava_mpt.MPTModel`` (the
    MPT checkpoint's names: ``wte``, ``blocks.N.norm_1``, ``attn.Wqkv``,
    ``ffn.up_proj``, ...); biases and the LayerNorms' shifts only where the
    JAX params hold them (``no_bias``), RMSNorm's ``scale`` as ``weight``."""
    sd: Dict[str, np.ndarray] = {"wte.weight": _np(p["wte"]["embedding"])}
    if "wpe" in p:
        sd["wpe.weight"] = _np(p["wpe"]["embedding"])

    def norm(torch_path, tree):
        sd[torch_path + ".weight"] = _np(tree["scale"])
        if "bias" in tree:
            sd[torch_path + ".bias"] = _np(tree["bias"])

    def dense(torch_path, tree):
        sd[torch_path + ".weight"] = _np(tree["kernel"]).T
        if "bias" in tree:
            sd[torch_path + ".bias"] = _np(tree["bias"])

    for i in range(n_layers):
        blk, tb = p[f"block{i}"], f"blocks.{i}."
        norm(tb + "norm_1", blk["norm1"])
        norm(tb + "norm_2", blk["norm2"])
        dense(tb + "attn.Wqkv", blk["attn"]["Wqkv"])
        dense(tb + "attn.out_proj", blk["attn"]["out_proj"])
        for ln in ("q_ln", "k_ln"):
            if ln in blk["attn"]:
                norm(f"{tb}attn.{ln}", blk["attn"][ln])
        dense(tb + "ffn.up_proj", blk["up_proj"])
        dense(tb + "ffn.down_proj", blk["down_proj"])
    norm("norm_f", p["norm_f"])
    if "mm_projector" in p:
        dense("mm_projector", p["mm_projector"])
    return sd
