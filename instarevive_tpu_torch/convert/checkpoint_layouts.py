"""The checkpoint key layouts the JAX package's CLI loads, mapped onto the
port's native keys (the reference's own: those ``from_jax`` writes and the
port's modules hold).

* ``strip_prefixes``: a ``module.`` / ``model.`` wrapper prefix that every key
  carries (DDP, Lightning), as ``instarevive_tpu/convert/torch_import.py``
  strips it before every import.
* ``is_diffusers_pixart`` / ``pixart_keys_from_diffusers``: a diffusers
  ``Transformer2DModel`` state dict, the layout of the product checkpoint
  ``InstaRevive_v1.ckpt`` (ControlTransformerHalf's ``.base_block.`` keys
  included). The map is the inverse of the JAX package's
  ``torch_import.pixart_params_from_diffusers`` composed with
  ``pixart_params_to_torch``: fused ``qkv`` and ``kv_linear`` from
  ``to_q``/``to_k``/``to_v``, and the embedders, adaLN and final layer
  renamed. It names keys only; ``pipelines.build.load_state_dicts`` joins the
  tensors.
* ``TakeKeys``: the official checkpoints of the evaluation networks (LPIPS,
  MUSIQ, MANIQA, CLIP RN50, RetinaFace), taken one key at a time, so that a
  loader raises on a key it needs and does not find, and on a key it did not
  use.

Plain Python: nothing here imports torch, JAX or the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Tuple


def strip_prefixes(sd: Mapping[str, Any], prefixes=("module.", "model.")) -> Dict[str, Any]:
    """``sd`` without a leading wrapper prefix that every key carries; each of
    ``prefixes`` in turn, as the JAX package strips them."""
    out = dict(sd)
    for p in prefixes:
        if out and all(k.startswith(p) for k in out):
            out = {k[len(p):]: v for k, v in out.items()}
    return out


def is_diffusers_pixart(sd: Mapping[str, Any]) -> bool:
    """A diffusers-layout PixArt state dict, by the JAX CLI's own test."""
    return any(k.startswith("transformer_blocks.") or ".base_block." in k for k in sd)


def pixart_keys_from_diffusers(depth: int, control_depth: int = 0) -> Dict[str, Tuple[str, ...]]:
    """Native PixArt key -> the diffusers keys (with ``.base_block.`` already
    rewritten to ``.``) whose tensors, joined along the first axis, give it.
    ``y_embedder.y_embedding`` is optional in a checkpoint. With
    ``control_depth`` the ControlNet-Half stages are named too: each copied
    block under ``controlnet.{j}.copied_block`` in the diffusers block layout,
    the projections under their native names."""
    keys: Dict[str, Tuple[str, ...]] = {}

    def linear(native: str, *parts: str) -> None:
        for leaf in ("weight", "bias"):
            keys[f"{native}.{leaf}"] = tuple(f"{p}.{leaf}" for p in parts)

    linear("x_embedder.proj", "pos_embed.proj")
    linear("t_embedder.mlp.0", "adaln_single.emb.timestep_embedder.linear_1")
    linear("t_embedder.mlp.2", "adaln_single.emb.timestep_embedder.linear_2")
    linear("t_block.1", "adaln_single.linear")
    keys["y_embedder.y_embedding"] = ("caption_projection.y_embedding",)
    linear("y_embedder.y_proj.fc1", "caption_projection.linear_1")
    linear("y_embedder.y_proj.fc2", "caption_projection.linear_2")
    def block(blk: str, tb: str) -> None:
        keys[f"{blk}.scale_shift_table"] = (f"{tb}.scale_shift_table",)
        linear(f"{blk}.attn.qkv", f"{tb}.attn1.to_q", f"{tb}.attn1.to_k", f"{tb}.attn1.to_v")
        linear(f"{blk}.attn.proj", f"{tb}.attn1.to_out.0")
        linear(f"{blk}.cross_attn.q_linear", f"{tb}.attn2.to_q")
        linear(f"{blk}.cross_attn.kv_linear", f"{tb}.attn2.to_k", f"{tb}.attn2.to_v")
        linear(f"{blk}.cross_attn.proj", f"{tb}.attn2.to_out.0")
        linear(f"{blk}.mlp.fc1", f"{tb}.ff.net.0.proj")
        linear(f"{blk}.mlp.fc2", f"{tb}.ff.net.2")

    for i in range(depth):
        block(f"blocks.{i}", f"transformer_blocks.{i}")
    for j in range(control_depth):
        block(f"controlnet.{j}.copied_block", f"controlnet.{j}.copied_block")
    keys["final_layer.scale_shift_table"] = ("scale_shift_table",)
    linear("final_layer.linear", "proj_out")
    return keys


class TakeKeys:
    """A checkpoint's state dict (wrapper prefixes stripped) that a loader
    empties key by key: ``take`` raises naming a key that is missing, and
    ``done`` raises naming every key left that no prefix or suffix of
    ``ignore`` covers (heads and buffers the network does not use)."""

    def __init__(self, sd: Mapping[str, Any], what: str):
        self.sd, self.what = strip_prefixes(sd), what

    def take(self, key: str):
        if key not in self.sd:
            raise KeyError(f"{self.what} checkpoint: missing key {key!r}; it holds {sorted(self.sd)[:20]}")
        return self.sd.pop(key)

    def done(self, ignore: Iterable[str] = ()) -> None:
        ignore = tuple(ignore)
        left = sorted(k for k in self.sd if not (k.startswith(ignore) or k.endswith(ignore)))
        if left:
            raise KeyError(f"{self.what} checkpoint: keys the loader did not use: {left[:20]}")
