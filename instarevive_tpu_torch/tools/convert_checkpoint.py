"""Convert a foreign PyTorch checkpoint into the port's layout, the port's
``tools/convert_checkpoint.py``.

    python -m instarevive_tpu_torch.tools.convert_checkpoint --kind swinir --src general_swinir_v1.ckpt --dst swinir.pth
    python -m instarevive_tpu_torch.tools.convert_checkpoint --kind dit-diffusers --src InstaRevive_v1.ckpt --dst dit.pth
    python -m instarevive_tpu_torch.tools.convert_checkpoint --kind unet --src cldm.ckpt \\
        --prefix model.diffusion_model. --dst unet.pth

The port's modules hold the reference's native keys, so the port's layout is
the reference checkpoint less what the port computes: ``--src`` is unwrapped
as the loader unwraps it (``pipelines/build.load_checkpoint``: the first of
``state_dict``, ``state_dict_ema``, ``model``, ``module``), ``--prefix`` keeps
the keys under it and strips it, a ``module.``/``model.`` prefix on every key
goes, and the buffers the port computes go (SwinIR's relative-position
indices and attention masks, PixArt's ``pos_embed``). ``pixart`` keeps blocks
below ``--depth``; ``dit-diffusers`` joins the diffusers ``Transformer2DModel``
keys (ControlTransformerHalf's ``.base_block.`` too) into native ones
(``convert/checkpoint_layouts.py``). ``--dst`` is a flat ``torch.save`` of CPU
tensors that ``--ckpt``/``--swinir_ckpt``/``--vae_ckpt`` load. The JAX tool
writes orbax trees of the same weights.
"""

from __future__ import annotations

import argparse
from typing import Dict, Mapping, Optional

import torch

KINDS = ("swinir", "vae", "pixart", "dit-diffusers", "unet", "controlnet")
COMPUTED = ("relative_position_index", "attn_mask", "pos_embed")  # buffers the port makes itself


def convert(sd: Mapping, kind: str, prefix: Optional[str] = None, depth: int = 28) -> Dict[str, torch.Tensor]:
    """A foreign state dict of ``kind`` in the port's layout."""
    from instarevive_tpu_torch.convert.checkpoint_layouts import (
        is_diffusers_pixart, pixart_keys_from_diffusers, strip_prefixes,
    )

    if kind not in KINDS:
        raise ValueError(f"--kind {kind!r}: one of {KINDS}")
    if prefix:
        sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    sd = {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(v) for k, v in strip_prefixes(sd).items()}
    if kind == "dit-diffusers":
        if not is_diffusers_pixart(sd):
            raise ValueError("--kind dit-diffusers: the checkpoint is not in the diffusers layout")
        sd = {k.replace(".base_block.", "."): v for k, v in sd.items()}
        control = len({k.split(".")[1] for k in sd if k.startswith("controlnet.")})
        out = {}
        for native, parts in pixart_keys_from_diffusers(depth, control).items():
            if all(p in sd for p in parts):
                out[native] = torch.cat([sd[p] for p in parts]) if len(parts) > 1 else sd[parts[0]]
            elif native != "y_embedder.y_embedding":
                raise KeyError(f"the checkpoint has no {[p for p in parts if p not in sd][0]!r} (for {native!r})")
        for k in sd:
            if k.startswith("controlnet.") and ".copied_block." not in k:  # the branch's own projections
                out[k] = sd[k]
        sd = out
    else:
        sd = {k: v for k, v in sd.items() if not k.endswith(COMPUTED)}
        if kind == "pixart":
            sd = {k: v for k, v in sd.items() if not k.startswith("blocks.") or int(k.split(".")[1]) < depth}
    return {k: v.detach().cpu().contiguous() for k, v in sd.items()}


def main(argv=None) -> Dict[str, torch.Tensor]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--kind", required=True, choices=KINDS)
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p.add_argument("--prefix", default=None, help="keep the keys under this prefix and strip it")
    p.add_argument("--depth", type=int, default=28)
    args = p.parse_args(argv)

    from instarevive_tpu_torch.pipelines.build import load_checkpoint

    sd = convert(load_checkpoint(args.src), args.kind, args.prefix, args.depth)
    torch.save(sd, args.dst)
    print(f"converted {args.kind}: {args.src} -> {args.dst} ({len(sd)} tensors)")
    return sd


if __name__ == "__main__":
    main()
