"""Export a checkpoint of the port to a flat reference-layout state dict (.pth),
the port's ``tools/export_checkpoint.py``.

    python -m instarevive_tpu_torch.tools.export_checkpoint --kind pixart --src runs/dmd/final --dst dit.pth
    python -m instarevive_tpu_torch.tools.export_checkpoint --kind pixart --src runs/dmd/final --weights ema \\
        --dst dit_ema.pth
    python -m instarevive_tpu_torch.tools.export_checkpoint --kind dit-diffusers --src runs/dmd/final --dst dit_d.pth
    python -m instarevive_tpu_torch.tools.export_checkpoint --kind swinir --src runs/swinir/final --dst swinir.pth
    python -m instarevive_tpu_torch.tools.export_checkpoint --kind controlnet --src runs/cldm/final --dst cn.pth

``--src`` is a full train state the port's trainer wrote (``{"states",
"rng", "step_i"}``, in the one-card layout at any world size:
``--state_index`` picks the model, 0 the generator, 1 DMD's fake score;
``--weights ema`` takes the EMA of the trained weights), a legacy ``{"params",
"ema"}`` checkpoint, or a flat state dict. The port's modules hold the
reference's native keys, so ``swinir``, ``vae``, ``pixart`` and ``unet`` write
them as they are; ``dit-diffusers`` renames and splits them into the
diffusers ``Transformer2DModel`` layout (the inverse of
``convert/checkpoint_layouts.pixart_keys_from_diffusers``); ``unet`` and
``controlnet`` take their half of a cldm state (keys under ``unet.`` /
``controlnet.``). ``--dst`` is a ``torch.save`` of CPU tensors. The JAX tool
exports from orbax trees; on the same weights the two write the same dict.
"""

from __future__ import annotations

import argparse
from typing import Dict, Mapping

import torch

KINDS = ("swinir", "vae", "pixart", "dit-diffusers", "unet", "controlnet")


def select_weights(tree: Mapping, state_index: int = 0, weights: str = "params") -> Dict[str, torch.Tensor]:
    """A model's state dict from any of the three checkpoint layouts; with
    ``weights='ema'`` the EMA takes the place of each trained weight (the
    buffers and the frozen weights are the state's own)."""
    if "states" in tree:  # a full train state
        state = tree["states"][state_index]
        if not isinstance(state, Mapping) or "params" not in state:
            raise SystemExit(f"checkpoint state {state_index} is not a model's train state")
        params, ema = state["params"], state.get("ema")
    elif set(tree) <= {"params", "ema"}:  # legacy
        params, ema = tree.get("params"), tree.get("ema")
    else:  # a flat state dict
        if weights == "ema":
            raise SystemExit("a flat state dict has no 'ema' weights")
        return dict(tree)
    if weights == "ema":
        if ema is None:
            raise SystemExit(f"the checkpoint has no 'ema' weights for state {state_index}")
        return {**params, **ema}
    if params is None:
        raise SystemExit("the checkpoint has no 'params' weights")
    return dict(params)


def pixart_to_diffusers(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A native PixArt state dict in the diffusers layout: the fused ``qkv`` and
    ``kv_linear`` split into ``to_q``/``to_k``/``to_v`` along dim 0, the rest
    renamed (``caption_projection.y_embedding`` included)."""
    from instarevive_tpu_torch.convert.checkpoint_layouts import pixart_keys_from_diffusers

    depth = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    control = len({k.split(".")[1] for k in sd if k.startswith("controlnet.")})
    out = {}
    for native, parts in pixart_keys_from_diffusers(depth, control).items():
        if native not in sd:
            continue
        for key, value in zip(parts, torch.chunk(sd[native], len(parts), dim=0)):
            out[key] = value.contiguous()
    return out


def export(tree: Mapping, kind: str, state_index: int = 0, weights: str = "params") -> Dict[str, torch.Tensor]:
    """The flat reference-layout state dict of ``kind`` in a loaded checkpoint."""
    if kind not in KINDS:
        raise ValueError(f"--kind {kind!r}: one of {KINDS}")
    sd = select_weights(tree, state_index, weights)
    if kind in ("unet", "controlnet") and any(k.startswith(f"{kind}.") for k in sd):
        sd = {k[len(kind) + 1:]: v for k, v in sd.items() if k.startswith(f"{kind}.")}
    if kind == "dit-diffusers":
        sd = pixart_to_diffusers(sd)
    return {k: (v if isinstance(v, torch.Tensor) else torch.as_tensor(v)).detach().cpu().contiguous()
            for k, v in sd.items()}


def main(argv=None) -> Dict[str, torch.Tensor]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--kind", required=True, choices=KINDS)
    p.add_argument("--src", required=True, help="the port's checkpoint (a directory holding state.pt, or a file)")
    p.add_argument("--dst", required=True, help="output .pth path")
    p.add_argument("--state_index", type=int, default=0,
                   help="which train state of a full checkpoint (0 = generator, 1 = DMD's fake score)")
    p.add_argument("--weights", choices=["params", "ema"], default="params")
    args = p.parse_args(argv)

    from instarevive_tpu_torch.train.checkpoint import load_checkpoint

    sd = export(load_checkpoint(args.src), args.kind, args.state_index, args.weights)
    torch.save(sd, args.dst)
    print(f"exported {args.kind}: {args.src} -> {args.dst} ({len(sd)} tensors)")
    return sd


if __name__ == "__main__":
    main()
