"""One-step blind restoration CLI, the PyTorch port of ``inference.py``.

    python -m instarevive_tpu_torch.inference --input in/ --output out/ \\
        --random_init [--device cuda|cpu] [--tiled --tile_auto] \\
        [--color_fix_type wavelet|adain|none] [--config configs/instarevive_v1.yaml]

Same flags as the JAX CLI. On CUDA the models compute in bf16 (``--bf16``
asks for it on the CPU too). Weight files are the state dicts the JAX CLI
loads (``pipelines.build.load_checkpoint`` and ``load_state_dicts``: native
or diffusers keys, wrapped or prefixed); ``--random_init`` gives seeded
random weights.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def add_model_args(p: argparse.ArgumentParser) -> None:
    """The flags ``load_pipeline`` reads, shared by every entry point."""
    p.add_argument("--config", type=str, default="configs/instarevive_v1.yaml")
    p.add_argument("--ckpt", type=str, default=None,
                   help="DiT state dict: reference native keys or the diffusers layout (InstaRevive_v1.ckpt)")
    p.add_argument("--swinir_ckpt", type=str, default=None)
    p.add_argument("--vae_ckpt", type=str, default=None)
    p.add_argument("--null_embed", type=str, default=None, help="cached T5 null-prompt embedding")
    p.add_argument("--random_init", action="store_true",
                   help="seeded random weights (smoke runs without checkpoints)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--bf16", action="store_true", help="bf16 compute on the CPU too")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(p)
    p.add_argument("--input", type=str, required=True)
    p.add_argument("--output", type=str, required=True)
    p.add_argument("--sr_scale", type=float, default=1.0)
    p.add_argument("--repeat_times", type=int, default=1)
    p.add_argument("--disable_preprocess_model", action="store_true")
    p.add_argument("--tiled", action="store_true")
    p.add_argument("--tile_size", type=int, default=512)
    p.add_argument("--tile_stride", type=int, default=448)
    p.add_argument("--tile_auto", action="store_true",
                   help="pick tile_size/tile_stride per image size to minimize overlap work")
    p.add_argument("--color_fix_type", type=str, default="wavelet",
                   choices=["wavelet", "adain", "none"])
    p.add_argument("--show_lq", action="store_true")
    p.add_argument("--skip_if_exist", action="store_true")
    p.add_argument("--seed", type=int, default=231)
    p.add_argument("--use_center_crop", action="store_true")
    return p.parse_args(argv)


def load_pipeline(args, control_depth: int = 0):
    """What every entry point of the port builds from its flags (``config``,
    ``device``, ``bf16``, ``random_init``, the checkpoint paths,
    ``null_embed``): the pipeline on the device, in bf16 on the card, with its
    weights (and ``control_depth`` ControlNet-Half stages), and the (1, L, C)
    null-prompt embedding ``y``. Exits when asked for a card that is not
    there."""
    import torch

    from instarevive_tpu_torch.config import load_config
    from instarevive_tpu_torch.pipelines.build import (
        build_pipeline, init_params, load_checkpoint, load_state_dicts,
    )

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    device = torch.device(args.device)
    dtype = torch.bfloat16 if (args.bf16 or args.device == "cuda") else None
    pipe = build_pipeline(load_config(args.config), dtype=dtype, device=device, control_depth=control_depth)
    init_params(pipe, seed=0)
    if not args.random_init:
        if not (args.ckpt or args.swinir_ckpt or args.vae_ckpt):
            print("[warn] no checkpoints given; using seeded random init", file=sys.stderr)
        load_state_dicts(
            pipe,
            swinir=load_checkpoint(args.swinir_ckpt) if args.swinir_ckpt else None,
            vae=load_checkpoint(args.vae_ckpt) if args.vae_ckpt else None,
            dit=load_checkpoint(args.ckpt) if args.ckpt else None,
        )

    L = pipe.dit.model_max_length
    if args.null_embed:
        from instarevive_tpu_torch.train.checkpoint import load_null_embed

        y = load_null_embed(args.null_embed)[None]
        if y.shape[1] != L:
            y = y[:, :L] if y.shape[1] > L else np.pad(y, ((0, 0), (0, L - y.shape[1]), (0, 0)))
        y = torch.from_numpy(y).to(device)
    else:
        # the checkpoint's learned unconditional caption embedding
        y = pipe.dit.y_embedder.y_embedding[:L][None].float()
    return pipe, y


def main(argv=None):
    args = parse_args(argv)

    import torch
    from PIL import Image

    from instarevive_tpu_torch.pipelines.restore import auto_tile_geometry
    from instarevive_tpu_torch.utils.image_io import (
        auto_resize, center_crop_arr, list_image_files, load_image, pad_to_multiple, save_image,
    )

    pipe, y = load_pipeline(args)
    device = y.device

    os.makedirs(args.output, exist_ok=True)
    files = list_image_files(args.input) if os.path.isdir(args.input) else [args.input]
    print(f"[inference] {len(files)} images -> {args.output}")

    for path in files:
        name = os.path.splitext(os.path.basename(path))[0]
        for i in range(args.repeat_times):
            out_path = os.path.join(
                args.output, f"{name}.png" if args.repeat_times == 1 else f"{name}_{i}.png"
            )
            if args.skip_if_exist and os.path.exists(out_path):
                continue
            lq = load_image(path)
            if args.sr_scale != 1:
                lq = lq.resize(tuple(int(x * args.sr_scale) for x in lq.size), Image.BICUBIC)
            if args.use_center_crop:
                x = center_crop_arr(lq, 512)
                lq_resized = None
                th, tw = 512, 512
            else:
                lq_resized = auto_resize(lq, args.tile_size if args.tiled else 512)
                x = pad_to_multiple(np.array(lq_resized), 64)
                th, tw = lq_resized.height, lq_resized.width

            x01 = torch.from_numpy(x[None].astype(np.float32) / 255.0).to(device)
            h, w = x01.shape[1:3]
            tile, stride = args.tile_size, args.tile_stride
            if args.tiled and args.tile_auto:
                tile, stride = auto_tile_geometry(h, w)
            t0 = time.time()
            kw = dict(use_swinir=not args.disable_preprocess_model, color_fix=args.color_fix_type)
            if args.tiled and min(h, w) > tile:
                pred = pipe.process_tiled(x01, y, tile_size=tile, tile_stride=stride, **kw)
            else:
                pred = pipe.process(x01, y, **kw)
            pred = pred[0, :th, :tw].cpu().numpy()
            dt = time.time() - t0
            if args.show_lq and lq_resized is not None:
                lq_arr = np.array(lq_resized).astype(np.float32)[..., :3] / 255.0
                pred = np.concatenate([lq_arr[:th, :tw], pred], axis=1)
            save_image(pred, out_path)
            print(f"  {out_path}  ({th}x{tw}, {dt:.2f}s)")


if __name__ == "__main__":
    main()
