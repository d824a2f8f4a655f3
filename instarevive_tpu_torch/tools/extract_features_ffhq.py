"""Pre-extract VAE latents (and T5 features) for a ``data_info.json``
manifest with aspect-ratio buckets, the port of the root
``tools/extract_features_ffhq.py``.

    python -m instarevive_tpu_torch.tools.extract_features_ffhq --root <images> \\
        --data_info data_info.json --output <dir> [--resolution 512] [--t5_dir <T5 dir>] \\
        [--vae_ckpt vae.pth] [--device cuda|cpu]

Each entry goes to the bucket whose h/w ratio is closest to its own (the
512 table scaled to ``--resolution``), is resized bicubic (PIL's filter) to
cover the bucket and center-cropped; a bucket's images are encoded in
batches, so each bucket shape is one set of kernel shapes. Each latent is
saved as ``vae_feat/<name>.npz`` with ``img_hw`` and ``aspect_ratio``; with
``--t5_dir`` each entry's ``prompt`` as ``t5_feat/<name>.npz``.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict

import numpy as np


def parse_args(argv=None):
    from instarevive_tpu_torch.tools.extract_features import add_device_arg

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", required=True, help="dataset root (images)")
    p.add_argument("--data_info", required=True, help="data_info.json manifest")
    p.add_argument("--output", required=True)
    p.add_argument("--config", default="configs/instarevive_v1.yaml")
    p.add_argument("--vae_ckpt", default=None)
    p.add_argument("--t5_dir", default=None, help="local T5 checkpoint dir")
    p.add_argument("--resolution", type=int, default=512, choices=(256, 512, 1024))
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_length", type=int, default=120)
    p.add_argument("--start_index", type=int, default=0)
    p.add_argument("--end_index", type=int, default=100_000_000)
    p.add_argument("--max_ratio", type=float, default=4.5, help="drop images with aspect ratio above this")
    add_device_arg(p)
    return p.parse_args(argv)


def bucket_table(resolution: int) -> dict:
    """h/w ratio -> (h, w) of the 512 table scaled to ``resolution``, each
    side a multiple of 64."""
    from instarevive_tpu_torch.data.dataset import ASPECT_RATIO_512

    scale = resolution / 512
    return {r: (int(h * scale) // 64 * 64 or 64, int(w * scale) // 64 * 64 or 64)
            for r, (h, w) in ASPECT_RATIO_512.items()}


def main(argv=None, embedder=None) -> dict:
    """Returns the images per bucket and the counts written; ``embedder`` (a
    ``T5Embedder``) replaces the one ``--t5_dir`` names."""
    args = parse_args(argv)

    import torch
    from PIL import Image

    from instarevive_tpu_torch.ops.resize import pil_resize_bicubic
    from instarevive_tpu_torch.tools.extract_features import Saver, save_t5_features, vae_encoder

    table = bucket_table(args.resolution)
    with open(args.data_info) as f:
        meta = [m for m in json.load(f) if m.get("ratio", 1.0) <= args.max_ratio]
    meta = meta[args.start_index:args.end_index]
    print(f"{len(meta)} entries from {args.data_info}")

    pipe = vae_encoder(args.config, args.vae_ckpt, args.device)
    os.makedirs(os.path.join(args.output, "vae_feat"), exist_ok=True)
    saver = Saver()

    keys = np.asarray(sorted(table.keys()))
    buckets = defaultdict(list)
    for m in meta:
        r = m["height"] / m["width"]
        bh, bw = table[float(keys[np.argmin(np.abs(keys - r))])]
        buckets[(int(bh), int(bw))].append(m)

    n_saved, per_bucket = 0, {}
    with torch.inference_mode():
        for (bh, bw), items in sorted(buckets.items()):
            for k in range(0, len(items), args.batch_size):
                chunk = items[k:k + args.batch_size]
                imgs, infos = [], []
                for m in chunk:
                    img = Image.open(os.path.join(args.root, m["path"])).convert("RGB")
                    h, w = img.size[1], img.size[0]
                    s = max(bh / h, bw / w)  # cover the bucket, then center crop
                    rh, rw = max(int(round(h * s)), bh), max(int(round(w * s)), bw)
                    arr = torch.from_numpy(np.asarray(img, np.float32) / 255.0).to(args.device)
                    arr = pil_resize_bicubic(arr[None], (rh, rw))[0]
                    top, left = (rh - bh) // 2, (rw - bw) // 2
                    imgs.append(arr[top:top + bh, left:left + bw])
                    infos.append((m, h, w))
                z = pipe.encode(torch.stack(imgs)).float().cpu().numpy()
                for (m, h, w), zi in zip(infos, z):
                    base = os.path.splitext(os.path.basename(m["path"]))[0]
                    saver.put(os.path.join(args.output, "vae_feat", f"{base}.npz"), latent=zi,
                              img_hw=np.asarray([h, w], np.float32), aspect_ratio=np.float32(bh / bw))
                    n_saved += 1
            per_bucket[(bh, bw)] = len(items)
            print(f"bucket {bh}x{bw}: {len(items)} images")
    saver.close()
    print(f"saved {n_saved} VAE latents")
    counts = {"latents": n_saved, "t5": 0, "buckets": per_bucket}

    if args.t5_dir or embedder is not None:
        from instarevive_tpu_torch.models.t5 import T5Embedder

        if embedder is None:
            embedder = T5Embedder(args.t5_dir, model_max_length=args.max_length, device=args.device)
        items = [(os.path.splitext(os.path.basename(m["path"]))[0], m.get("prompt", "")) for m in meta]
        counts["t5"] = save_t5_features(embedder, items, args.output, args.batch_size)
        print(f"saved {counts['t5']} T5 features")
    return counts


if __name__ == "__main__":
    main()
