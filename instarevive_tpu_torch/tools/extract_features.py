"""Pre-extract VAE latents and T5 caption features for training, the port of
the root ``tools/extract_features.py``.

    python -m instarevive_tpu_torch.tools.extract_features --input <images> --output <dir> \\
        [--config configs/instarevive_v1.yaml] [--vae_ckpt vae.pth] \\
        [--t5_dir <T5 dir> --captions captions.json] [--device cuda|cpu]

Center crops of ``--size`` go through the VAE encode (the posterior mode,
scaled) on the device in float32, as the JAX tool computes: K3 (the fused
GroupNorm+SiLU+conv), K5a/b and K1 at head dim 512 on the card. Each latent
is written by a saver thread as ``vae_feat/<name>.npz`` (key ``latent``);
with ``--t5_dir`` and ``--captions`` each caption's T5 feature as
``t5_feat/<name>.npz`` (``caption_feature``, ``attention_mask``): the files
and keys ``data/internal.InternalFeatureDataset`` reads.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import threading
from typing import Optional

import numpy as np


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])


def vae_encoder(config: str, vae_ckpt: Optional[str], device):
    """The pipeline with its VAE only, float32 on ``device``: the checkpoint's
    weights, else the seeded random init. Exits when asked for a card that
    is not there."""
    import torch

    from instarevive_tpu_torch.config import load_config
    from instarevive_tpu_torch.pipelines.build import build_pipeline, init_params, load_checkpoint, load_state_dicts

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    pipe = build_pipeline(load_config(config), device=device, components=("vae",))
    if vae_ckpt:
        return load_state_dicts(pipe, vae=load_checkpoint(vae_ckpt))
    return init_params(pipe, seed=0)


class Saver:
    """A thread that writes ``(path, arrays)`` items with
    ``np.savez_compressed`` while the device encodes the next batch."""

    def __init__(self, maxsize: int = 64):
        self.q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            path, arrays = item
            np.savez_compressed(path, **arrays)

    def put(self, path: str, **arrays) -> None:
        self.q.put((path, arrays))

    def close(self) -> None:
        self.q.put(None)
        self.thread.join()


def save_t5_features(embedder, items, out_dir: str, batch_size: int) -> int:
    """``t5_feat/<base>.npz`` for each ``(base, caption)`` of ``items``, the
    caption through ``embedder`` (a ``models.t5.T5Embedder``) in batches."""
    os.makedirs(os.path.join(out_dir, "t5_feat"), exist_ok=True)
    for k in range(0, len(items), batch_size):
        chunk = items[k:k + batch_size]
        feats, masks = embedder.get_text_embeddings([cap for _, cap in chunk])
        for (base, _), f_, m_ in zip(chunk, feats, masks):
            np.savez_compressed(os.path.join(out_dir, "t5_feat", f"{base}.npz"),
                                caption_feature=f_, attention_mask=m_)
    return len(items)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input", required=True, help="image folder / file list")
    p.add_argument("--output", required=True)
    p.add_argument("--config", default="configs/instarevive_v1.yaml")
    p.add_argument("--vae_ckpt", default=None)
    p.add_argument("--t5_dir", default=None, help="local T5 checkpoint dir")
    p.add_argument("--captions", default=None, help="json {filename: caption}")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_length", type=int, default=120)
    add_device_arg(p)
    return p.parse_args(argv)


def main(argv=None, embedder=None) -> dict:
    """Returns the counts written; ``embedder`` (a ``T5Embedder``) replaces
    the one ``--t5_dir`` names."""
    args = parse_args(argv)

    import torch

    from instarevive_tpu_torch.data.dataset import ImageFolderDataset, PrefetchLoader

    os.makedirs(os.path.join(args.output, "vae_feat"), exist_ok=True)
    pipe = vae_encoder(args.config, args.vae_ckpt, args.device)
    ds = ImageFolderDataset(args.input, out_size=args.size, crop_type="center", use_hflip=False)
    loader = PrefetchLoader(ds, args.batch_size, shuffle=False, drop_last=False)
    saver = Saver()
    i = 0
    with torch.inference_mode():
        for batch in loader:
            img = torch.from_numpy(batch["hq"]).to(args.device).float() / 255.0
            z = pipe.encode(img).float().cpu().numpy()
            for j in range(z.shape[0]):
                name = os.path.splitext(os.path.basename(ds.files[i]))[0]
                saver.put(os.path.join(args.output, "vae_feat", f"{name}.npz"), latent=z[j])
                i += 1
    saver.close()
    print(f"saved {i} VAE latents")
    counts = {"latents": i, "t5": 0}

    if (args.t5_dir or embedder is not None) and args.captions:
        from instarevive_tpu_torch.models.t5 import T5Embedder

        with open(args.captions) as f:
            caps = json.load(f)
        if embedder is None:
            embedder = T5Embedder(args.t5_dir, model_max_length=args.max_length, device=args.device)
        items = [(os.path.splitext(n)[0], cap) for n, cap in caps.items()]
        counts["t5"] = save_t5_features(embedder, items, args.output, args.batch_size)
        print(f"saved {counts['t5']} T5 features")
    return counts


if __name__ == "__main__":
    main()
