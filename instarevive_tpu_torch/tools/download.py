"""Pretrained-checkpoint locator, the port of the root ``tools/download.py``.

    python -m instarevive_tpu_torch.tools.download [--model_names NAME ...] [--model_dir output/pretrained_models]

``find_model(name)`` loads a registry name from ``--model_dir`` or an
arbitrary local path through the port's safe loader
(``pipelines/build.torch_load_safe``: ``weights_only=True``). Nothing is
downloaded: a registry name missing from ``--model_dir`` raises with the
upstream URL, so the file can be placed there by hand. The CLI reports which
registry files are present.
"""

from __future__ import annotations

import argparse
import os

# the reference's pretrained models and the InstaRevive release checkpoints named in README.md
PRETRAINED_MODELS = {
    "PixArt-Sigma-XL-2-512-MS.pth",
    "PixArt-Sigma-XL-2-256x256.pth",
    "PixArt-Sigma-XL-2-1024-MS.pth",
    "InstaRevive_v1.ckpt",
    "general_swinir_v1.ckpt",
}

_HF_BASE = "https://huggingface.co/PixArt-alpha/PixArt-Sigma/resolve/main"


def find_model(model_name: str, model_dir: str = "output/pretrained_models"):
    """The checkpoint a registry name (under ``model_dir``) or a local path
    names, as ``torch.save`` wrote it, on the CPU. A registry name whose file
    is missing raises with the upstream URL; a missing path raises too."""
    from instarevive_tpu_torch.pipelines.build import torch_load_safe

    if model_name in PRETRAINED_MODELS:
        local = os.path.join(model_dir, model_name)
        if not os.path.isfile(local):
            raise FileNotFoundError(
                f"{model_name} not found at {local}; nothing is downloaded: place the file there by hand "
                f"(upstream: {_HF_BASE}/{model_name})")
        return torch_load_safe(local)
    if not os.path.isfile(model_name):
        raise FileNotFoundError(f"Could not find PixArt checkpoint at {model_name}")
    return torch_load_safe(model_name)


def main(argv=None) -> list:
    """Print each registry name's status; returns the missing names."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model_names", nargs="+", default=sorted(PRETRAINED_MODELS))
    p.add_argument("--model_dir", default="output/pretrained_models")
    args = p.parse_args(argv)
    missing = []
    for name in sorted(set(args.model_names)):
        local = os.path.join(args.model_dir, name)
        present = os.path.isfile(local)
        if not present:
            missing.append(name)
        print(f"{name}: {'present' if present else 'MISSING'} ({local})")
    if missing:
        print(f"fetch the missing checkpoints elsewhere and place them under {args.model_dir} "
              f"(see {_HF_BASE}/<name>)")
    print("Done.")
    return missing


if __name__ == "__main__":
    main()
