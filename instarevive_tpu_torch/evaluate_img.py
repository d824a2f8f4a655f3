"""Image-quality evaluation CLI, the PyTorch port of ``evaluate_img.py``.

    python -m instarevive_tpu_torch.evaluate_img --folder out/ [--ref_folder gt/] [--device cuda|cpu] \\
        [--lpips_ckpt alex.pth --alexnet_ckpt alexnet.pth] [--niqe_params p.npz | --niqe_fit pristine/] \\
        [--musiq_params musiq.npz] [--maniqa_ckpt ckpt.pt] [--clipiqa_model RN50.pt --clipiqa_tokenizer dir]

The flags of the JAX CLI, plus ``--device`` (the card by default; exits when
there is none). With ``--ref_folder`` each image is paired with the
reference of the same name (or the same stem), both cropped to their common
size: PSNR and SSIM on the Y channel (``--crop_border``), and LPIPS with its
two checkpoints. No-reference: NIQE (on the host, from the basicsr/pyiqa
``.npz`` or fitted on a folder of pristine images), MUSIQ (the JAX package's
``.npz``), MANIQA (the official checkpoint) and CLIP-IQA (an OpenAI RN50
``.pt`` with a Hugging Face tokenizer directory, or an HF CLIP directory;
both need ``transformers``). Every network runs on the device in f32. Prints
``name: mean  (n=k)`` for each metric it computed.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np

METRICS = ("psnr", "ssim", "lpips", "niqe", "clipiqa", "musiq", "maniqa")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-folder", "--folder", required=True, help="output images")
    p.add_argument("-ref_folder", "--ref_folder", default=None, help="ground-truth images")
    p.add_argument("--crop_border", type=int, default=4)
    p.add_argument("--y_channel", action="store_true", default=True)
    p.add_argument("--lpips_ckpt", default=None)
    p.add_argument("--alexnet_ckpt", default=None)
    p.add_argument("--niqe_params", default=None, help="niqe_pris_params.npz (basicsr/pyiqa format)")
    p.add_argument("--niqe_fit", default=None, help="folder of pristine images to fit a NIQE model from")
    p.add_argument("--musiq_params", default=None, help="MUSIQ weights .npz (the JAX package's format)")
    p.add_argument("--maniqa_ckpt", default=None, help="official MANIQA torch checkpoint (with its ViT-B/8 trunk)")
    p.add_argument("--clipiqa_model", default=None,
                   help="CLIP weights for CLIP-IQA: an OpenAI CLIP RN50 state dict .pt/.pth or a local HF CLIP dir")
    p.add_argument("--clipiqa_tokenizer", default=None,
                   help="local HF CLIP tokenizer dir (required with an RN50 state dict)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def build_metrics(args, device) -> Dict[str, Callable]:
    """The networks and models the flags ask for, on ``device``: 'lpips' a
    module on (pred, target) [-1, 1] NHWC tensors; 'niqe', 'clipiqa',
    'musiq', 'maniqa' callables on one (1, H, W, 3) [0, 1] image -> float."""
    from PIL import Image

    from instarevive_tpu_torch.convert import from_jax
    from instarevive_tpu_torch.nn.layers import load_built
    from instarevive_tpu_torch.pipelines.build import load_checkpoint
    from instarevive_tpu_torch.utils.image_io import list_image_files

    out: Dict[str, Callable] = {}
    if args.lpips_ckpt and args.alexnet_ckpt:
        from instarevive_tpu_torch.utils.metrics import LPIPS, lpips_state_dict

        out["lpips"] = load_built(LPIPS, lpips_state_dict(load_checkpoint(args.alexnet_ckpt),
                                                          load_checkpoint(args.lpips_ckpt)), device)
    if args.niqe_params or args.niqe_fit:
        from instarevive_tpu_torch.utils.niqe import fit_pristine_model, load_pris_params, niqe

        if args.niqe_params:
            pris = load_pris_params(args.niqe_params)
        else:
            pris = fit_pristine_model([np.asarray(Image.open(f).convert("L"), np.float64)
                                       for f in list_image_files(args.niqe_fit)])
        out["niqe"] = lambda img: niqe(img[0], pris)
    if args.clipiqa_model:
        from instarevive_tpu_torch.utils.clipiqa import CLIPIQA

        clip = CLIPIQA(model_dir=args.clipiqa_model, tokenizer_dir=args.clipiqa_tokenizer, device=device)
        out["clipiqa"] = lambda img: float(clip(img)[0])
    if args.musiq_params:
        from instarevive_tpu_torch.utils.musiq import MUSIQ, params_from_npz

        musiq = MUSIQ.from_state_dict(from_jax.musiq_params_to_torch(params_from_npz(args.musiq_params)), device)
        out["musiq"] = lambda img: float(musiq.score(img)[0])
    if args.maniqa_ckpt:
        from instarevive_tpu_torch.utils.maniqa import MANIQA, state_dict_from_torch

        maniqa = load_built(MANIQA, state_dict_from_torch(load_checkpoint(args.maniqa_ckpt)), device)
        out["maniqa"] = lambda img: float(maniqa.score(img)[0])
    return out


def find_reference(path: str, ref_folder: str) -> Optional[str]:
    """The reference of the same name, else the first of the same stem."""
    from instarevive_tpu_torch.utils.image_io import list_image_files

    ref = os.path.join(ref_folder, os.path.basename(path))
    if os.path.exists(ref):
        return ref
    base = os.path.splitext(os.path.basename(path))[0]
    cands = [c for c in list_image_files(ref_folder) if os.path.splitext(os.path.basename(c))[0] == base]
    return cands[0] if cands else None


def evaluate(files: List[str], metrics: Dict[str, Callable], device, ref_folder: Optional[str] = None,
             crop_border: int = 4, y_channel: bool = True, seconds: Optional[Dict[str, List[float]]] = None
             ) -> Dict[str, List[float]]:
    """Every metric of ``metrics`` (``build_metrics``) on each image of
    ``files``, PSNR and SSIM (and LPIPS) against ``ref_folder`` where it
    holds the image's reference. Returns {metric: per-image values}; with
    ``seconds``, each call's wall time (to a synchronise) is appended there
    under its metric."""
    import torch
    from PIL import Image

    from instarevive_tpu_torch.utils.metrics import psnr, ssim

    def timed(name: str, fn: Callable[[], float]) -> float:
        t = time.perf_counter()
        value = fn()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        if seconds is not None:
            seconds.setdefault(name, []).append(time.perf_counter() - t)
        return value

    def load(path: str) -> np.ndarray:
        return np.asarray(Image.open(path).convert("RGB"), np.float32)[None] / 255.0

    results: Dict[str, List[float]] = {k: [] for k in METRICS}
    with torch.no_grad():
        for f in files:
            img = load(f)
            for name in ("niqe", "clipiqa", "musiq", "maniqa"):
                if name in metrics:
                    results[name].append(timed(name, lambda: metrics[name](img)))
            ref_path = find_reference(f, ref_folder) if ref_folder else None
            if ref_path is None:
                continue
            ref = load(ref_path)
            hh, ww = min(img.shape[1], ref.shape[1]), min(img.shape[2], ref.shape[2])
            a = torch.from_numpy(np.ascontiguousarray(img[:, :hh, :ww])).to(device)
            b = torch.from_numpy(np.ascontiguousarray(ref[:, :hh, :ww])).to(device)
            results["psnr"].append(timed("psnr", lambda: float(psnr(a, b, crop_border, y_channel)[0])))
            results["ssim"].append(timed("ssim", lambda: float(ssim(a, b, crop_border, y_channel)[0])))
            if "lpips" in metrics:
                results["lpips"].append(timed("lpips", lambda: float(metrics["lpips"](a * 2 - 1, b * 2 - 1)[0])))
    return results


def report(results: Dict[str, List[float]]) -> List[str]:
    """The JAX CLI's lines: ``name: mean  (n=k)`` for each metric computed."""
    return [f"{k}: {np.mean(v):.4f}  (n={len(v)})" for k, v in results.items() if v]


def main(argv=None) -> Dict[str, List[float]]:
    import torch

    from instarevive_tpu_torch.pipelines.build import set_precision
    from instarevive_tpu_torch.utils.image_io import list_image_files

    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    set_precision()  # f32 networks in f32 on the card: no TF32
    files = list_image_files(args.folder)
    print(f"evaluating {len(files)} images in {args.folder}")
    results = evaluate(files, build_metrics(args, args.device), args.device, args.ref_folder, args.crop_border,
                       args.y_channel)
    for line in report(results):
        print(line)
    return results


if __name__ == "__main__":
    main()
