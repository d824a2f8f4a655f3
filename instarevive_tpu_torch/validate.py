"""ControlNet-conditioned validation, the PyTorch port of ``validate.py``.

    python -m instarevive_tpu_torch.validate --data imgs/ --out val_out \\
        --random_init [--device cuda|cpu] [--config configs/tiny.yaml] \\
        [--control_depth 13] [--step 20] [--batch_size 2] [--crop_size 512]

Per batch of center-cropped images: the Real-ESRGAN degradation on the
device (explicit generators), SwinIR clean, VAE encode as the control latent,
``--step`` DPM-Solver++(2M) steps of the DiT with its first
``--control_depth`` ControlNet-Half stages on that latent, decode; PSNR and
SSIM against the clean crop, lq | prediction | hq panels as PNGs, and a FINAL
line with the means. On the card the models compute in bf16 (``--bf16`` asks
for it on the CPU too); the solver state stays float32.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    from instarevive_tpu_torch.inference import add_model_args

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(p)
    p.set_defaults(config="configs/tiny.yaml")
    p.add_argument("--data", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--crop_size", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--step", type=int, default=20)
    p.add_argument("--control_depth", type=int, default=13)
    p.add_argument("--max_batches", type=int, default=10)
    p.add_argument("--seed", type=int, default=231)
    return p.parse_args(argv)


def control_sample(pipe, y, c, z_init, steps: int = 20):
    """``steps`` DPM-Solver++(2M) steps from ``z_init`` (float32, shaped as
    c) with the DiT reading the condition latent c through
    ``pipe.control_depth`` ControlNet-Half stages; y: (1 or B, L, C)."""
    import torch

    from instarevive_tpu_torch.diffusion.dpm_solver import dpm_solver_pp_2m

    y = y.expand(c.shape[0], -1, -1)

    def eps_fn(z, t):
        return pipe.dit(z, t, y, c=c, control_depth=pipe.control_depth)[..., : z.shape[-1]].float()

    with torch.inference_mode():
        return dpm_solver_pp_2m(eps_fn, pipe.sched, z_init, steps=steps)


def restore_batch(pipe, y, lq, z_init, steps: int = 20):
    """(prediction, SwinIR output) for an LQ batch (B, H, W, 3) in [0, 1]:
    clean, encode to the control latent, ``control_sample``, decode (not
    clamped)."""
    import torch

    with torch.inference_mode():
        stage1 = pipe.clean(lq)
        z = control_sample(pipe, y, pipe.encode(stage1), z_init, steps)
        return pipe.decode(z), stage1


def validate_batch(pipe, y, hq01, gens, deg_cfg, steps: int = 20, draws=None):
    """One batch of clean crops (B, H, W, 3) in [0, 1] on the device: degrade
    (``draws``, by default drawn from ``gens.host``; the noise fields from
    ``gens.device``), ``restore_batch`` from noise drawn from
    ``gens.device``. Returns dict(lq, pred, hq) in [0, 1] and per-sample
    psnr and ssim."""
    import torch

    from instarevive_tpu_torch.data.realesrgan import degrade_batch
    from instarevive_tpu_torch.utils.metrics import psnr, ssim

    data = degrade_batch(gens, hq01, deg_cfg, draws=draws)
    b, h, w, _ = hq01.shape
    f = pipe.latent_factor
    z_init = torch.randn((b, h // f, w // f, 4), generator=gens.device, device=hq01.device)
    pred, _ = restore_batch(pipe, y, data["lq"], z_init, steps)
    pred = pred.clamp(0.0, 1.0)  # decode is not clamped
    hq = (data["hq"] + 1) / 2
    return {"lq": data["lq"], "pred": pred, "hq": hq, "psnr": psnr(pred, hq), "ssim": ssim(pred, hq)}


def main(argv=None) -> dict:
    args = parse_args(argv)

    import numpy as np
    import torch

    from instarevive_tpu_torch.data.dataset import ImageFolderDataset, PrefetchLoader
    from instarevive_tpu_torch.data.realesrgan import RealESRGANDegradationConfig
    from instarevive_tpu_torch.inference import load_pipeline
    from instarevive_tpu_torch.ops.degradation import make_generators
    from instarevive_tpu_torch.utils.image_io import save_image
    from instarevive_tpu_torch.utils.logging import get_root_logger, log_images_panel

    os.makedirs(args.out, exist_ok=True)
    logger = get_root_logger()
    pipe, y = load_pipeline(args, control_depth=args.control_depth)
    device = y.device
    gens = make_generators(args.seed, device)
    deg_cfg = RealESRGANDegradationConfig()
    ds = ImageFolderDataset(args.data, out_size=args.crop_size, crop_type="center", use_hflip=False)
    loader = PrefetchLoader(ds, args.batch_size, shuffle=False, drop_last=False)

    all_psnr, all_ssim = [], []
    for bi, batch in enumerate(loader):
        if bi >= args.max_batches:
            break
        hq01 = torch.from_numpy(batch["hq"]).to(device).float() / 255.0
        out = validate_batch(pipe, y, hq01, gens, deg_cfg, args.step)
        all_psnr += out["psnr"].tolist()
        all_ssim += out["ssim"].tolist()
        panel = log_images_panel(*(out[k].cpu().numpy() for k in ("lq", "pred", "hq")))
        for j in range(panel.shape[0]):
            save_image(panel[j], os.path.join(args.out, f"b{bi}_{j}.png"))
        logger.info(f"batch {bi}: psnr {np.mean(all_psnr):.2f} ssim {np.mean(all_ssim):.4f}")

    result = {"psnr": float(np.mean(all_psnr)), "ssim": float(np.mean(all_ssim)), "n": len(all_psnr)}
    logger.info(f"FINAL psnr {result['psnr']:.3f} ssim {result['ssim']:.4f} (n={result['n']})")
    return result


if __name__ == "__main__":
    main()
