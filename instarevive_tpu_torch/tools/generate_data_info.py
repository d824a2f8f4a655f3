"""Build a PixArt-style ``data_info.json`` manifest for image folders, the
port of the root ``tools/generate_data_info.py``.

    python -m instarevive_tpu_torch.tools.generate_data_info --folders <dir> [<dir> ...] \\
        --output data_info.json [--prompt "..." | --captions caps.json | --blip_dir <BLIP dir>] \\
        [--relative_to <root>] [--sort] [--device cuda|cpu]

One record per image: {"height", "width", "ratio" (w/h), "path", "prompt"},
the same JSON the JAX tool writes. The prompt is a fixed string, a
{filename: caption} file's entry, or a caption from a local Hugging Face
BLIP directory, run on ``--device`` (the card unless the CPU is asked for;
only ``--blip_dir`` uses it).
"""

from __future__ import annotations

import argparse
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--folders", nargs="+", required=True, help="image folders")
    p.add_argument("--output", required=True, help="output data_info.json")
    p.add_argument("--prompt", default="", help="fixed prompt for every image")
    p.add_argument("--captions", default=None, help="json {filename: caption}")
    p.add_argument("--blip_dir", default=None, help="local BLIP dir (processor+model) for auto-captioning")
    p.add_argument("--relative_to", default=None, help="store paths relative to this root (default: absolute)")
    p.add_argument("--sort", action="store_true", help="sort entries by path")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"], help="where --blip_dir's model runs")
    return p.parse_args(argv)


def blip_captioner(blip_dir: str, device):
    """image -> caption from a local BLIP directory, the model on ``device``."""
    import torch
    from transformers import BlipForConditionalGeneration, BlipProcessor

    from instarevive_tpu_torch.models.t5 import resolve_device
    from instarevive_tpu_torch.pipelines.build import set_precision

    device = resolve_device(device)
    set_precision()  # f32 on the card: no TF32
    processor = BlipProcessor.from_pretrained(blip_dir)
    model = BlipForConditionalGeneration.from_pretrained(blip_dir).to(device).eval()

    def caption(img):
        with torch.no_grad():
            inputs = processor(img, return_tensors="pt").to(device)
            out = model.generate(**inputs)
        return processor.decode(out[0], skip_special_tokens=True)

    return caption


def main(argv=None) -> list:
    args = parse_args(argv)

    from PIL import Image

    from instarevive_tpu_torch.utils.image_io import list_image_files

    captions = {}
    if args.captions:
        with open(args.captions) as f:
            captions = json.load(f)
    blip = blip_captioner(args.blip_dir, args.device) if args.blip_dir else None

    results = []
    for folder in args.folders:
        for path in list_image_files(folder):
            with Image.open(path) as img:
                img = img.convert("RGB")
                width, height = img.size
                name = os.path.basename(path)
                if blip is not None:
                    prompt = blip(img)
                else:
                    prompt = captions.get(name, captions.get(path, args.prompt))
            rec_path = os.path.relpath(path, args.relative_to) if args.relative_to else os.path.abspath(path)
            results.append({"height": height, "width": width, "ratio": width / height, "path": rec_path,
                            "prompt": prompt})
            print(f"{rec_path}: {width}x{height} '{prompt[:40]}'")

    if args.sort:
        results.sort(key=lambda r: r["path"])
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    with open(args.output, "w") as f:
        json.dump(results, f)
    print(f"wrote {len(results)} entries -> {args.output}")
    return results


if __name__ == "__main__":
    main()
