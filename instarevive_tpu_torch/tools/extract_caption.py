"""Caption images with the LLaVA-MPT captioner, the port of the root
``tools/extract_caption.py``.

    python -m instarevive_tpu_torch.tools.extract_caption --input <images> --output captions.json \\
        --mpt_ckpt llava_mpt.pt --clip_dir <CLIP vision dir> --tokenizer <tokenizer dir> \\
        [--max_new_tokens 96] [--batch_size 4] [--mm_vision_select_layer -2] [--device cuda|cpu]

Each batch: the CLIP image processor, the ``transformers`` ``CLIPVisionModel``
tower (its hidden layer ``--mm_vision_select_layer``, the class token
dropped), the prompt followed by one ``<im_patch>`` token a patch, greedy
decoding with the KV cache (``models/llava_mpt.py``); writes {filename:
caption} as the JAX tool does, for ``generate_data_info.py --captions``. The
models run in float32 on ``--device``. Without the three local checkpoints it
exits and says what it needs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

PROMPT = "Describe this image and its style in a very detailed manner."


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input", required=True, help="image folder")
    p.add_argument("--output", required=True, help="output captions json")
    p.add_argument("--mpt_ckpt", default=None, help="LLaVA-MPT state dict (.pt/.pth/.bin)")
    p.add_argument("--clip_dir", default=None, help="local Hugging Face CLIP vision dir")
    p.add_argument("--tokenizer", default=None, help="local Hugging Face tokenizer dir")
    p.add_argument("--prompt", default=PROMPT)
    p.add_argument("--max_new_tokens", type=int, default=96)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--mm_vision_select_layer", type=int, default=-2)
    p.add_argument("--d_model", type=int, default=4096)
    p.add_argument("--n_heads", type=int, default=32)
    p.add_argument("--n_layers", type=int, default=32)
    p.add_argument("--vocab_size", type=int, default=50432)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if not (args.mpt_ckpt and args.clip_dir and args.tokenizer):
        sys.exit("extract_caption: needs local weights: --mpt_ckpt (LLaVA-MPT state dict), --clip_dir (Hugging Face "
                 "CLIP vision dir) and --tokenizer (Hugging Face tokenizer dir)")

    import torch
    from PIL import Image
    from transformers import AutoTokenizer, CLIPImageProcessor, CLIPVisionModel

    from instarevive_tpu_torch.models.llava_mpt import (
        LlavaMPT, MPTConfig, MPTModel, clip_select_features, load_mpt_checkpoint,
    )
    from instarevive_tpu_torch.models.t5 import resolve_device
    from instarevive_tpu_torch.pipelines.build import set_precision
    from instarevive_tpu_torch.utils.image_io import list_image_files

    device = resolve_device(args.device)
    set_precision()  # the tower's patch convolution in f32 on the card: no TF32
    tok = AutoTokenizer.from_pretrained(args.tokenizer)
    tower = CLIPVisionModel.from_pretrained(args.clip_dir, dtype=torch.float32).to(device).eval()
    proc = CLIPImageProcessor.from_pretrained(args.clip_dir)
    vcfg = tower.config
    n_patches = (vcfg.image_size // vcfg.patch_size) ** 2

    sd = torch.load(args.mpt_ckpt, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    cfg = MPTConfig(d_model=args.d_model, n_heads=args.n_heads, n_layers=args.n_layers, vocab_size=args.vocab_size,
                    mm_hidden_size=vcfg.hidden_size)
    with torch.device(device):
        model = MPTModel(cfg)
    load_mpt_checkpoint(model, sd).eval().requires_grad_(False)

    im_patch = tok.convert_tokens_to_ids("<im_patch>")

    def vision_fn(images):
        out = tower(pixel_values=images, output_hidden_states=True)
        return clip_select_features(out.hidden_states, args.mm_vision_select_layer)

    llava = LlavaMPT(model, vision_fn, im_patch)
    ids = torch.tensor([tok(args.prompt).input_ids + [im_patch] * n_patches], device=device)

    results = {}
    files = list_image_files(args.input)
    with torch.inference_mode():
        for i in range(0, len(files), args.batch_size):
            chunk = files[i:i + args.batch_size]
            px = proc(images=[Image.open(f).convert("RGB") for f in chunk], return_tensors="pt")["pixel_values"]
            bid = ids.expand(px.shape[0], -1)
            toks = llava.generate(bid, px.to(device), torch.ones_like(bid, dtype=torch.bool), args.max_new_tokens,
                                  eos_id=tok.eos_token_id)
            for f, row in zip(chunk, toks.cpu().tolist()):
                text = tok.decode(row, skip_special_tokens=True).strip()
                results[os.path.basename(f)] = text
                print(f"{os.path.basename(f)}: {text}")

    with open(args.output, "w") as fh:
        json.dump(results, fh, indent=1)
    print(f"wrote {len(results)} captions -> {args.output}")
    return results


if __name__ == "__main__":
    main()
