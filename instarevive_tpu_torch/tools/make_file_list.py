"""Write a train/val file list from image folders, the port of the root
``tools/make_file_list.py``.

    python -m instarevive_tpu_torch.tools.make_file_list --img_folder <dir> [<dir> ...] \\
        --save_folder <out> [--val_size N] [--seed 231]

Every image under the folders (recursively), shuffled by
``random.Random(seed)`` as the JAX tool shuffles them; the first
``--val_size`` go to ``val.list``, the rest to ``train.list``.
"""

from __future__ import annotations

import argparse
import os
import random


def main(argv=None) -> dict:
    from instarevive_tpu_torch.utils.image_io import list_image_files

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--img_folder", nargs="+", required=True)
    p.add_argument("--val_size", type=int, default=0)
    p.add_argument("--save_folder", required=True)
    p.add_argument("--follow_links", action="store_true")
    p.add_argument("--seed", type=int, default=231)
    args = p.parse_args(argv)

    files = []
    for folder in args.img_folder:
        files += list_image_files(folder, recursive=True)
    random.Random(args.seed).shuffle(files)

    os.makedirs(args.save_folder, exist_ok=True)
    splits = {"train.list": files[args.val_size:], "val.list": files[:args.val_size]}
    for name, split in splits.items():
        with open(os.path.join(args.save_folder, name), "w") as f:
            f.write("\n".join(split))
        print(f"{name}: {len(split)} files")
    return splits


if __name__ == "__main__":
    main()
