"""Copy the images named in a ``.list`` file into a folder, the port of the
root ``tools/pickout_img.py``.

    python -m instarevive_tpu_torch.tools.pickout_img --list test.list --output <dir> [--root <prefix>]
"""

from __future__ import annotations

import argparse
import os
import shutil


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--list", required=True, dest="list_file", help="text file, one image path per line")
    p.add_argument("--output", required=True)
    p.add_argument("--root", default=None, help="prefix for relative paths in the list")
    args = p.parse_args(argv)

    os.makedirs(args.output, exist_ok=True)
    n = 0
    with open(args.list_file) as f:
        for line in f:
            path = line.strip()
            if not path:
                continue
            if args.root and not os.path.isabs(path):
                path = os.path.join(args.root, path)
            shutil.copy(path, os.path.join(args.output, os.path.basename(path)))
            n += 1
    print(f"copied {n} images -> {args.output}")
    return n


if __name__ == "__main__":
    main()
