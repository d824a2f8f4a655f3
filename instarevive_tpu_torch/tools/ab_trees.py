"""Time two checkouts of the port alternately on one card, in one run.

    python -m instarevive_tpu_torch.tools.ab_trees --a DIR_A --b DIR_B [--tool restore|dmd] [--rounds 2] [--runs 5]

Runs ``time_restore.py`` (``process`` and ``process_tiled``) or, with
``--tool dmd``, ``time_train.py --task dmd`` (``--runs`` DMD steps), this
checkout's copy, on tree A, B, B, A, ... each in a process of its own, so
that both see the same card, clocks and neighbours, and prints every run's
JSON line and the medians per tree. An older tree is unpacked with ``git
archive <commit> instarevive_tpu_torch configs | tar -x -C <dir>`` into a
directory that git ignores.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--a", required=True)
    ap.add_argument("--b", required=True)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--tool", default="restore", choices=["restore", "dmd"])
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    if args.tool == "restore":
        script, extra = os.path.join(here, "time_restore.py"), ["--runs", str(args.runs)]
        keys = ("process_4x512_median_s", "tiled_1x1024_median_s")
    else:
        script, extra = os.path.join(here, "time_train.py"), ["--task", "dmd", "--steps", str(args.runs)]
        keys = ("step_median_s",)
    order = []
    for r in range(args.rounds):
        order += [("A", args.a), ("B", args.b)] if r % 2 == 0 else [("B", args.b), ("A", args.a)]
    results = {"A": [], "B": []}
    for label, tree in order:
        proc = subprocess.run([sys.executable, script, "--repo", tree, *extra], capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f"{os.path.basename(script)} failed on {tree}:\n{proc.stdout}{proc.stderr}")
        line = proc.stdout.strip().splitlines()[-1]
        print(f"[ab] tree {label}: {line}", flush=True)
        results[label].append(json.loads(line))
    for label, tree in (("A", args.a), ("B", args.b)):
        for key in keys:
            values = [r[key] for r in results[label]]
            print(f"[ab] tree {label} ({os.path.abspath(tree)}) {key}: runs {values}, "
                  f"median {statistics.median(values):.4f}", flush=True)


if __name__ == "__main__":
    main()
