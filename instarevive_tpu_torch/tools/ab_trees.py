"""Time two checkouts of the port alternately on one card, in one run.

    python -m instarevive_tpu_torch.tools.ab_trees --a DIR_A --b DIR_B [--rounds 2] [--runs 5]

Runs ``time_restore.py`` (this checkout's copy) on tree A, B, B, A, ... each
in a process of its own, so that both see the same card, clocks and
neighbours, and prints every run's JSON line and the medians per tree. An
older tree is unpacked with ``git archive <commit> instarevive_tpu_torch
configs | tar -x -C <dir>`` into a directory that git ignores.
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
    args = ap.parse_args(argv)
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "time_restore.py")
    order = []
    for r in range(args.rounds):
        order += [("A", args.a), ("B", args.b)] if r % 2 == 0 else [("B", args.b), ("A", args.a)]
    results = {"A": [], "B": []}
    for label, tree in order:
        proc = subprocess.run([sys.executable, script, "--repo", tree, "--runs", str(args.runs), "--label", label],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f"time_restore failed on {tree}:\n{proc.stdout}{proc.stderr}")
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results[label].append(json.loads(line))
    for label in ("A", "B"):
        for key in ("process_4x512_median_s", "tiled_1x1024_median_s"):
            values = [r[key] for r in results[label]]
            print(f"[ab] tree {label} ({results[label][0]['repo']}) {key}: runs {values}, "
                  f"median {statistics.median(values):.4f}", flush=True)


if __name__ == "__main__":
    main()
