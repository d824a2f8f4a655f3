"""Time the bf16 window-attention kernel alone on one CUDA card, for every
number of heads a block may take.

    python -m instarevive_tpu_torch.tools.time_swin_attention [--iters 200]

Calls the C launcher of ``csrc/swin_attention.cu`` directly (no wrapper, so
the figures are the kernel's, not the host's) at the v1 width (6 heads of 30)
on the shapes the restoration path and the server give it, with 1, 2, 3 and 6
heads a block, and prints one line per shape with the CUDA-event mean of each
and what ``ops.swin_attention.heads_per_block`` picks. This is where that
rule's figures come from.
"""

from __future__ import annotations

import argparse
import subprocess
import sys


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        sys.exit("time_swin_attention needs a CUDA device")
    from instarevive_tpu_torch.ops import swin_attention as sa
    from instarevive_tpu_torch.ops import window as W

    heads, hd, win = 6, 30, 8
    fn = sa._kernel()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), f"({sms} SMs)", flush=True)
    for b, h, w, shift in [(4, 64, 64, 4), (4, 64, 64, 0), (1, 128, 128, 4), (1, 64, 64, 4), (2, 64, 48, 4),
                           (1, 64, 80, 4)]:
        qkv = torch.randn(b, h, w, 3 * heads * hd, device="cuda", generator=gen).to(torch.bfloat16)
        bias = torch.randn(heads, win**2, win**2, device="cuda", generator=gen)
        mask = torch.from_numpy(W.shift_attn_mask(h, w, win, shift)).cuda() if shift else None
        out = torch.empty(b, h, w, heads * hd, device="cuda", dtype=torch.bfloat16)
        times = {}
        for hpb in (1, 2, 3, 6):
            def launch():
                err = fn(qkv.data_ptr(), bias.data_ptr(), None if mask is None else mask.data_ptr(), out.data_ptr(),
                         b, h, w, heads, hd, win, shift, hd**-0.5, hpb, 1, stream)
                if err:
                    sys.exit(f"launch failed with CUDA error {err}")

            for _ in range(10):
                launch()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.iters):
                launch()
            end.record()
            torch.cuda.synchronize()
            times[hpb] = start.elapsed_time(end) / args.iters
        windows = b * (h // win) * (w // win)
        print(f"[swin_attn] B,H,W={b},{h},{w} shift={shift} ({windows} windows): ms by heads a block "
              + ", ".join(f"{k}: {v:.4f}" for k, v in times.items())
              + f"; the wrapper takes {sa.heads_per_block(heads, windows, sms)}", flush=True)


if __name__ == "__main__":
    main()
