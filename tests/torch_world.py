"""A world of gloo ranks on the CPU for the port's parallel tests.

``run_world(n, "module:function", payload)`` starts ``n`` processes (spawned,
one torch thread each), joins them in one gloo group, calls
``function(rank, n, payload)`` on every rank and returns the ranks' results
in rank order (anything ``torch.save`` takes). A rank that raises fails the
call with its traceback. A test module starts one world in a module-scoped
fixture that runs all its checks, and each test asserts its own part.
"""

import importlib
import os
import tempfile
import traceback

import torch
import torch.multiprocessing as mp

TIMEOUT_S = 600


def _rank(rank, n, port, target, in_path, out_dir):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE=str(n),
                      LOCAL_RANK=str(rank), OMP_NUM_THREADS="1")
    torch.set_num_threads(1)
    import torch.distributed as dist
    from datetime import timedelta

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=n,
                            timeout=timedelta(seconds=TIMEOUT_S))
    try:
        module, name = target.split(":")
        result = getattr(importlib.import_module(module), name)(rank, n, torch.load(in_path, weights_only=False))
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except Exception:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_world(n, target, payload):
    from instarevive_tpu_torch.parallel.dist import free_port

    with tempfile.TemporaryDirectory() as tmp:
        in_path = os.path.join(tmp, "payload.pt")
        torch.save(payload, in_path)
        try:
            mp.start_processes(_rank, args=(n, free_port(), target, in_path, tmp), nprocs=n, start_method="spawn")
        except Exception as exc:
            errs = [open(os.path.join(tmp, f)).read() for f in sorted(os.listdir(tmp)) if f.endswith(".err")]
            raise RuntimeError("a rank failed:\n" + "\n".join(errs)) from exc
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(n)]
