"""The port's rendezvous (``instarevive_tpu_torch/parallel/dist.py``), the
counterpart of ``tests/test_multihost.py``: two processes started with the
environment contract (MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE, which is
also torchrun's) join one gloo group, then broadcast from rank 0 and take a
mean over the ranks."""

import os
import subprocess
import sys

import torch_threads  # noqa: F401  (one torch thread a test worker)

from instarevive_tpu_torch.parallel.dist import free_port

_WORKER = """
import sys
rank = int(sys.argv[1])
sys.path.insert(0, sys.argv[2])
from instarevive_tpu_torch.parallel.dist import (broadcast_from_main, get_dist_info, init_distributed,
                                                 is_main_process, sync_global_mean)
assert get_dist_info() == (0, 1)  # before the rendezvous
r, w = init_distributed("cpu")
assert (r, w) == (rank, 2) == get_dist_info(), (r, w)
assert is_main_process() == (rank == 0)
bc = broadcast_from_main({"b": float(rank) + 1.0})
assert bc["b"] == 1.0, bc
mean = sync_global_mean({"loss": float(rank)})
assert abs(mean["loss"] - 0.5) < 1e-6, mean
assert init_distributed("cpu") == (rank, 2)  # idempotent
print("OK", flush=True)
"""


def test_two_process_rendezvous(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    port = str(free_port())
    procs = []
    for rank in (0, 1):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=str(rank), WORLD_SIZE="2",
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, str(script), str(rank), repo], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, env=env, text=True))
    outs = [p.communicate(timeout=180)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        assert "OK" in out, out


def test_alone_without_world_size(monkeypatch):
    """No WORLD_SIZE (or 1): the process runs alone, no group is made."""
    from instarevive_tpu_torch.parallel import dist

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert dist.init_distributed("cpu") == (0, 1) == dist.get_dist_info()
    assert dist.broadcast_from_main({"a": 1}) == {"a": 1} and dist.sync_global_mean({"a": 2.0}) == {"a": 2.0}
