"""The server's mesh flags (``instarevive_tpu_torch/serve.py``) on gloo ranks:
every mode at 2 ranks behind the ``Batcher`` against a one-process
restorer's answers, a follower's failure answered as an error without
stopping a rank, the flags' rules, and the CLI starting its own two ranks
and answering over HTTP.

One world of 4 ranks (``torch_parallel_jobs.serving``) runs the in-process
cases at 64x64, two modes at a time on the two pairs of ranks; each test
asserts its own part. Bound: atol 2e-4 against the one-process restorer, the
bound of the modes against the JAX package (``tests/test_torch_parallel.py``;
f32, the parallel paths sum in other orders)."""

import base64
import io
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test worker)
from PIL import Image
from torch_world import run_world

from instarevive_tpu_torch import serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_PATH = os.path.join(REPO, "configs", "tiny.yaml")
MODES = ("data_parallel", "tensor_parallel", "pipeline_parallel", "seq_parallel", "tp_dp")


def _png(a):
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "PNG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def ranks():
    xs = np.random.default_rng(5).uniform(0.1, 0.9, (3, 64, 64, 3)).astype(np.float32)
    return run_world(4, "torch_parallel_jobs:serving", {"config": TINY_PATH, "xs": xs})


@pytest.mark.parametrize("mode", MODES)
def test_mesh_flag_serves_what_one_process_serves(ranks, mode):
    """Each mode at 2 ranks, and TP x DP (--data_parallel 2 --tensor_parallel
    2, the world's make_mesh) at 4."""
    main = ranks[0] if mode in ("data_parallel", "pipeline_parallel", "tp_dp") else ranks[2]
    followers = {"tp_dp": ranks[1:]}.get(mode, [ranks[1] if main is ranks[0] else ranks[3]])
    np.testing.assert_allclose(main[mode], main["plain"], atol=2e-4, rtol=0)
    stats = main[f"{mode}_stats"]
    assert stats["served"] == 3 + (mode == "data_parallel") and stats["ok"]
    # every follower ran every batch rank 0 ran (the three requests in one batch or several)
    for follower in followers:
        assert follower[f"{mode}_follower_batches"] == stats["batches"] + stats["errors"] >= 1


def test_failure_on_a_follower_answers_and_stops_no_rank(ranks):
    """A rank that raises after its part: rank 0's Batcher hands the error to
    the batch's requests (the HTTP handler answers them 500) and both ranks
    serve the next batch."""
    assert "rank 1: RuntimeError: injected failure" in ranks[0]["failed"]
    np.testing.assert_allclose(ranks[0]["after_failure"], ranks[0]["plain"][0], atol=2e-4, rtol=0)
    assert ranks[0]["data_parallel_stats"]["errors"] == 1


def test_mesh_flag_rules(capsys):
    """The JAX server's exclusivity rule (serve.py:64-70) and the rank count."""
    with pytest.raises(SystemExit) as e:
        serve.parse_args(["--pipeline_parallel", "2", "--data_parallel", "2"])
    assert e.value.code == 2 and "mutually exclusive" in capsys.readouterr().err
    assert serve.parse_args(["--data_parallel", "2", "--tensor_parallel", "2"]).world == 4
    assert serve.parse_args(["--seq_parallel", "4"]).world == 4
    with pytest.raises(SystemExit, match=f"this host has {torch.cuda.device_count()} CUDA devices"):
        serve.main(["--random_init", "--config", TINY_PATH, "--tensor_parallel", str(torch.cuda.device_count() + 2)])


def test_cli_starts_its_own_ranks():
    """``python -m instarevive_tpu_torch.serve --tensor_parallel 2`` is the
    whole command: it starts two ranks (gloo on the CPU here), rank 0 serves."""
    cmd = [sys.executable, "-m", "instarevive_tpu_torch.serve", "--device", "cpu", "--random_init", "--config",
           TINY_PATH, "--port", "0", "--tensor_parallel", "2"]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        deadline, port = time.time() + 240, None
        while port is None and time.time() < deadline:
            line = proc.stdout.readline()
            assert line or proc.poll() is None, "the server ended"
            if "listening on :" in line:
                port = int(line.split("listening on :")[1].split()[0])
                assert "2 ranks" in line
        img = np.random.default_rng(6).integers(0, 256, (64, 64, 3), dtype=np.uint8)
        body = json.dumps({"image": base64.b64encode(_png(img)).decode()}).encode()
        with urllib.request.urlopen(urllib.request.Request(f"http://127.0.0.1:{port}/restore", data=body),
                                    timeout=240) as resp:
            assert resp.status == 200 and "image" in json.load(resp)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as resp:
            assert json.load(resp)["served"] == 1
    finally:
        os.killpg(proc.pid, signal.SIGTERM)
        proc.wait(timeout=60)
