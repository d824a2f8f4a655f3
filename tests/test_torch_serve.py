"""The port's servers (serve.py, interface.py) on the CPU at configs/tiny.yaml
with weights converted from the JAX package's ``init_params``: answers held
against the JAX ``pipe.process(..., color_fix="wavelet")`` on the same padded
input, cropped the same way, to 1 level of 8 bits."""

import base64
import io
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from instarevive_tpu.config import load_config
from instarevive_tpu.pipelines.build import build_pipeline as jax_build_pipeline
from instarevive_tpu.pipelines.build import init_params as jax_init_params
from instarevive_tpu_torch import interface, serve
from instarevive_tpu_torch.convert.from_jax import state_dicts_from_jax
from instarevive_tpu_torch.utils.image_io import prepare, to_uint8

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_PATH = os.path.join(REPO, "configs", "tiny.yaml")
TINY = load_config(TINY_PATH)
TIMEOUT = 300


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX tiny pipeline with seeded params, those params saved as the
    port's checkpoint files, and the parsed flags that load them on the CPU."""
    jpipe = jax_build_pipeline(TINY)
    params = jax_init_params(jpipe, seed=0)
    tmp = tmp_path_factory.mktemp("ckpt")
    paths = {}
    for name, sd in state_dicts_from_jax(params, TINY).items():
        paths[name] = str(tmp / f"{name}.pth")
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, paths[name])
    argv = ["--config", TINY_PATH, "--device", "cpu", "--ckpt", paths["dit"], "--swinir_ckpt", paths["swinir"],
            "--vae_ckpt", paths["vae"], "--port", "0"]
    return jpipe, params, argv


@pytest.fixture
def running():
    """Start servers on free ports; shut all of them down afterwards."""
    started = []

    def start(server, batcher=None):
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        started.append((server, thread, batcher))
        return f"http://127.0.0.1:{server.server_address[1]}"

    yield start
    for server, thread, batcher in started:
        server.shutdown()
        server.server_close()
        thread.join(timeout=TIMEOUT)
        assert not thread.is_alive()
        if batcher is not None:
            batcher.close()
            assert not batcher.stats()["ok"]  # the worker has ended


def _png(arr: np.ndarray) -> str:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _post(url: str, payload) -> tuple:
    data = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
    try:
        with urllib.request.urlopen(urllib.request.Request(url + "/restore", data=data), timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url: str, path: str = "/healthz") -> dict:
    with urllib.request.urlopen(url + path, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def _decode(answer: dict) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(answer["image"]))).convert("RGB"))


def _images():
    """Three of one bucket (64x64 -> 512x512) and two of another (64x70 ->
    512x560, padded to 576 wide and cropped back)."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (64, w, 3), dtype=np.uint8) for w in (64, 70, 64, 64, 70)]


def test_server_answers_equal_the_jax_pipeline(setup, running):
    jpipe, params, argv = setup
    args = serve.parse_args(argv)
    # How requests fall into batches depends on when each reaches the queue, which under load is anyone's
    # guess. So the test sets the arrivals itself: a first request holds the worker inside ``restore`` until
    # the five real ones are queued, one after the other, bucket by bucket; then the worker is let go.
    real_restore, gate, primed = serve.build_restorer(args), threading.Event(), threading.Event()

    def restore(x):
        if not primed.is_set():
            primed.set()
            assert gate.wait(TIMEOUT)
            return np.zeros_like(x)
        return real_restore(x)

    batcher = serve.Batcher(restore, args.max_batch, batch_window_ms=500)
    url = running(serve.make_server(batcher, args.port), batcher)
    assert _get(url) == {"ok": True, "served": 0, "batches": 0, "errors": 0, "last_error": None}

    images = _images()
    order = sorted(range(len(images)), key=lambda i: images[i].shape[1])  # the 512-wide bucket, then the 560-wide
    with ThreadPoolExecutor(len(images) + 1) as pool:
        primer = pool.submit(_post, url, {"image": _png(images[0])})
        assert primed.wait(TIMEOUT)
        futures = {}
        for n, i in enumerate(order):
            futures[i] = pool.submit(_post, url, {"image": _png(images[i])})
            deadline = time.monotonic() + TIMEOUT
            while batcher.pending() < n + 1:
                assert time.monotonic() < deadline
                time.sleep(0.01)
        gate.set()
        assert primer.result()[0] == 200
        answers = [futures[i].result() for i in range(len(images))]
    health = _get(url)
    assert health["served"] == len(images) + 1 and health["errors"] == 0 and health["ok"]
    assert health["batches"] - 1 == 2  # two buckets, and the requests of each bucket shared one batch

    L = TINY["dit"]["model_max_length"]
    y = jnp.asarray(np.asarray(params["dit"]["y_embedder"]["y_embedding"])[None][:, :L], jnp.float32)
    process = jpipe.jitted(color_fix="wavelet")
    for im, (status, answer) in zip(images, answers):
        assert status == 200, answer
        x, th, tw = prepare(Image.fromarray(im))
        assert (th, tw) == (512, 512 * im.shape[1] // 64) and x.shape[1] % 64 == 0
        want = to_uint8(np.asarray(process(params, jnp.asarray(x[None]), y))[0, :th, :tw])
        got = _decode(answer)
        assert got.shape == (th, tw, 3)
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1

    # the demo's restorer gives the same image as the server for one input
    restore = interface.build_restorer(interface.parse_args(argv))
    same = np.asarray(restore(Image.fromarray(images[1])))
    assert np.abs(same.astype(np.int32) - _decode(answers[1][1]).astype(np.int32)).max() <= 1
    url2 = running(interface.make_server(restore, 0))
    status, answer = _post(url2, {"image": _png(images[1]), "color_fix": "wavelet"})
    assert status == 200 and np.array_equal(_decode(answer), same)
    status, answer = _post(url2, {"image": _png(images[1]), "color_fix": "none"})
    assert status == 200 and not np.array_equal(_decode(answer), same)
    status, answer = _post(url2, {"image": _png(images[1]), "color_fix": "sepia"})
    assert status == 500 and "sepia" in answer["error"]


def test_worker_exception_answers_500_and_the_server_goes_on(running):
    """A batch that raises is answered 500 with the message, ``/healthz``
    reports it, and later requests are still served."""
    def restore(x):
        if x.shape[2] == 640:
            raise RuntimeError("boom at width 640")
        return 1.0 - x

    batcher = serve.Batcher(restore, max_batch=4, batch_window_ms=20)
    url = running(serve.make_server(batcher, 0), batcher)
    rng = np.random.default_rng(1)
    good, bad = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8), rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)
    with ThreadPoolExecutor(4) as pool:
        results = list(pool.map(lambda im: _post(url, {"image": _png(im)}), [good, bad, bad, good]))
    assert [r[0] for r in results] == [200, 500, 500, 200]
    assert all("boom at width 640" in r[1]["error"] for r in results[1:3])
    health = _get(url)
    assert health["ok"] and health["served"] == 2 and health["errors"] >= 1
    assert health["last_error"] == "RuntimeError: boom at width 640"
    status, answer = _post(url, {"image": _png(good)})
    assert status == 200
    x, th, tw = prepare(Image.fromarray(good))
    assert np.array_equal(_decode(answer), to_uint8(1.0 - x)[:th, :tw])
    assert _get(url)["served"] == 3


def test_bad_requests_and_unknown_paths(running):
    batcher = serve.Batcher(lambda x: x)
    url = running(serve.make_server(batcher, 0), batcher)
    for payload in (b"not json", {"img": "x"}, {"image": "!!!"}, {"image": base64.b64encode(b"no png").decode()}):
        status, answer = _post(url, payload)
        assert status == 400 and answer["error"].startswith("bad request")
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(url, "/nothing")
    assert e.value.code == 404
    assert _get(url)["served"] == 0


def test_batcher_under_many_threads_gives_each_request_its_own_answer():
    """More clients than cores, three shape buckets, a short switch interval:
    every request gets the answer to its own image, the counts add up, and no
    batch exceeds ``max_batch`` or mixes shapes."""
    sizes = []

    def restore(x):
        sizes.append(x.shape)
        return x * 0.5

    batcher = serve.Batcher(restore, max_batch=4, batch_window_ms=5)
    rng = np.random.default_rng(2)
    shapes = [(64, 64), (64, 128), (128, 64)]
    items = [rng.random((*shapes[i % 3], 3), dtype=np.float32) for i in range(96)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(32) as pool:
            outs = list(pool.map(lambda x: batcher.submit(x, x.shape[0] - 3, x.shape[1] - 5, timeout=TIMEOUT), items))
    finally:
        sys.setswitchinterval(old)
        batcher.close()
    for x, out in zip(items, outs):
        np.testing.assert_array_equal(out, (x * 0.5)[: x.shape[0] - 3, : x.shape[1] - 5])
    stats = batcher.stats()
    assert stats["served"] == len(items) == sum(s[0] for s in sizes) and stats["batches"] == len(sizes)
    assert stats["errors"] == 0 and max(s[0] for s in sizes) <= 4 and stats["batches"] < len(items)
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit(items[0], 1, 1)


def test_close_fails_a_request_left_behind_its_sentinel():
    """While the worker is busy, two requests of different shapes and then
    ``close`` queue up. The worker takes the first, puts the second back
    behind the closing sentinel, and must fail it rather than leave it to
    its timeout."""
    import time

    entered, gate = threading.Event(), threading.Event()

    def restore(x):
        entered.set()
        assert gate.wait(TIMEOUT)
        return x

    def queued(n):
        deadline = time.monotonic() + TIMEOUT
        while batcher._queue.qsize() != n:
            assert time.monotonic() < deadline
            time.sleep(0.005)

    batcher = serve.Batcher(restore, max_batch=4, batch_window_ms=50)
    images = [np.full((64, w, 3), w / 256, np.float32) for w in (64, 128, 192)]
    with ThreadPoolExecutor(4) as pool:
        busy = pool.submit(batcher.submit, images[0], 64, 64, TIMEOUT)
        assert entered.wait(TIMEOUT)
        first = pool.submit(batcher.submit, images[1], 64, 128, TIMEOUT)
        queued(1)
        second = pool.submit(batcher.submit, images[2], 64, 192, TIMEOUT)
        queued(2)
        closing = pool.submit(batcher.close)
        queued(3)
        gate.set()
        np.testing.assert_array_equal(busy.result(TIMEOUT), images[0])
        np.testing.assert_array_equal(first.result(TIMEOUT), images[1])
        with pytest.raises(RuntimeError, match="was closed"):
            second.result(TIMEOUT)
        closing.result(TIMEOUT)
    assert batcher.stats() == {"ok": False, "served": 2, "batches": 2, "errors": 0, "last_error": None}


@pytest.mark.parametrize("module", [serve, interface])
def test_entry_points_default_to_the_card_and_refuse_the_mesh_flags(module, monkeypatch):
    args = module.parse_args([])
    assert args.device == "cuda" and args.config == "configs/instarevive_v1.yaml"
    for flag in ("--data_parallel", "--tensor_parallel", "--pipeline_parallel", "--seq_parallel"):
        with pytest.raises(SystemExit):
            module.parse_args([flag, "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        module.main(["--config", TINY_PATH, "--random_init"])
