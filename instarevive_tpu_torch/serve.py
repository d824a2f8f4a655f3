"""Batched serving daemon for one-step restoration, the PyTorch port of
``serve.py``.

    python -m instarevive_tpu_torch.serve --config configs/instarevive_v1.yaml --random_init --port 7870
    curl -X POST localhost:7870/restore --data '{"image": "<base64 png>"}'
    curl localhost:7870/healthz

A micro-batching server: concurrent requests are queued, grouped by padded
shape (short edge raised to 512, zero-padded to a multiple of 64), run
through ``RestorationPipeline.process`` with the wavelet color fix as one
batch of up to ``--max_batch`` images, and answered one by one, each cropped
to its own size. PyTorch runs eagerly, so there is no compiled program to
keep per shape bucket as the JAX server keeps; a bucket only decides which
requests may share a batch. It runs on the card (``--device cuda``, bf16)
unless asked for the CPU, and exits at once when asked for a card that is not
there. The mesh flags of the JAX server (data, tensor, pipeline and sequence
parallelism) are not ported and not accepted.

An exception in the worker is handed to every request of its batch, which is
answered 500 with the message; the worker goes on, and ``/healthz`` reports
the count and the last message.

``build_restorer`` (``make_restorer`` of the loaded pipeline), ``Batcher`` and
``make_server`` are the pieces ``main`` puts together; tests and ``chip_smoke.py`` drive them in-process.
"""

from __future__ import annotations

import argparse
import base64
import binascii
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

import numpy as np

REQUEST_TIMEOUT_S = 600.0


def parse_args(argv=None):
    from instarevive_tpu_torch.inference import add_model_args

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_model_args(p)
    p.add_argument("--port", type=int, default=7870)
    p.add_argument("--max_batch", type=int, default=4)
    p.add_argument("--batch_window_ms", type=int, default=30)
    return p.parse_args(argv)


def make_restorer(pipe, y) -> Callable[..., np.ndarray]:
    """``restore(x, color_fix="wavelet")``: a (n, H, W, 3) float32 batch in
    [0, 1], H and W multiples of 64, through ``pipe.process`` on the
    pipeline's device with the (1, L, C) prompt embedding ``y`` for every
    image; returns the restored batch as float32 numpy."""
    import torch

    def restore(x: np.ndarray, color_fix: str = "wavelet") -> np.ndarray:
        lq = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(y.device)
        out = pipe.process(lq, y.repeat(lq.shape[0], 1, 1), color_fix=color_fix)
        return out.float().cpu().numpy()

    return restore


def build_restorer(args) -> Callable[..., np.ndarray]:
    """``make_restorer`` of the pipeline and null-prompt embedding that
    ``inference.load_pipeline`` builds from the flags."""
    from instarevive_tpu_torch.inference import load_pipeline

    return make_restorer(*load_pipeline(args))


class Batcher:
    """A queue of requests and the one worker thread that serves it: it takes
    the oldest request, waits up to ``batch_window_ms`` for more of the same
    padded shape (up to ``max_batch``; a request of another shape goes back on
    the queue and ends the wait), runs them as one batch and hands each its
    cropped answer, or the exception the batch raised."""

    def __init__(self, restore: Callable[[np.ndarray], np.ndarray], max_batch: int = 4,
                 batch_window_ms: float = 30.0):
        self.restore, self.max_batch, self.window_s = restore, max_batch, batch_window_ms / 1e3
        self._queue: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._stats = {"served": 0, "batches": 0, "errors": 0, "last_error": None}
        self._closed = threading.Event()
        self._thread = threading.Thread(target=self._work, name="restore-batcher", daemon=True)
        self._thread.start()

    def stats(self) -> dict:
        with self._lock:
            return {"ok": self._thread.is_alive(), **self._stats}

    def pending(self) -> int:
        """Requests queued and not yet taken into a batch."""
        return self._queue.qsize()

    def submit(self, x: np.ndarray, th: int, tw: int, timeout: float = REQUEST_TIMEOUT_S) -> np.ndarray:
        """Queue one padded (H, W, 3) image and wait for its answer, cropped
        to (th, tw). Raises what the worker raised for its batch, or
        TimeoutError."""
        if self._closed.is_set():
            raise RuntimeError("the batcher is closed")
        item = {"x": x, "shape": x.shape[:2], "th": th, "tw": tw, "event": threading.Event()}
        self._queue.put(item)
        if not item["event"].wait(timeout):
            raise TimeoutError(f"no answer within {timeout:.0f} s")
        if "error" in item:
            raise item["error"]
        return item["result"]

    def close(self) -> None:
        """Stop the worker once it has served what was queued before."""
        self._closed.set()
        self._queue.put(None)
        self._thread.join(timeout=REQUEST_TIMEOUT_S)

    def _work(self) -> None:
        while True:
            first = self._queue.get()
            if first is None:  # closed: a request put back behind the sentinel must not wait for ever
                while not self._queue.empty():
                    item = self._queue.get()
                    if item is not None:
                        item["error"] = RuntimeError("the batcher was closed")
                        item["event"].set()
                return
            batch, t0 = [first], time.monotonic()
            # micro-batching window: requests of the same bucket coalesce
            while len(batch) < self.max_batch and time.monotonic() - t0 < self.window_s:
                try:
                    item = self._queue.get(timeout=self.window_s)
                except queue.Empty:
                    break
                if item is not None and item["shape"] == first["shape"]:
                    batch.append(item)
                else:
                    self._queue.put(item)
                    break
            try:
                out = self.restore(np.stack([b["x"] for b in batch]))
                for i, b in enumerate(batch):
                    b["result"] = out[i, : b["th"], : b["tw"]]
                with self._lock:
                    self._stats["served"] += len(batch)
                    self._stats["batches"] += 1
            except Exception as exc:  # the thread must outlive a failed batch; every request of it hears why
                for b in batch:
                    b["error"] = exc
                with self._lock:
                    self._stats["errors"] += 1
                    self._stats["last_error"] = f"{type(exc).__name__}: {exc}"
            for b in batch:
                b["event"].set()


def read_image_payload(handler: BaseHTTPRequestHandler):
    """The request's JSON body and its ``image`` (base64 PNG) as a PIL image."""
    from PIL import Image

    length = int(handler.headers.get("Content-Length", 0))
    payload = json.loads(handler.rfile.read(length))
    return payload, Image.open(io.BytesIO(base64.b64decode(payload["image"])))


def send_json(handler: BaseHTTPRequestHandler, code: int, obj: dict) -> None:
    body = json.dumps(obj).encode()
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def answer_restore(handler: BaseHTTPRequestHandler, restore_image: Callable) -> None:
    """``POST /restore`` of both servers: 400 for a body that is no base64
    image in JSON, 500 with the message for a failed restoration, else
    ``{"image": base64 png}`` of ``restore_image(payload, image)``."""
    from PIL import Image, UnidentifiedImageError

    from instarevive_tpu_torch.utils.image_io import png_bytes, to_uint8

    if handler.path != "/restore":
        handler.send_error(404)
        return
    try:
        payload, img = read_image_payload(handler)
    except (ValueError, KeyError, TypeError, binascii.Error, UnidentifiedImageError) as exc:
        send_json(handler, 400, {"error": f"bad request: {type(exc).__name__}: {exc}"})
        return
    try:
        out = restore_image(payload, img)
    except Exception as exc:  # the server must outlive a failed request; the client hears why
        send_json(handler, 500, {"error": f"{type(exc).__name__}: {exc}"})
        return
    png = png_bytes(Image.fromarray(to_uint8(out)))
    send_json(handler, 200, {"image": base64.b64encode(png).decode()})


def make_server(batcher: Batcher, port: int = 7870) -> ThreadingHTTPServer:
    """The HTTP server on 127.0.0.1 (``port`` 0 picks a free one, see
    ``server.server_address``): ``POST /restore`` and ``GET /healthz``. Call
    ``serve_forever`` on it; ``shutdown`` and ``server_close`` end it."""
    from instarevive_tpu_torch.utils.image_io import prepare

    def restore_image(payload, img):
        return batcher.submit(*prepare(img))

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path == "/healthz":
                send_json(self, 200, batcher.stats())
            else:
                self.send_error(404)

        def do_POST(self):
            answer_restore(self, restore_image)

        def log_message(self, *a):
            pass

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def main(argv=None) -> None:
    args = parse_args(argv)
    batcher = Batcher(build_restorer(args), args.max_batch, args.batch_window_ms)
    server = make_server(batcher, args.port)
    print(f"[serve] listening on :{server.server_address[1]} (max_batch={args.max_batch}, device={args.device})",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        batcher.close()


if __name__ == "__main__":
    main()
