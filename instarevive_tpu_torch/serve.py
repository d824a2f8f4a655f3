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
there.

The mesh flags are the JAX server's, one process a card over
``torch.distributed`` (``parallel/``): ``--data_parallel N`` splits each batch
over N ranks (padded to a multiple of N by repeating the last request),
``--tensor_parallel N`` splits the DiT's heads and MLPs (composes with
``--data_parallel``: data x tensor ranks), ``--pipeline_parallel S`` runs the
DiT's blocks as a GPipe pipeline of S stages (2 microbatches; batches padded
to an even size) and ``--seq_parallel N`` splits the DiT's tokens (N must
divide (H/16)(W/16)). The last two exclude the others. The server starts its
own ranks unless ``WORLD_SIZE`` is set (``torchrun``); asking for more ranks
than the host has cards is an error. Rank 0 holds the HTTP server and the
``Batcher`` and broadcasts each batch; the other ranks follow in a loop. Every
rank reports how its part of a batch went (one all-gather), so an exception on
any rank answers 500 for that batch and stops no rank. A rank that fails in the
middle of a collective leaves its peers waiting in it until the process
group's timeout (600 s), when they raise too.

An exception in the worker is handed to every request of its batch, which is
answered 500 with the message; the worker goes on, and ``/healthz`` reports
the count and the last message.

``build_restorer`` (``make_restorer`` of the loaded pipeline), ``Batcher`` and
``make_server`` are the pieces ``main`` puts together; tests and ``chip_smoke.py`` drive them in-process.
Under the mesh flags ``serve_rank`` builds a rank's part (``RankedRestorer``).
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
from typing import Callable, Optional

import numpy as np

REQUEST_TIMEOUT_S = 600.0


def parse_args(argv=None):
    from instarevive_tpu_torch.inference import add_model_args

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_model_args(p)
    p.add_argument("--port", type=int, default=7870)
    p.add_argument("--max_batch", type=int, default=4)
    p.add_argument("--batch_window_ms", type=int, default=30)
    p.add_argument("--data_parallel", type=int, default=0,
                   help="split each batch over N ranks (padded to a multiple of N)")
    p.add_argument("--tensor_parallel", type=int, default=0,
                   help="Megatron tensor parallelism of the DiT over N ranks; composes with --data_parallel "
                        "(data x tensor ranks)")
    p.add_argument("--pipeline_parallel", type=int, default=0,
                   help="the DiT's blocks as a GPipe pipeline over S ranks (batches padded to an even size); "
                        "excludes the other mesh flags")
    p.add_argument("--seq_parallel", type=int, default=0,
                   help="the DiT's tokens split over N ranks; excludes the other mesh flags")
    args = p.parse_args(argv)
    n_mesh_flags = sum(1 for v in (args.pipeline_parallel, args.seq_parallel) if v > 1) + (
        1 if (args.tensor_parallel > 1 or args.data_parallel > 1) else 0)
    if n_mesh_flags > 1:
        p.error("--pipeline_parallel / --seq_parallel are mutually exclusive "
                "with each other and with --data_parallel/--tensor_parallel")
    args.world = max(args.pipeline_parallel, args.seq_parallel, 1) * max(args.data_parallel, 1) * max(
        args.tensor_parallel, 1)
    return args


def make_restorer(pipe, y, process: Optional[Callable] = None) -> Callable[..., np.ndarray]:
    """``restore(x, color_fix="wavelet")``: a (n, H, W, 3) float32 batch in
    [0, 1], H and W multiples of 64, through ``pipe.process`` (or ``process``,
    a parallel entry point's callable, which fixes its own color fix) on the
    pipeline's device with the (1, L, C) prompt embedding ``y`` for every
    image; returns the restored batch as float32 numpy."""
    import torch

    def restore(x: np.ndarray, color_fix: str = "wavelet") -> np.ndarray:
        lq = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(y.device)
        ys = y.repeat(lq.shape[0], 1, 1)
        out = pipe.process(lq, ys, color_fix=color_fix) if process is None else process(lq, ys)
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


class RankedRestorer:
    """One rank's share of a parallel server. ``part(x)`` restores a batch on
    every rank of ``group`` together (the whole output on each). Rank 0 calls
    the object as a ``Batcher``'s restore: it pads the batch to a multiple of
    ``pad_to``, broadcasts it, runs its part and returns its rows; the other
    ranks run ``follow`` until rank 0 calls ``stop``. After each part every
    rank reports how it went, so an exception on any rank raises on rank 0."""

    def __init__(self, part: Callable[[np.ndarray], np.ndarray], group=None, pad_to: int = 1, device="cpu"):
        import torch
        import torch.distributed as dist

        self.part, self.group, self.pad_to = part, group, pad_to
        self.device = torch.device(device)
        self.src = 0 if group is None else dist.get_global_rank(group, 0)

    def _broadcast(self, t):
        import torch.distributed as dist

        t = t.to(self.device)
        dist.broadcast(t, src=self.src, group=self.group)
        return t.cpu()

    def _run(self, x: np.ndarray):
        import torch.distributed as dist

        out, err = None, None
        try:
            out = self.part(x)
        except Exception as exc:  # reported to rank 0 below; this rank goes on serving
            err = f"{type(exc).__name__}: {exc}"
        errors = [None] * dist.get_world_size(self.group)
        dist.all_gather_object(errors, err, group=self.group)
        failed = [(r, e) for r, e in enumerate(errors) if e is not None]
        if failed:
            raise RuntimeError("; ".join(f"rank {r}: {e}" for r, e in failed))
        return out

    def __call__(self, x: np.ndarray) -> np.ndarray:
        import torch

        n = x.shape[0]
        if n % self.pad_to:  # repeat the last request
            x = np.concatenate([x] + [x[-1:]] * (self.pad_to - n % self.pad_to))
        self._broadcast(torch.tensor([1, *x.shape], dtype=torch.int64))
        self._broadcast(torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)))
        return self._run(x)[:n]

    def stop(self) -> None:
        import torch

        self._broadcast(torch.tensor([0, 0, 0, 0, 0], dtype=torch.int64))

    def follow(self) -> int:
        """Serve rank 0's batches until it stops; returns the batch count."""
        import torch

        batches = 0
        while True:
            head = self._broadcast(torch.zeros(5, dtype=torch.int64)).tolist()
            if head[0] == 0:
                return batches
            x = self._broadcast(torch.zeros(head[1:], dtype=torch.float32)).numpy()
            batches += 1
            try:
                self._run(x)
            except RuntimeError:  # rank 0 answers the batch's requests with it
                pass


def serve_rank(args, group=None) -> RankedRestorer:
    """This rank's ``RankedRestorer`` for the mesh flags: the pipeline of
    ``inference.load_pipeline`` laid out by the parallel entry point the flags
    name, over ``group`` (the world by default)."""
    import torch
    import torch.distributed as dist

    from instarevive_tpu_torch.inference import load_pipeline
    from instarevive_tpu_torch.parallel.pp import MICROBATCHES

    pipe, y = load_pipeline(args)
    group = group or dist.group.WORLD
    size = dist.get_world_size(group)
    device = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend(group) == "nccl" else \
        torch.device("cpu")
    pad_to = 1
    if args.pipeline_parallel > 1:
        process, pad_to = pipe.pp(group, MICROBATCHES, color_fix="wavelet"), MICROBATCHES
    elif args.seq_parallel > 1:
        process = pipe.sp(group, color_fix="wavelet")
    else:
        data, tensor = max(args.data_parallel, 1), max(args.tensor_parallel, 1)
        if data * tensor != size:
            raise ValueError(f"data {data} x tensor {tensor} ranks, the group has {size}")
        data_group = tensor_group = group
        if data > 1 and tensor > 1:  # the world's ('data', 'fsdp', 'tensor') mesh
            from instarevive_tpu_torch.parallel.mesh import make_mesh

            mesh = make_mesh(data, 1, tensor, device_type=device.type)
            data_group, tensor_group = mesh["data"].get_group(), mesh["tensor"].get_group()
        if tensor > 1:
            process = pipe.tp(tensor_group, data_group if data > 1 else None, color_fix="wavelet")
        else:
            process = pipe.sharded(data_group, color_fix="wavelet")
        pad_to = data
    return RankedRestorer(make_restorer(pipe, y, process), group, pad_to, device)


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
    import sys

    from instarevive_tpu_torch.parallel.dist import check_cards, env_world, init_distributed, launch

    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    ranked = None
    if args.world > 1:
        if env_world() == 1:  # start the ranks on this host; each runs this main under WORLD_SIZE
            check_cards(args.world, args.device)
            launch(main, argv, args.world)
            return
        rank, world = init_distributed(args.device)
        if world != args.world:
            raise SystemExit(f"the mesh flags ask for {args.world} ranks, WORLD_SIZE is {world}")
        ranked = serve_rank(args)
        if rank:
            ranked.follow()
            return
    batcher = Batcher(ranked or build_restorer(args), args.max_batch, args.batch_window_ms)
    server = make_server(batcher, args.port)
    print(f"[serve] listening on :{server.server_address[1]} (max_batch={args.max_batch}, device={args.device}"
          + (f", {args.world} ranks" if ranked else "") + ")", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        batcher.close()
        if ranked is not None:
            ranked.stop()


if __name__ == "__main__":
    main()
