"""Host-side datasets and loader (``instarevive_tpu/data/dataset.py``): file
lists, 3-retry reads, center or random crops with a box-resize when the short
side is under the crop size, horizontal flips, and a threaded batcher that
yields stacked uint8 numpy batches in a seeded, resumable order.

The port's own copy: a JPEG decodes and crops through the native loader
(``data/native_loader.py``) when its library is built, anything else through
PIL, on the host; the trainer moves each batch to the device.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
from PIL import Image

from instarevive_tpu_torch.utils.image_io import list_image_files


def _load_retry(path: str, retries: int = 3) -> Optional[np.ndarray]:
    """3-retry image read (codeformer.py:112-119)."""
    for i in range(retries):
        try:
            return np.asarray(Image.open(path).convert("RGB"))
        except Exception:
            time.sleep(1 + i)
    return None


def _crop(img: np.ndarray, size: int, rng: np.random.Generator, random_crop: bool):
    h, w = img.shape[:2]
    if min(h, w) < size:
        # box-resize short side up to size (codeformer.py:127-135)
        r = size / min(h, w)
        nh, nw = int(np.ceil(h * r)), int(np.ceil(w * r))
        img = np.asarray(Image.fromarray(img).resize((nw, nh), Image.BICUBIC))
        h, w = nh, nw
    if random_crop:
        y = int(rng.integers(0, h - size + 1))
        x = int(rng.integers(0, w - size + 1))
    else:
        y, x = (h - size) // 2, (w - size) // 2
    return img[y : y + size, x : x + size]


class ImageFolderDataset:
    """HQ crops from a folder or file list (the reference's file_list txt)."""

    def __init__(
        self,
        path: str,
        out_size: int = 512,
        crop_type: str = "center",  # center | random | none
        use_hflip: bool = True,
        seed: int = 0,
    ):
        if path.endswith(".txt"):
            with open(path) as f:
                self.files: List[str] = [ln.strip() for ln in f if ln.strip()]
        else:
            self.files = list_image_files(path)
        self.out_size = out_size
        self.crop_type = crop_type
        self.use_hflip = use_hflip
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        path = self.files[idx]
        flip = self.use_hflip and self.rng.random() < 0.5
        if self.crop_type != "none" and path.lower().endswith((".jpg", ".jpeg")):
            # decode and crop in C++ (native/fastloader.cpp); None when the library is not built
            from instarevive_tpu_torch.data import native_loader

            img = native_loader.decode_crop(
                path, self.out_size, crop=self.crop_type,
                seed=int(self.rng.integers(0, 2**63)), hflip=flip,
            )
            if img is not None:
                return {"hq": img}
        img = _load_retry(path)
        if img is None:
            img = np.zeros((self.out_size, self.out_size, 3), np.uint8)
        if self.crop_type != "none":
            img = _crop(img, self.out_size, self.rng, self.crop_type == "random")
        if flip:
            img = img[:, ::-1]
        return {"hq": np.ascontiguousarray(img)}


class PrefetchLoader:
    """Threaded batcher: yields stacked uint8 numpy batches in a seeded
    order (in place of a torch DataLoader worker pool)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_threads: int = 4,
        prefetch: int = 4,
        seed: int = 0,
        drop_last: bool = True,
    ):
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last
        self._skip_next = 0

    def __len__(self) -> int:
        n = len(self.ds)
        return n // self.bs if self.drop_last else -(-n // self.bs)

    def fast_forward(self, total_batches: int) -> None:
        """Advance the loader past ``total_batches`` already-consumed batches
        (checkpoint resume): replays the per-epoch shuffles so the data
        stream continues exactly where the interrupted run left off, without
        loading any images."""
        per_epoch = len(self)
        for _ in range(total_batches // per_epoch):
            if self.shuffle:  # consume one epoch's shuffle draw
                self.rng.shuffle(np.arange(len(self.ds)))
        self._skip_next = total_batches % per_epoch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.ds))
        if self.shuffle:
            self.rng.shuffle(order)
        skip, self._skip_next = self._skip_next, 0
        n_batches = len(order) // self.bs if self.drop_last else -(-len(order) // self.bs)
        if skip:
            order = order[min(skip, n_batches) * self.bs :]
            n_batches = max(n_batches - skip, 0)
            if n_batches == 0:
                return iter(())
        if n_batches == 0:
            # an empty epoch would make `while steps: for batch in loader`
            # callers busy-spin forever — fail loudly instead
            raise ValueError(
                f"dataset of {len(order)} samples yields no batches of "
                f"{self.bs} (drop_last={self.drop_last})"
            )
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        idx_q: "queue.Queue" = queue.Queue()
        for i in range(n_batches):
            idx_q.put((i, order[i * self.bs : (i + 1) * self.bs]))

        results: Dict[int, Dict[str, np.ndarray]] = {}
        lock = threading.Lock()

        def worker():
            while True:
                try:
                    i, idxs = idx_q.get_nowait()
                except queue.Empty:
                    return
                samples = [self.ds[int(j)] for j in idxs]
                batch = {
                    k: np.stack([s[k] for s in samples]) for k in samples[0]
                }
                with lock:
                    results[i] = batch

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self.num_threads)]
        for t in threads:
            t.start()

        served = 0
        while served < n_batches:
            with lock:
                if served in results:
                    batch = results.pop(served)
                else:
                    batch = None
            if batch is None:
                time.sleep(0.005)
                continue
            yield batch
            served += 1


class PairQueue:
    """Training-pair pool for intra-batch degradation diversity
    (batch_transform.py:97-134 _dequeue_and_enqueue), as a host-side
    numpy ring with shuffle-on-full semantics."""

    def __init__(self, queue_size: int, seed: int = 0):
        self.size = queue_size
        self.rng = np.random.default_rng(seed)
        self.lq = None
        self.hq = None
        self.ptr = 0

    def __call__(self, lq: np.ndarray, hq: np.ndarray):
        b = lq.shape[0]
        if self.lq is None:
            assert self.size % b == 0, f"queue {self.size} % batch {b} != 0"
            self.lq = np.zeros((self.size,) + lq.shape[1:], lq.dtype)
            self.hq = np.zeros((self.size,) + hq.shape[1:], hq.dtype)
        if self.ptr == self.size:
            idx = self.rng.permutation(self.size)
            self.lq, self.hq = self.lq[idx], self.hq[idx]
            lq_out, hq_out = self.lq[:b].copy(), self.hq[:b].copy()
            self.lq[:b], self.hq[:b] = lq, hq
            return lq_out, hq_out
        self.lq[self.ptr : self.ptr + b] = lq
        self.hq[self.ptr : self.ptr + b] = hq
        self.ptr += b
        return lq, hq


# Aspect-ratio bucket tables (diffusion/data/datasets/utils.py convention:
# ratio -> (h, w)); ASPECT_RATIO_512 subset, the ones PixArtMS uses at 512.
ASPECT_RATIO_512 = {
    0.25: (256, 1024), 0.33: (288, 864), 0.5: (352, 704), 0.67: (416, 624),
    0.75: (432, 576), 0.82: (448, 544), 1.0: (512, 512), 1.21: (544, 448),
    1.33: (576, 432), 1.5: (624, 416), 2.0: (704, 352), 3.0: (864, 288),
    4.0: (1024, 256),
}


class AspectRatioBatchSampler:
    """Buckets dataset indices by closest aspect ratio and emits homogeneous
    batches (diffusion/utils/data_sampler.py:10-120)."""

    def __init__(self, ratios: Sequence[float], batch_size: int,
                 table=None, seed: int = 0, drop_last: bool = True):
        self.table = table or ASPECT_RATIO_512
        keys = np.asarray(sorted(self.table.keys()))
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.buckets: Dict[float, List[int]] = {k: [] for k in keys}
        for i, r in enumerate(ratios):
            closest = keys[np.argmin(np.abs(keys - r))]
            self.buckets[float(closest)].append(i)
        self.drop_last = drop_last

    def __iter__(self):
        batches = []
        for ratio, idxs in self.buckets.items():
            idxs = list(idxs)
            self.rng.shuffle(idxs)
            for i in range(0, len(idxs) - (len(idxs) % self.batch_size if self.drop_last else 0), self.batch_size):
                chunk = idxs[i : i + self.batch_size]
                if chunk and (not self.drop_last or len(chunk) == self.batch_size):
                    batches.append((ratio, chunk))
        self.rng.shuffle(batches)
        return iter(batches)


def closest_bucket(ratio: float, table=None):
    """(h, w) of the nearest aspect-ratio bucket (prepare_prompt_ar analog,
    diffusion/model/utils.py:442-)."""
    table = table or ASPECT_RATIO_512
    keys = np.asarray(sorted(table.keys()))
    return table[float(keys[np.argmin(np.abs(keys - ratio))])]


def parse_prompt_aspect(prompt: str):
    """Extract a trailing 'H:W' aspect token from a prompt; returns
    (clean_prompt, ratio or None)."""
    import re

    m = re.search(r"\s*--ar\s+(\d+)\s*:\s*(\d+)\s*$", prompt)
    if not m:
        m = re.search(r"\s+(\d+):(\d+)\s*$", prompt)
    if m:
        h, w = int(m.group(1)), int(m.group(2))
        return prompt[: m.start()].strip(), h / w
    return prompt, None
