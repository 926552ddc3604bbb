"""Streaming parallel image input pipeline.

Counterpart of ``analytics_zoo_tpu/feature/image/pipeline.py``: decode +
augment + collate of whole minibatches runs in a pool of workers, and
finished host batches flow through a bounded in-flight window, so the
device never waits on the decoder while the pool keeps up
(``zoo/.../feature/image/ImageSet.scala:46-140``, SURVEY section 7 hard
part (c)). The consumer-side stall is measured, not guessed:
``stats.infeed_wait_s`` is the time ``batches()`` blocked on the pool.

Files decode through the port's codec and resize (``codec.py``,
``resize.py``): the JPEG decoder is C++ called through ctypes, which
releases the GIL, so the thread pool scales over the decode; the
process pool suits augment chains that hold the GIL.

- one task = one whole minibatch (collated in the worker): the IPC/sync
  cost is per batch, not per image, and the trainer receives arrays that
  are already layout-final.
- a bounded in-flight window (default 2x workers) instead of an
  unbounded imap: a slow consumer backpressures the decoders.
- the pipeline is a FeatureSet, so ``Model.fit`` consumes it like any
  other dataset.
"""

from __future__ import annotations

import os
import time
from collections import deque
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..feature_set import FeatureSet, MiniBatch
from . import codec
from .resize import INTER_LINEAR, resize as _resize

__all__ = ["ImagePipelineFeatureSet", "decode_batch", "PipelineStats"]


@dataclass
class PipelineStats:
    """Consumer-visible throughput accounting for one ``batches()`` pass."""

    batches: int = 0
    images: int = 0
    infeed_wait_s: float = 0.0   # time the consumer blocked on the pool
    elapsed_s: float = 0.0
    worker_decode_s: float = 0.0  # summed across workers (wall / pool-par)

    def throughput(self) -> float:
        return self.images / self.elapsed_s if self.elapsed_s > 0 else 0.0

    def input_bound_fraction(self) -> float:
        """Share of the pass's wall time the consumer spent blocked on the
        pool — same definition as the engine's InputBoundFraction scalar."""
        if self.elapsed_s <= 0:
            return 0.0
        return min(1.0, self.infeed_wait_s / self.elapsed_s)

    def as_dict(self) -> dict:
        return {"batches": self.batches, "images": self.images,
                "infeed_wait_s": round(self.infeed_wait_s, 4),
                "elapsed_s": round(self.elapsed_s, 4),
                "throughput_img_s": round(self.throughput(), 1),
                "input_bound_fraction": round(self.input_bound_fraction(),
                                              4)}


def _decode_one(path: str, height: int, width: int,
                augment: Optional[Callable], to_chw: bool,
                mean, std) -> np.ndarray:
    """bytes -> HWC float32 (or CHW when ``to_chw``), BGR like the
    reference's OpenCVMat; the normalization constants passed by callers
    are BGR-ordered too."""
    with open(path, "rb") as f:
        img = codec.decode(f.read(), path)
    # float32 BEFORE resize: matches the eager ImageSet path
    # (ImageBytesToMat converts first) — uint8 resize rounds differently
    img = np.asarray(img, np.float32)
    if (img.shape[0], img.shape[1]) != (height, width):
        img = _resize(img, (width, height), INTER_LINEAR)
    if augment is not None:
        img = augment(img)
    if mean is not None:
        img = img - np.asarray(mean, np.float32)
    if std is not None:
        img = img / np.asarray(std, np.float32)
    if to_chw:
        img = np.transpose(img, (2, 0, 1))
    return img


def decode_batch(paths: Sequence[str], labels, height: int, width: int,
                 augment=None, to_chw: bool = False, mean=None, std=None):
    """Worker task: decode+augment+collate one minibatch. Returns
    (stacked NHWC/NCHW float32, labels or None, worker_seconds)."""
    t0 = time.perf_counter()
    imgs = [_decode_one(p, height, width, augment, to_chw, mean, std)
            for p in paths]
    xs = np.stack(imgs)
    ys = None if labels is None else np.asarray(labels)
    return xs, ys, time.perf_counter() - t0


class ImagePipelineFeatureSet(FeatureSet):
    """File-backed images decoded on the fly by a worker pool.

    Unlike ``ImageSet.read`` (which materializes every decoded image
    up front — fine for fixtures, fatal for ImageNet), this holds only
    paths + labels and streams ready minibatches.

    Parameters
    ----------
    augment: a picklable callable ``HWC float32 -> HWC float32`` applied
        per image in the worker (e.g. a ``ChainedPreprocessing`` of the
        2D ops); random augments must draw from numpy's per-process RNG.
    backend: "thread" (default: the C++ JPEG decoder releases the GIL)
        or "process" (python-heavy augment chains).
    in_flight: max batches decoded ahead of the consumer (the double
        buffer depth). Defaults to ``2 * num_workers``.
    """

    def __init__(self, paths: Sequence[str], labels=None, *,
                 height: int, width: int,
                 num_workers: Optional[int] = None,
                 augment: Optional[Callable] = None,
                 data_format: str = "tf",
                 mean=None, std=None,
                 backend: str = "thread",
                 in_flight: Optional[int] = None):
        self.paths: List[str] = [str(p) for p in paths]
        self.labels = None if labels is None else np.asarray(labels)
        if self.labels is not None and len(self.labels) != len(self.paths):
            raise ValueError("labels/paths length mismatch")
        self.height, self.width = int(height), int(width)
        self.augment = augment
        self.to_chw = data_format in ("th", "NCHW", "nchw")
        self.mean, self.std = mean, std
        # same knob as the engine's transform pool so one env var sizes
        # the whole host pipeline (the shared resolver reads
        # ZOO_TPU_TRANSFORM_WORKERS and auto-sizes from the core count)
        from ..host_pipeline import resolve_transform_workers
        self.num_workers = max(1, resolve_transform_workers(num_workers))
        self.backend = backend
        self.in_flight = int(in_flight or 2 * self.num_workers)
        self.stats = PipelineStats()

    @classmethod
    def read_folder(cls, root: str, one_based_label: bool = True, **kw):
        """Labeled directory tree (class-per-subdir), like
        ``ImageSet._read_with_label`` but without decoding anything."""
        import glob as _glob
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        label_map = {c: i + (1 if one_based_label else 0)
                     for i, c in enumerate(classes)}
        paths, labels = [], []
        for c in classes:
            for p in sorted(_glob.glob(os.path.join(root, c, "*"))):
                if p.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")):
                    paths.append(p)
                    labels.append(label_map[c])
        fs = cls(paths, np.asarray(labels, np.float32), **kw)
        fs.label_map = label_map
        return fs

    def size(self) -> int:
        return len(self.paths)

    def _make_pool(self):
        if self.backend == "process":
            return ProcessPoolExecutor(max_workers=self.num_workers)
        return ThreadPoolExecutor(max_workers=self.num_workers,
                                  thread_name_prefix="zoo-img")

    def batches(self, batch_size: int, shuffle: bool = False,
                drop_remainder: bool = True, pad_remainder: bool = False,
                seed: int = 0):
        idx = np.arange(len(self.paths))
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        n = len(idx)
        if drop_remainder:
            n = (n // batch_size) * batch_size
        starts = list(range(0, n, batch_size))
        stats = PipelineStats()
        self.stats = stats
        t_start = time.perf_counter()
        pool = self._make_pool()
        try:
            pending: deque = deque()
            submit_iter = iter(starts)

            def submit_next():
                s = next(submit_iter, None)
                if s is None:
                    return False
                sel = idx[s:s + batch_size]
                pad = 0
                if len(sel) < batch_size and pad_remainder:
                    # pad by repeating the last sample with ZERO weight
                    # (the ArrayFeatureSet contract: the trainer's
                    # evaluate/predict mask pads via weights > 0)
                    pad = batch_size - len(sel)
                    sel = np.concatenate([sel, np.repeat(sel[-1:], pad)])
                pending.append((pad, pool.submit(
                    decode_batch, [self.paths[i] for i in sel],
                    None if self.labels is None else self.labels[sel],
                    self.height, self.width, self.augment, self.to_chw,
                    self.mean, self.std)))
                return True

            for _ in range(self.in_flight):
                if not submit_next():
                    break
            while pending:
                pad, fut = pending.popleft()
                t0 = time.perf_counter()
                xs, ys, wsec = fut.result()
                stats.infeed_wait_s += time.perf_counter() - t0
                stats.worker_decode_s += wsec
                submit_next()
                stats.batches += 1
                stats.images += len(xs) - pad
                w = np.ones(len(xs), np.float32)
                if pad:
                    w[-pad:] = 0.0
                yield MiniBatch([xs], ys, w)
        finally:
            try:
                pool.shutdown(wait=False, cancel_futures=True)
            except Exception:  # interpreter teardown: modules half-gone
                pass
            stats.elapsed_s = time.perf_counter() - t_start
