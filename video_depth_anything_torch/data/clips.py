"""Training clip sampler (a copy of the JAX package's numpy
``data/clips.py``): samples fixed-length frame clips from scene datasets,
preprocesses them to model resolution (``utils/transform.py``), converts
metric depth to disparity targets, and yields batches for
``train.Trainer`` — ``frames (B, T, h, w, 3)`` normalized, ``disparity``
and ``mask (B, T, h, w)`` (ground truth resized with nearest neighbour).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Sequence

import cv2
import numpy as np

from video_depth_anything_torch.utils.transform import preprocess_frames

_SENTINEL = object()


class Prefetcher:
    """Background-thread iterator prefetch (bounded queue).

    The clip sampler is pure host work (dataset decode, cv2 resizes, numpy
    packing) that otherwise serializes with device compute in the train
    loop; a ``depth``-deep prefetch keeps the next batches ready while the
    device runs the current step.  Exceptions from the producer re-raise at
    the consuming ``next()``; the thread is a daemon, so abandoning the
    iterator (e.g. a fixed-step train loop ending) never blocks exit.
    ``close()`` (or leaving a ``with`` block) stops the producer and waits
    for it, so that it reads no more files once the caller is done.
    """

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._err: BaseException | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._fill, args=(it,), daemon=True
        )
        self._thread.start()

    def _fill(self, it: Iterator) -> None:
        try:
            for item in it:
                if self._stop.is_set():
                    break
                self._q.put(item)
        except BaseException as e:  # noqa: BLE001 — re-raised at next()
            self._err = e
        finally:
            self._q.put(_SENTINEL)

    def close(self) -> None:
        """Stop the producer after the item it is making and wait for it."""
        self._stop.set()
        while self._thread.is_alive():
            try:  # make room for a producer blocked on a full queue
                self._q.get(timeout=0.1)
            except queue.Empty:
                pass
        self._q.put(_SENTINEL)  # next() stays terminal

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __iter__(self) -> "Prefetcher":
        return self

    def __next__(self):
        item = self._q.get()
        if item is _SENTINEL:
            self._q.put(_SENTINEL)  # keep subsequent next() terminal
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


class ClipSampler:
    def __init__(
        self,
        datasets: Sequence,
        clip_len: int = 8,
        batch_size: int = 1,
        input_size: int = 518,
        seed: int = 0,
        augment=None,
    ):
        """``augment``: an ``augment.AugmentConfig`` enables per-clip
        geometric + photometric augmentation (disparity/mask move with the
        frames; ``data/augment.py``)."""
        self.datasets = list(datasets)
        self.clip_len = clip_len
        self.batch_size = batch_size
        self.input_size = input_size
        self.augment = augment
        self.rng = np.random.RandomState(seed)
        self._index = [
            (d, s) for d, ds in enumerate(self.datasets) for s in range(len(ds))
        ]
        if not self._index:
            raise ValueError("no scenes available")

    def _sample_clip(self) -> Dict[str, np.ndarray]:
        d, s = self._index[self.rng.randint(len(self._index))]
        scene = self.datasets[d][s]
        frames = scene["image"]
        n = len(frames)
        t = min(self.clip_len, n)
        start = self.rng.randint(0, max(1, n - t + 1))
        # fixed-length clips: repeat the last frame when the scene is short,
        # so every clip in a batch stacks to the same T
        ids = np.minimum(np.arange(start, start + self.clip_len), start + t - 1)

        rgb = frames[ids]
        if rgb.dtype != np.uint8:
            rgb = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        depth = np.asarray(scene["depth"][ids], np.float32)
        valid = np.asarray(scene["valid_depth"][ids]).astype(np.float32)
        if self.augment is not None:
            from video_depth_anything_torch.data.augment import augment_clip

            rgb, depth, valid, _ = augment_clip(
                rgb, depth, valid, self.rng, self.augment
            )
        # square model resolution regardless of scene aspect ratio, so clips
        # from datasets of different resolutions batch together
        side = round(self.input_size / 14) * 14
        x = preprocess_frames(rgb, self.input_size, target_hw=(side, side))
        h, w = x.shape[1:3]
        gt_h, gt_w = depth.shape[1:]
        if (gt_h, gt_w) != (h, w):
            depth = np.stack(
                [cv2.resize(f, (w, h), interpolation=cv2.INTER_NEAREST) for f in depth]
            )
            valid = np.stack(
                [cv2.resize(f, (w, h), interpolation=cv2.INTER_NEAREST) for f in valid]
            )
        with np.errstate(divide="ignore"):
            disparity = np.where(depth > 0, 1.0 / depth, 0.0).astype(np.float32)
        mask = valid * (depth > 0)
        return {"frames": x, "disparity": disparity, "mask": mask}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            clips = [self._sample_clip() for _ in range(self.batch_size)]
            yield {
                k: np.stack([c[k] for c in clips]) for k in ("frames", "disparity", "mask")
            }
