"""Streaming single-frame inference with a keyframe feature cache (the JAX
package's ``inference/streaming.py``).

Each frame is encoded once.  Its four pre-motion level features go into a
per-level cache on the device of ``inference_length + max(keyframes) − 1``
frames, preallocated at the first frame and written in place
(``index_copy_``).  From frame ``L − 1`` on, each step gathers an
``L − 1``-frame window of cached features (the precomputed keyframe
schedule of ``streaming_schedule``), appends the new frame and runs the
temporal head on the window.  The cache shift of the reference is a
host-side virtual→physical slot map: only the new frame's slot is
written.

Steady-state modes, as in JAX:

* plain: one frame per step, the depth of the newest frame;
* chunked (``chunk_size`` K > 1): K steady frames in one batch, the
  encoder over K frames and the head over K windows (``_steady_indices``
  redirects a gather to a frame of the same chunk where its slot was
  rewritten within the chunk), K clamped to ``cache_len − 2`` so that the
  K write slots are distinct;
* aligned (``align_each_new_frame``): each step also predicts the
  keyframes' depth and fits (s, t) of the new frame against the depths
  already emitted for them, on the device against a ring of emitted
  depths (``ring_dtype``) or, with ``device_align=False`` and in the
  transition phase, on the host;
* aligned chunk: the encoder over K frames, then K
  ``streaming_head_step``s in order, each reading the cache and ring the
  previous one wrote (the JAX ``lax.scan``).

Depth leaves the device one step late (``utils/device.start_host_transfer``)
in ``transfer_dtype``, so that its copy overlaps the next step.  Options
left at ``None`` read the JAX package's switches: ``ring_dtype``
``VDA_RING_DTYPE``, ``host_upsample`` ``VDA_HOST_UPSAMPLE``,
``device_align`` ``VDA_DEVICE_ALIGN`` (on unless ``0``) and
``transfer_dtype`` ``VDA_TRANSFER_DTYPE``.

Reference quirks kept: without ``align_each_new_frame`` the first ``L − 1``
frames get no depth; with it frame 0 serves the alignment only and is
dropped; ``warmup=False`` is not implemented; a 0 keyframe with align is
refused (the reference crashes on it).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from video_depth_anything_torch.ops.resize import bilinear_resize, bilinear_resize_np
from video_depth_anything_torch.ops.scale_shift import (
    compute_scale_and_shift,
    compute_scale_and_shift_torch,
)
from video_depth_anything_torch.utils.device import (
    env_switch,
    resolve_transfer_dtype,
    start_host_transfer,
    transfer_cast,
)
from video_depth_anything_torch.utils.stats import Progress
from video_depth_anything_torch.utils.transform import preprocess_frames

RING_DTYPES = {"fp32": torch.float32, "fp16": torch.float16, "bf16": torch.bfloat16}


def streaming_schedule(
    inference_length: int, keyframe_list: Sequence[int]
) -> Tuple[List[int], List[List[int]], List[List[int]]]:
    """``(static_keyframes, use_feature_idx, align_idx)``: for each step of
    the transition phase (frames ``L − 1`` .. ``L + max_kf − 1``) the cache
    slots of its window, slot 0 pinned to the first frame and the keyframe
    slots redirected by their distance schedule, and the window positions
    of the alignment keyframes."""
    L = inference_length
    kfs = list(keyframe_list)
    max_kf = max(kfs)
    dist = [kf + (L - len(kfs)) for kf in kfs]

    static_kf: List[int] = [L - kf if L > kf else i + 1 for i, kf in enumerate(kfs)]
    if len(static_kf) != len(set(static_kf)):
        raise ValueError(f"keyframe setup yields duplicate slots: {static_kf}")

    use_feature_idx: List[List[int]] = []
    align_idx: List[List[int]] = []
    for frame_idx in range(L - 1, L + max_kf):
        tmp = list(range(frame_idx - (L - 1), frame_idx))
        tmp[0] = 0  # the first frame is always the anchor
        aib = [0]
        for i, sk in enumerate(static_kf):
            if sk in tmp:
                aib.append(tmp.index(sk))
            else:
                aib.append(i + 1)
                if frame_idx - dist[i] <= sk:
                    tmp[i + 1] = sk
                else:
                    tmp[i + 1] = sk + (frame_idx - dist[i] - sk)
        use_feature_idx.append(tmp)
        align_idx.append(aib)
    return static_kf, use_feature_idx, align_idx


class StreamingDepthPipeline:
    """Streaming inference around a ``VDAModel``; ``infer(frames)`` as the
    JAX pipeline.  ``device_align=False`` fits every aligned frame on the
    host (the JAX ``VDA_DEVICE_ALIGN=0``); options left at ``None`` read
    the environment (module docstring)."""

    def __init__(
        self,
        model,
        input_size: int = 518,
        inference_length: int = 32,
        keyframe_list: Tuple[int, ...] = (0, 12),
        align_each_new_frame: bool = False,
        chunk_size: int = 8,
        ring_dtype: Optional[str] = None,
        host_upsample: Optional[bool] = None,
        transfer_dtype: Optional[str] = None,
        device_align: Optional[bool] = None,
        model_parallel: int = 1,
    ):
        if inference_length <= len(keyframe_list) + 2:
            raise ValueError("inference_length too small for the keyframe list")
        ring_dtype = ring_dtype or os.environ.get("VDA_RING_DTYPE", "fp32")
        if ring_dtype not in RING_DTYPES:
            raise ValueError(f"ring_dtype must be fp32|fp16|bf16, got {ring_dtype!r}")
        self.transfer_dtype = resolve_transfer_dtype(transfer_dtype)
        self.model = model
        self.input_size = input_size
        self.L = inference_length
        self.keyframes = tuple(keyframe_list)
        self.max_kf = max(keyframe_list)
        self.cache_len = self.L + self.max_kf - 1
        self.align = bool(align_each_new_frame)
        # the aligned fits consume output-resolution depth, so align keeps
        # the device resize
        self.host_upsample = env_switch(host_upsample, "VDA_HOST_UPSAMPLE", default=False) \
            and not self.align
        self.ring_dtype = RING_DTYPES[ring_dtype]
        self.device_align = env_switch(device_align, "VDA_DEVICE_ALIGN", default=True)
        # past cache_len − 2 the freed slots of one chunk repeat, and two
        # writes of one index_copy_ to one slot have no defined winner
        self.chunk = min(max(1, int(chunk_size)), self.cache_len - 2)
        # tensor-parallel streaming: the encoder split over a model group of
        # model_parallel ranks (parallel/mesh.py), inputs replicated
        self.model_parallel = int(model_parallel)
        if self.model_parallel > 1:
            from video_depth_anything_torch.parallel.mesh import create_grid, shard_module

            shard_module(model.module, create_grid(model=self.model_parallel))
        self.static_kf, self.use_feature_idx, self.align_idx = streaming_schedule(
            inference_length, keyframe_list)
        if self.align and max(self.use_feature_idx[0]) > self.L - 2:
            # a 0 keyframe redirects a slot of the first prediction past the
            # L − 1 cached frames (the reference's IndexError at
            # dpt_temporal.py:189)
            raise ValueError(
                "align_each_new_frame with this keyframe_list references unfilled cache "
                "slots at the first prediction (a latent crash in the reference as well); "
                "use keyframes > 0, e.g. keyframe_list=(12,)")

    # -- index tables -----------------------------------------------------------

    def _steady_indices(self, phys: List[int], k: int):
        """Advance the virtual→physical slot map by ``k`` steady frames:
        ``(gather_idx (k, L−1), write_slots (k,), new phys)``.  Gather
        positions ≥ cache_len are frames of the same chunk whose slot was
        freed and rewritten within it."""
        virt = self.use_feature_idx[-1]
        gather = np.empty((k, len(virt)), dtype=np.int64)
        slots = np.empty((k,), dtype=np.int64)
        written: dict = {}
        for j in range(k):
            for a, v in enumerate(virt):
                p = phys[v]
                gather[j, a] = self.cache_len + written[p] if p in written else p
            slot = phys[1]
            slots[j] = slot
            written[slot] = j
            phys = [phys[0]] + phys[2:] + [slot]
        return gather, slots, phys

    def _aligned_steady_indices(self, phys: List[int], k: int):
        """Advance the slot map by ``k`` steady aligned frames:
        ``(use_idx (k, L−1), slots (k,), align_gather (k, n_kf), phys)``.
        No redirects: the K head steps run in order, each on the cache the
        previous one wrote."""
        virt = self.use_feature_idx[-1]
        aidx = self.align_idx[-1]
        use = np.empty((k, len(virt)), dtype=np.int64)
        slots = np.empty((k,), dtype=np.int64)
        gather = np.empty((k, len(aidx)), dtype=np.int64)
        for j in range(k):
            row = [phys[v] for v in virt]
            use[j] = row
            gather[j] = [row[a] for a in aidx]
            slot = phys[1]
            slots[j] = slot
            phys = [phys[0]] + phys[2:] + [slot]
        return use, slots, gather, phys

    # -- device steps -------------------------------------------------------------

    def _idx(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=self.model.device)

    @staticmethod
    def _write(cache, slots: torch.Tensor, feats) -> None:
        for c, f in zip(cache, feats):
            c.index_copy_(0, slots, f)

    @staticmethod
    def _gather(cache, use_idx: torch.Tensor, pred_idx):
        """The step's cached windows; levels 1 and 2 only where a
        ``pred_idx`` reads them."""
        c1, c2, c3, c4 = cache
        if pred_idx is None:
            return None, None, c3[use_idx], c4[use_idx]
        return c1[use_idx], c2[use_idx], c3[use_idx], c4[use_idx]

    @staticmethod
    def _to_output(depth: torch.Tensor, out_hw) -> torch.Tensor:
        """fp32 depth, resized to the source resolution unless ``out_hw`` is
        None (host upsample)."""
        depth = depth.float()
        if out_hw is not None and tuple(out_hw) != tuple(depth.shape[1:]):
            depth = bilinear_resize(depth[..., None], *out_hw)[..., 0]
        return depth

    def _step(self, x, cache, use_idx, slot, pred_idx, skip_tmp_block, out_hw):
        depth, new = self.model.module.streaming_step(
            x, self._gather(cache, use_idx, pred_idx), pred_idx, skip_tmp_block)
        self._write(cache, slot, new)
        return self._to_output(depth, out_hw)

    def _chunk_step(self, xs, cache, gather, slots, skip_tmp_block, out_hw):
        depth, new = self.model.module.streaming_chunk_step(xs, cache, gather, skip_tmp_block)
        self._write(cache, slots, new)
        return self._to_output(depth, out_hw)

    def _aligned_head(self, levels, cache, dring, use_idx, slot, align_gather, pred_idx,
                      skip_tmp_block, out_hw, x=None):
        """One aligned steady step from the frame ``x`` or its level
        features: predict keyframes and frame, fit (s, t) against the ring's
        emitted keyframe depths on the device, write features and emitted
        depth into ``slot``; returns the emitted ``(1, fh, fw)`` fp32 depth."""
        cached = self._gather(cache, use_idx, pred_idx)
        if x is not None:
            depth, new = self.model.module.streaming_step(x, cached, pred_idx, skip_tmp_block)
        else:
            depth, new = self.model.module.streaming_head_step(levels, cached, pred_idx,
                                                               skip_tmp_block)
        depth = self._to_output(depth, out_hw)
        # ring reads upcast to fp32; a reduced-precision ring quantizes only
        # the fit's references, never the emitted depth
        s, t = compute_scale_and_shift_torch(depth[:-1], dring[align_gather].float())
        aligned = depth[-1:] * s + t
        self._write(cache, slot, new)
        dring.index_copy_(0, slot, aligned.to(dring.dtype))
        return aligned

    # -- main loop ------------------------------------------------------------------

    @torch.inference_mode()
    def infer(self, frames: np.ndarray, target_fps: float = -1, skip_tmp_block: bool = False,
              warmup: bool = True, progress: bool = False) -> Tuple[np.ndarray, float]:
        """uint8 RGB ``(N, H, W, 3)`` → (depth ``(M, H, W)`` fp32, fps);
        ``progress`` counts the frames on stderr."""
        if not warmup:
            raise NotImplementedError("warmup=False is not implemented")
        org_len, fh, fw = frames.shape[:3]
        L, max_kf = self.L, self.max_kf
        dev, dtype = self.model.device, self.model.dtype
        pre = preprocess_frames(frames, self.input_size)
        out_hw = None if self.host_upsample else (fh, fw)
        device_align = self.align and self.device_align
        align_pos = self._idx(self.align_idx[-1])

        def load(a, b):
            return torch.from_numpy(pre[a:b]).to(dev, dtype)

        cache: Optional[Tuple[torch.Tensor, ...]] = None
        dring = (torch.zeros((self.cache_len, fh, fw), dtype=self.ring_dtype, device=dev)
                 if device_align else None)
        depth_list: List[np.ndarray] = []
        pending = []

        def emit(depth, force=False):
            """One step of lag: start this result's copy now, so that it
            overlaps the next step, and drain the older ones (all when
            ``force``)."""
            if depth is not None:
                pending.append(start_host_transfer(transfer_cast(depth, self.transfer_dtype)))
            while pending and (force or len(pending) > 1):
                d = pending.pop(0).numpy()
                if self.host_upsample:
                    d = bilinear_resize_np(d, fh, fw)
                depth_list.extend(d)

        old_keyframes_started = False
        # virtual→physical slot map: the new frame goes into the slot that
        # the reference's whole-cache shift frees
        phys = list(range(self.cache_len))
        steady_from = L + max_kf
        bar = Progress(org_len, "frames", enabled=progress)
        i = 0
        while i < org_len:
            bar.update(i - bar.done)
            steady_chunk = i >= steady_from and self.chunk > 1 and org_len - i >= self.chunk
            if steady_chunk and device_align:
                k = self.chunk
                use, slots, gathers, phys = self._aligned_steady_indices(phys, k)
                levels = self.model.module.encode_level_features(load(i, i + k))
                out = [self._aligned_head(tuple(lv[j:j + 1] for lv in levels), cache, dring,
                                          self._idx(use[j]), self._idx(slots[j:j + 1]),
                                          self._idx(gathers[j]), align_pos, skip_tmp_block,
                                          (fh, fw))
                       for j in range(k)]
                emit(torch.cat(out))
                i += k
                continue
            if steady_chunk and not self.align:
                k = self.chunk
                gather, slots, phys = self._steady_indices(phys, k)
                emit(self._chunk_step(load(i, i + k), cache, self._idx(gather), self._idx(slots),
                                      skip_tmp_block, out_hw))
                i += k
                continue

            x = load(i, i + 1)
            if i < L - 1:
                feats = self.model.module.encode_level_features(x)
                if cache is None:
                    cache = tuple(torch.zeros((self.cache_len,) + f.shape[1:], dtype=f.dtype,
                                              device=dev) for f in feats)
                self._write(cache, self._idx([i]), feats)
                i += 1
                continue

            sched = i - (L - 1) if i < L + max_kf else -1
            use_virt = self.use_feature_idx[sched]
            pred_idx: Optional[Tuple[int, ...]] = None
            abs_pred_idx: Optional[List[int]] = None
            if self.align:
                if i < L + max_kf:
                    abs_pred_idx = [use_virt[j] for j in self.align_idx[sched]]
                    pred_idx = (tuple(use_virt) if i == L - 1
                                else tuple(self.align_idx[sched]))
                else:
                    pred_idx = tuple(self.align_idx[-1])
                    # the cache has shifted since the transition phase
                    # (reference video_depth.py:263-269)
                    abs_pred_idx = [0 if use_virt[j] == 0 else use_virt[j] + (i - steady_from) + 1
                                    for j in self.align_idx[-1]]
            use_idx = [phys[v] for v in use_virt]
            if i < self.cache_len:
                slot = i
            else:
                slot = phys[1]
                phys = [phys[0]] + phys[2:] + [slot]
            slot_t = self._idx([slot])

            if device_align and i >= steady_from:
                align_gather = [use_idx[j] for j in self.align_idx[-1]]
                emit(self._aligned_head(None, cache, dring, self._idx(use_idx), slot_t,
                                        self._idx(align_gather), self._idx(pred_idx),
                                        skip_tmp_block, (fh, fw), x=x))
                i += 1
                continue

            pred_t = None if pred_idx is None else self._idx(pred_idx)
            depth = self._step(x, cache, self._idx(use_idx), slot_t, pred_t, skip_tmp_block,
                               out_hw)
            if not self.align:
                emit(depth)
                i += 1
                continue
            # transition phase (and every aligned frame without device
            # align): the host fit needs this frame's depth now; the emitted
            # depths also seed the device ring for the steady phase
            depth = depth.cpu().numpy()
            if not old_keyframes_started:
                old_keyframes_started = True
                depth_list.extend(depth)
                if device_align:
                    dring.index_copy_(0, self._idx(use_idx + [slot]),
                                      torch.from_numpy(depth).to(dev, self.ring_dtype))
            else:
                n_kf = len(pred_idx)
                s, t = compute_scale_and_shift(np.concatenate(depth[:n_kf]),
                                               np.concatenate([depth_list[j] for j in abs_pred_idx]))
                emitted = depth[-1] * s + t
                depth_list.append(emitted)
                if device_align:
                    dring.index_copy_(0, slot_t,
                                      torch.from_numpy(emitted[None]).to(dev, self.ring_dtype))
            i += 1

        emit(None, force=True)
        bar.update(org_len - bar.done)
        bar.close()
        depth_list = depth_list[1:org_len] if self.align else depth_list[:org_len]
        if not depth_list:
            # fewer frames than the window: nothing predicted
            return np.zeros((0, fh, fw), np.float32), target_fps
        return np.stack(depth_list, axis=0).astype(np.float32), target_fps
