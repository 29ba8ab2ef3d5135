"""KV-cache streaming inference: O(1) work per frame (the JAX package's
``inference/kv_streaming.py``).

A warm-up window over the first ``L`` frames gives their depth and seeds,
per motion module and attention block, caches of the position-free
projections ``to_k(x)``, ``to_v(x)`` (``VideoDepthAnything.
streaming_kv_start``).  Each later step computes the newest frame alone:
encoder, level features, each motion module's query frame against its
caches (``TemporalModule.kv_step``), refinenets and the output head.  The
caches keep ``L − 1`` entries, oldest → newest: each step appends the
newest frame and drops the oldest (or, aligned, the oldest after the
pinned first frame).  Cached frames keep the hidden states of the step in
which they were newest; there is no keyframe schedule.

Steady-state modes, as in JAX:

* plain: one frame per step;
* chunked (``stream_chunk`` K > 1): the encoder over K frames in one batch,
  then K head steps in order, each on the caches the previous one left
  (the JAX ``lax.scan``);
* aligned (``align_each_new_frame``): each step predicts the first frame
  (the anchor, whose level features are computed once and whose cache
  slot 0 stays pinned) again with the newest one, fits (s, t) of the
  anchor's new depth to its warm-up depth on the device
  (``compute_scale_and_shift_torch``) and emits ``new·s + t``;
* aligned chunk: the chunked mode's K head steps, then the K fits.

Depth leaves the device one step late (``utils/device.start_host_transfer``)
in ``transfer_dtype``; the aligned warm-up stays fp32, as its first frame is
the reference of every fit.  Short clips pad the warm-up window with their
last frame.  ``host_upsample`` (plain and chunked modes only: the fits
consume output-resolution maps) emits model-resolution depth and resizes
it on the host.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from video_depth_anything_torch.ops.resize import bilinear_resize, bilinear_resize_np
from video_depth_anything_torch.ops.scale_shift import compute_scale_and_shift_torch
from video_depth_anything_torch.utils.device import (
    env_switch,
    resolve_transfer_dtype,
    start_host_transfer,
    transfer_cast,
)
from video_depth_anything_torch.utils.stats import Progress
from video_depth_anything_torch.utils.transform import preprocess_frames


def map_caches(fn, caches):
    """``fn`` on every tensor of a nested tuple of KV caches."""
    if isinstance(caches, torch.Tensor):
        return fn(caches)
    return tuple(map_caches(fn, c) for c in caches)


def resize_out(depth: torch.Tensor, out_hw) -> torch.Tensor:
    """``(B, T, h, w)`` model-resolution depth → fp32 ``(B, T, *out_hw)``
    (align-corners bilinear in fp32); ``out_hw`` None or equal: fp32 as
    it is."""
    depth = depth.float()
    if out_hw is None or tuple(depth.shape[2:]) == tuple(out_hw):
        return depth
    b, t = depth.shape[:2]
    d = bilinear_resize(depth.reshape((b * t,) + depth.shape[2:] + (1,)), *out_hw)
    return d[..., 0].reshape((b, t) + tuple(out_hw))


class KVStreamingPipeline:
    """KV-cache streaming around a ``VDAModel``; ``infer(frames)`` as the
    JAX pipeline.  ``host_upsample=None`` reads ``VDA_HOST_UPSAMPLE`` and
    ``transfer_dtype=None`` ``VDA_TRANSFER_DTYPE``, as there."""

    def __init__(self, model, input_size: int = 518, inference_length: int = 32,
                 align_each_new_frame: bool = False, stream_chunk: int = 1,
                 host_upsample: Optional[bool] = None, transfer_dtype: Optional[str] = None,
                 model_parallel: int = 1):
        max_len = model.cfg.motion.temporal_max_len
        if not 1 <= inference_length <= max_len:
            raise ValueError(f"KV streaming needs 1 <= inference_length <= temporal_max_len "
                             f"({max_len}), got {inference_length}")
        self.model = model
        self.input_size = input_size
        self.L = inference_length
        self.align = bool(align_each_new_frame)
        self.host_upsample = env_switch(host_upsample, "VDA_HOST_UPSAMPLE", default=False) \
            and not self.align
        self.chunk = max(1, int(stream_chunk))
        self.transfer_dtype = resolve_transfer_dtype(transfer_dtype)
        # tensor-parallel streaming: the encoder split over a model group of
        # model_parallel ranks (parallel/mesh.py); the K/V rings stay whole
        # (to_q/k/v match no rule), inputs replicated
        self.model_parallel = int(model_parallel)
        if self.model_parallel > 1:
            from video_depth_anything_torch.parallel.mesh import create_grid, shard_module

            shard_module(model.module, create_grid(model=self.model_parallel))

    # -- device steps -------------------------------------------------------------

    def start(self, x: torch.Tensor, skip_tmp_block: bool, out_hw):
        """Warm-up window ``(1, L, H, W, 3)`` → (fp32 depth ``(L, *out_hw)``,
        caches of ``L − 1`` entries)."""
        depth, caches = self.model.module.streaming_kv_start(x, skip_tmp_block)
        if self.align:
            caches = map_caches(lambda c: torch.cat([c[:, :1], c[:, 2:]], dim=1), caches)
        else:
            caches = map_caches(lambda c: c[:, 1:], caches)
        return resize_out(depth, out_hw)[0], caches

    def step(self, x: torch.Tensor, caches, skip_tmp_block: bool, out_hw):
        """One frame ``(1, H, W, 3)`` → (fp32 depth ``(1, *out_hw)``, caches)."""
        depth, caches = self.model.module.streaming_kv_step(x, caches, skip_tmp_block)
        return resize_out(depth[:, None], out_hw)[:, 0], caches

    def aligned_step(self, x, caches, anchor_levels, ref_anchor, skip_tmp_block: bool, out_hw):
        """One aligned frame: anchor and newest predicted, (s, t) fitted on
        the device → (``(1, *out_hw)`` aligned depth, caches)."""
        depth, caches = self.model.module.streaming_kv_step(x, caches, skip_tmp_block,
                                                            anchor_levels)
        d = resize_out(depth[None], out_hw)[0]
        s, t = compute_scale_and_shift_torch(d[0], ref_anchor)
        return (d[1] * s + t)[None], caches

    def chunk_step(self, xs: torch.Tensor, caches, skip_tmp_block: bool, out_hw,
                   anchor_levels=None, ref_anchor=None):
        """K frames ``(K, H, W, 3)``: the encoder over all K, then K head
        steps in order; aligned when ``anchor_levels`` is given (the K fits
        after the loop) → (``(K, *out_hw)`` depth, caches)."""
        module = self.model.module
        levels = module.encode_level_features(xs)
        depths = []
        for j in range(xs.shape[0]):
            d, caches = module.streaming_kv_head_step(tuple(lv[j:j + 1] for lv in levels), caches,
                                                      skip_tmp_block, anchor_levels)
            depths.append(d)
        if anchor_levels is None:
            return resize_out(torch.cat(depths)[None], out_hw)[0], caches
        d = resize_out(torch.stack(depths), out_hw)  # (K, 2, fh, fw): [anchor, newest]
        fits = [compute_scale_and_shift_torch(pair[0], ref_anchor) for pair in d]
        return torch.stack([pair[1] * s + t for pair, (s, t) in zip(d, fits)]), caches

    # -- main loop ------------------------------------------------------------------

    @torch.inference_mode()
    def infer(self, frames: np.ndarray, target_fps: float = -1,
              skip_tmp_block: bool = False, progress: bool = False) -> Tuple[np.ndarray, float]:
        """uint8 RGB ``(N, H, W, 3)`` → (depth ``(N, H, W)`` fp32, fps);
        ``progress`` counts the frames past the warm-up window on stderr."""
        org_len, fh, fw = frames.shape[:3]
        L = self.L
        dev, dtype = self.model.device, self.model.dtype
        pre = preprocess_frames(frames, self.input_size)
        out_hw = None if self.host_upsample else (fh, fw)

        def to_host_res(d: np.ndarray) -> np.ndarray:
            return bilinear_resize_np(d, fh, fw) if self.host_upsample else d

        n_warm = min(L, org_len)
        warm = pre[:n_warm]
        if n_warm < L:
            warm = np.concatenate([warm, np.repeat(warm[-1:], L - n_warm, axis=0)])
        warm = torch.from_numpy(warm).to(dev, dtype)
        depth0, caches = self.start(warm[None], skip_tmp_block, (fh, fw) if self.align else out_hw)
        emitted0 = depth0 if self.align else transfer_cast(depth0, self.transfer_dtype)
        depth_list: List[np.ndarray] = list(to_host_res(start_host_transfer(emitted0).numpy()
                                                        [:n_warm]))
        anchor_levels = ref_anchor = None
        if self.align:
            # the anchor's level features are per-frame encoder outputs:
            # computed once; its warm-up depth is the reference of every fit
            anchor_levels = self.model.module.encode_level_features(warm[:1])
            ref_anchor = depth0[0]

        pending = []

        def drain(force=False):
            while pending and (force or len(pending) > 1):
                d = to_host_res(pending.pop(0).numpy())
                depth_list.extend(d)

        bar = Progress(max(0, org_len - L), "frames (kv)", enabled=progress)
        i = L
        while i < org_len:
            if self.chunk > 1 and org_len - i >= self.chunk:
                xs = torch.from_numpy(pre[i:i + self.chunk]).to(dev, dtype)
                depth, caches = self.chunk_step(xs, caches, skip_tmp_block,
                                                (fh, fw) if self.align else out_hw,
                                                anchor_levels, ref_anchor)
                n_done = self.chunk
            else:
                x = torch.from_numpy(pre[i:i + 1]).to(dev, dtype)
                if self.align:
                    depth, caches = self.aligned_step(x, caches, anchor_levels, ref_anchor,
                                                      skip_tmp_block, (fh, fw))
                else:
                    depth, caches = self.step(x, caches, skip_tmp_block, out_hw)
                n_done = 1
            # one step of lag: this copy overlaps the next step
            pending.append(start_host_transfer(transfer_cast(depth, self.transfer_dtype)))
            drain()
            i += n_done
            bar.update(n_done)
        drain(force=True)
        bar.close()
        return np.stack(depth_list, axis=0).astype(np.float32), target_fps
