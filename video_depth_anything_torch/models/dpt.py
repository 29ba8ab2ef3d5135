"""Temporal DPT head (the JAX package's ``models/dpt.py``), NHWC.

Projections, the k = s transposed-conv resize stack, the scratch RN convs
and refinenets, motion modules at the four points of the reference
(layer_3 and layer_4 before the scratch convs, after refinenet4 and
refinenet3), and the output head (output_conv1 → bilinear align_corners
to 14·ph × 14·pw → output_conv2, ``ops/output_tail.py``).  Where the JAX
gate sends that tail to its fused Pallas kernel (vitl at 518²), the tail
kernel runs it; with ``cfg.fp32_head_island`` output_conv2 runs in fp32
on the resized map and the tail kernel is refused, as in JAX.  With
``cfg.remat_motion`` each motion module runs under
``torch.utils.checkpoint`` where gradients are recorded (JAX ``nn.remat``,
``models/dpt.py:126-128`` there).  Parameter names are the reference torch keys
(``projects``, ``resize_layers``, ``scratch``, ``motion_modules``).
``attn_impl`` goes to the motion modules (the tail gate does not read it,
as in JAX).  Besides the batch-window forward, the feature-cache streaming
methods are ported (``streaming_forward``, ``streaming_head_step``,
``streaming_chunk_forward``, ``dpt.py:412-543`` there) and the KV-streaming
ones (``window_forward_collect_kv``, ``streaming_kv_forward``,
``streaming_kv_head_step``, ``dpt.py:142-155,305-395`` there).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from video_depth_anything_torch.config import ModelConfig
from video_depth_anything_torch.models.layers import Conv1x1, Conv2d, ConvTranspose2d
from video_depth_anything_torch.models.temporal import TemporalModule
from video_depth_anything_torch.ops.dispatch import kernels_enabled
from video_depth_anything_torch.ops.output_tail import (
    OutputTailFn,
    output_tail_gate,
    output_tail_plain,
)
from video_depth_anything_torch.ops.resize import bilinear_resize


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = Conv2d(features, features, 3, padding=1)
        self.conv2 = Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return self.conv2(torch.relu(self.conv1(torch.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = Conv2d(features, features, 1)

    def forward(self, x, skip: Optional[torch.Tensor] = None,
                out_hw: Optional[Tuple[int, int]] = None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        if out_hw is None:
            out_hw = (x.shape[-3] * 2, x.shape[-2] * 2)
        return self.out_conv(bilinear_resize(x, out_hw[0], out_hw[1]))


class Scratch(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        f, oc = cfg.features, cfg.out_channels
        for i in range(4):
            setattr(self, f"layer{i + 1}_rn", Conv2d(oc[i], f, 3, padding=1, bias=False))
            setattr(self, f"refinenet{i + 1}", FeatureFusionBlock(f))
        self.output_conv1 = Conv2d(f, f // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(
            Conv2d(f // 2, 32, 3, padding=1), nn.ReLU(), Conv2d(32, 1, 1), nn.ReLU(),
            nn.Identity(),
        )


class DPTHeadTemporal(nn.Module):
    def __init__(self, cfg: ModelConfig, attn_impl: str = "auto"):
        super().__init__()
        self.cfg = cfg
        oc, d = cfg.out_channels, cfg.vit.embed_dim
        self.projects = nn.ModuleList([Conv1x1(d, c) for c in oc])
        self.resize_layers = nn.ModuleList([
            ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            Conv2d(oc[3], oc[3], 3, stride=2, padding=1),
        ])
        self.scratch = Scratch(cfg)
        self.motion_modules = nn.ModuleList([
            TemporalModule(cfg.motion, c, attn_impl)
            for c in (oc[2], oc[3], cfg.features, cfg.features)
        ])

    def level_features(self, features: Sequence[torch.Tensor], ph: int, pw: int):
        """Per-frame projection + resize stack: 4 maps at 4×/2×/1×/0.5×."""
        n = features[0].shape[0]
        return tuple(
            self.resize_layers[i](self.projects[i](f.reshape(n, ph, pw, f.shape[-1])))
            for i, f in enumerate(features)
        )

    def _temporal(self, module, x: torch.Tensor, batch: int) -> torch.Tensor:
        x5 = x.reshape((batch, x.shape[0] // batch) + x.shape[1:])
        if self.cfg.remat_motion and torch.is_grad_enabled():
            y = checkpoint(module, x5, use_reentrant=False)
        else:
            y = module(x5)
        return y.reshape(x.shape)

    @staticmethod
    def _temporal_collect(module, x: torch.Tensor, batch: int):
        """``_temporal`` through ``module.collect``: also the module's
        position-free KV caches."""
        y, caches = module.collect(x.reshape((batch, x.shape[0] // batch) + x.shape[1:]))
        return y.reshape(x.shape), caches

    @staticmethod
    def _temporal_kv(module, x_new: torch.Tensor, caches, pin_anchor: bool):
        """``(Q, h, w, C)`` query-frame maps through ``module.kv_step``."""
        y, caches = module.kv_step(x_new[None], caches, pin_anchor)
        return y[0], caches

    def _output_head(self, path1: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
        sc = self.scratch
        out = sc.output_conv1(path1)
        oh, ow = ph * 14, pw * 14
        conv3, conv1 = sc.output_conv2[0], sc.output_conv2[2]
        args = (out, conv3.weight, conv3.bias, conv1.weight, conv1.bias, oh, ow)
        if kernels_enabled() and output_tail_gate(self.cfg, out.shape, out.dtype, oh, ow):
            return OutputTailFn.apply(*args)
        return output_tail_plain(*args, fp32_island=self.cfg.fp32_head_island)

    def forward(self, features, batch: int, ph: int, pw: int,
                skip_tmp_block: bool = False) -> torch.Tensor:
        sc, mm = self.scratch, self.motion_modules
        l1, l2, l3, l4 = self.level_features(features, ph, pw)
        l3 = self._temporal(mm[0], l3, batch)
        l4 = self._temporal(mm[1], l4, batch)
        r1, r2 = sc.layer1_rn(l1), sc.layer2_rn(l2)
        r3, r4 = sc.layer3_rn(l3), sc.layer4_rn(l4)
        path4 = sc.refinenet4(r4, out_hw=tuple(r3.shape[-3:-1]))
        if not skip_tmp_block:
            path4 = self._temporal(mm[2], path4, batch)
        path3 = sc.refinenet3(path4, r3, out_hw=tuple(r2.shape[-3:-1]))
        path3 = self._temporal(mm[3], path3, batch)
        path2 = sc.refinenet2(path3, r2, out_hw=tuple(r1.shape[-3:-1]))
        path1 = sc.refinenet1(path2, r1)
        return self._output_head(path1, ph, pw)

    # -- feature-cache streaming ----------------------------------------------

    def streaming_forward(self, new_features, cached, ph: int, pw: int, pred_idx=None,
                          skip_tmp_block: bool = False):
        """One streaming step: the current frame's encoder taps (each
        ``(1, N, D)``) and the gathered pre-motion level windows (each
        ``(T-1, h_l, w_l, C_l)``) → (depth ``(P, 14ph, 14pw, 1)``, the
        frame's 4 level features).  ``pred_idx``: window positions whose
        depth is predicted besides the current frame; ``None`` predicts the
        current frame only."""
        levels = self.level_features(new_features, ph, pw)
        return self.streaming_head_step(levels, cached, ph, pw, pred_idx, skip_tmp_block)

    def streaming_head_step(self, levels, cached, ph: int, pw: int, pred_idx=None,
                            skip_tmp_block: bool = False):
        """The post-encoder half of ``streaming_forward``.  Cached levels 1
        and 2 are read only at ``pred_idx`` and may be ``None`` without
        it."""
        sc, mm = self.scratch, self.motion_modules
        n1, n2, n3, n4 = levels
        c1, c2, c3, c4 = cached
        t = c3.shape[0] + 1
        if pred_idx is not None:
            idx = torch.as_tensor(pred_idx, dtype=torch.long, device=n1.device)
            l1p, l2p = torch.cat([c1[idx], n1]), torch.cat([c2[idx], n2])
        else:
            l1p, l2p = n1, n2
        r1, r2 = sc.layer1_rn(l1p), sc.layer2_rn(l2p)
        r4 = sc.layer4_rn(self._temporal(mm[1], torch.cat([c4, n4]), 1))
        r3 = sc.layer3_rn(self._temporal(mm[0], torch.cat([c3, n3]), 1))
        path4 = sc.refinenet4(r4, out_hw=tuple(r3.shape[-3:-1]))
        if not skip_tmp_block:
            path4 = self._temporal(mm[2], path4, 1)
        path3 = sc.refinenet3(path4, r3, out_hw=tuple(r2.shape[-3:-1]))
        path3 = self._temporal(mm[3], path3, 1)
        # keep the frames whose depth is asked for, the current one last
        if pred_idx is not None:
            path3 = path3[torch.cat([idx, idx.new_tensor([t - 1])])]
        else:
            path3 = path3[-1:]
        path2 = sc.refinenet2(path3, r2, out_hw=tuple(r1.shape[-3:-1]))
        path1 = sc.refinenet1(path2, r1)
        return self._output_head(path1, ph, pw), (n1, n2, n3, n4)

    def streaming_chunk_forward(self, n1, n2, w3, w4, ph: int, pw: int,
                                skip_tmp_block: bool = False) -> torch.Tensor:
        """K steady streaming steps as one batch: ``n1, n2`` the newest
        frame's level-1/2 maps per chunk position ``(K, h, w, C)``, ``w3,
        w4`` each position's whole window ``(K, T, h, w, C)``.  The same
        math as K ``streaming_forward`` calls without ``pred_idx``; returns
        depth ``(K, 14ph, 14pw, 1)``."""
        sc, mm = self.scratch, self.motion_modules
        k, t = w3.shape[:2]
        flat = lambda x: x.reshape((k * t,) + x.shape[2:])  # noqa: E731
        unflat = lambda x: x.reshape((k, t) + x.shape[1:])  # noqa: E731
        r1, r2 = sc.layer1_rn(n1), sc.layer2_rn(n2)
        r4 = sc.layer4_rn(flat(mm[1](w4)))
        r3 = sc.layer3_rn(flat(mm[0](w3)))
        path4 = sc.refinenet4(r4, out_hw=tuple(r3.shape[-3:-1]))
        if not skip_tmp_block:
            path4 = flat(mm[2](unflat(path4)))
        path3 = sc.refinenet3(path4, r3, out_hw=tuple(r2.shape[-3:-1]))
        path3 = mm[3](unflat(path3))[:, -1]  # the newest frame per chunk position
        path2 = sc.refinenet2(path3, r2, out_hw=tuple(r1.shape[-3:-1]))
        path1 = sc.refinenet1(path2, r1)
        return self._output_head(path1, ph, pw)

    # -- KV-cache streaming ---------------------------------------------------------

    def window_forward_collect_kv(self, features, batch: int, ph: int, pw: int,
                                  skip_tmp_block: bool = False):
        """The window forward that also captures every motion module's KV
        caches (the KV mode's warm-up): ``(depth, (kv0, kv1, kv2, kv3))``,
        ``kv2 = ()`` with ``skip_tmp_block``."""
        sc, mm = self.scratch, self.motion_modules
        l1, l2, l3, l4 = self.level_features(features, ph, pw)
        l3, kv0 = self._temporal_collect(mm[0], l3, batch)
        l4, kv1 = self._temporal_collect(mm[1], l4, batch)
        r1, r2 = sc.layer1_rn(l1), sc.layer2_rn(l2)
        r3, r4 = sc.layer3_rn(l3), sc.layer4_rn(l4)
        path4 = sc.refinenet4(r4, out_hw=tuple(r3.shape[-3:-1]))
        kv2 = ()
        if not skip_tmp_block:
            path4, kv2 = self._temporal_collect(mm[2], path4, batch)
        path3 = sc.refinenet3(path4, r3, out_hw=tuple(r2.shape[-3:-1]))
        path3, kv3 = self._temporal_collect(mm[3], path3, batch)
        path2 = sc.refinenet2(path3, r2, out_hw=tuple(r1.shape[-3:-1]))
        path1 = sc.refinenet1(path2, r1)
        return self._output_head(path1, ph, pw), (kv0, kv1, kv2, kv3)

    def streaming_kv_forward(self, new_features, kv_caches, ph: int, pw: int,
                             skip_tmp_block: bool = False, anchor_levels=None):
        """One KV step from the newest frame's encoder taps: ``(depth (Q,
        14ph, 14pw, 1), caches)``.  With ``anchor_levels`` (the first
        frame's 4 level maps) the anchor is predicted again before the
        newest frame, at window slot 0, and its cache slot stays pinned."""
        levels = self.level_features(new_features, ph, pw)
        return self.streaming_kv_head_step(levels, kv_caches, ph, pw, skip_tmp_block,
                                           anchor_levels)

    def streaming_kv_head_step(self, levels, kv_caches, ph: int, pw: int,
                               skip_tmp_block: bool = False, anchor_levels=None):
        """The post-encoder half of ``streaming_kv_forward``, from the
        frame's level features (each ``(1, h_l, w_l, C_l)``)."""
        sc, mm = self.scratch, self.motion_modules
        kv0, kv1, kv2, kv3 = kv_caches
        pin = anchor_levels is not None
        if pin:
            levels = tuple(torch.cat([a, n]) for a, n in zip(anchor_levels, levels))
        n1, n2, n3, n4 = levels
        l3, kv0 = self._temporal_kv(mm[0], n3, kv0, pin)
        l4, kv1 = self._temporal_kv(mm[1], n4, kv1, pin)
        r1, r2 = sc.layer1_rn(n1), sc.layer2_rn(n2)
        r3, r4 = sc.layer3_rn(l3), sc.layer4_rn(l4)
        path4 = sc.refinenet4(r4, out_hw=tuple(r3.shape[-3:-1]))
        if not skip_tmp_block:
            path4, kv2 = self._temporal_kv(mm[2], path4, kv2, pin)
        path3 = sc.refinenet3(path4, r3, out_hw=tuple(r2.shape[-3:-1]))
        path3, kv3 = self._temporal_kv(mm[3], path3, kv3, pin)
        path2 = sc.refinenet2(path3, r2, out_hw=tuple(r1.shape[-3:-1]))
        path1 = sc.refinenet1(path2, r1)
        return self._output_head(path1, ph, pw), (kv0, kv1, kv2, kv3)
