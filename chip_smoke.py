#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py            # one card

Phases (each failure ends the run with a non-zero exit):
1. card: print the card's name and power limit, build the CUDA kernels
   from ``video_depth_anything_torch/csrc``.
2. kernels: hold each kernel against its plain PyTorch version on the card
   in bf16 at the main path's vits, vitb and vitl shapes (one window; for
   Kernel A's backward, the training shapes, also from the fast forward's
   log-sum-exp; Kernel A's fast variant also at the streaming shapes, one
   frame and a chunk of 8; Kernel A at D = 192 (exact and fast, and
   ragged at N = 2443) and at 3 heads on synthetic shapes; Kernel B at
   every head width of its domain, d = 8 to 128, and at T = 17 on a
   ragged S; Kernels A, B and C also at phase eval's native sizes,
   EVAL_ATTN, EVAL_TEMPORAL and EVAL_MOTION; Kernel C's wide chain at
   C = 768 and 1024, WIDE_MOTION_ROWS, each row with the chain's time by
   launch and torch.matmul's time beside each product, and the persistent
   GEMM's wrong plans of wide_chain_mutant_errors), on inputs whose attention is
   peaked, and
   Kernel A also on flat ones (q scaled by FLAT_Q); Kernel A's probe
   kernels (every spatial
   variant at the vitl and vits probe shapes, the seven softmax-chain
   modes, also at an odd count of query blocks and of key tiles) on their
   scripts' inputs; the fused resize -> conv at the vitl junction (its
   kernel's launch alone timed beside the wrapper's call) and at the
   kernel tests' shapes (a downsampling, a near-identity size, a large
   upsampling, more tiles than SMs); and show that wrong kernels (uniform attention, a dropped
   last key tile -- 128 keys for Kernel A at D = 64 --, for Kernel A on
   the flat inputs the zero-filled pad keys of the ragged last tile
   counted in the softmax, for the spatial probes the pair's two heads
   exchanged and V rolled by one 64-key tile, for the no-mask probes a
   missing pad correction, for sbf16 the key mask dropped and, exact, a
   running max in place of the global one; for Kernel B also the last
   location tile never stored, at the window batch of 4 every batch given
   batch 0's output, and, at
   T = 17, the zero key rows of its 32-frame tile unmasked; for Kernel
   C, uniform frame attention, no APE rows, k
   projected with q's weights and the last quarter of the feed-forward
   dropped; for the backward, Delta = 0 and a dropped last 64-query tile;
   for the output tail and the resize -> conv, align_corners False taps and
   a conv3x3 without its off-centre taps, for the tail also every tap's dx
   off by one) would fail the same tolerance; time kernel, plain version,
   and the library call where one exists, with ms / library ms, the
   backward's three launches apart, Kernel C's and the tail's stages apart
   (``split_ms``), and the PR 1-6 designs' ms beside Kernel C's and the
   tail's, the one-frame-per-lane design's beside Kernel B's, the
   mma.sync design's beside the spatial probes' and Kernel A's at D = 192
   (``parent_ms``), and beside the probes' tensor-core bound the bound of
   their softmax chain (``chain_bound_ms``); Kernel
   B's times are device times over inputs rotated past the L2 (its launch
   path outlasts it on the host).
3. window: one full-width, full-depth vits, vitb and vitl window (noised
   seeded weights) at 518x518 and 518x924, kernel path against the plain
   path on the card, with each window's launch plan (vitb's with exact
   counts: Kernel B at d = 16, Kernel C at C = 128 and 384); frames/s of
   ``infer_window`` at the pipeline's window batch (4 windows per call
   for vits and vitb, 1 for vitl) and the plain reference's peak device
   memory; the vits 518x924 window again under ``--attn_impl auto:fast``
   (Kernel A's fast variant only), and the vits and vitl 518x518 windows
   under ``--attn_impl pallas`` (Kernel B also at d = 48, and at d = 32
   and 128 on vitl, with exact launch counts by width), timed beside
   ``auto``.
   Under ``VDA_FUSED_MOTION=1`` (phase ``fused_switch``, run after it):
   vitb and vitl windows at 518x518 and 518x924 against the plain path
   with the exact launch plans of SWITCH_PLANS (Kernel C's wide chain at C
   = 768 once a vitb window, at 1024 twice a vitl window), each timed with
   and without the switch; a vitl --fp32 518x518 window; and
   ``python -m video_depth_anything_torch.run --encoder vitl`` as a
   subprocess.
   Phase ``domain`` (after ``fused_switch``) runs the configurations that
   reach the rest of the JAX gates' domains: (a) vits and vitb 4x32x518x518
   windows with ``packed_output_stack=False`` (the tail kernel at C = 32
   and 64), timed against the shipped config in turns; (b) vits 518x518
   windows with 4 heads and one attention block under ``auto`` (Kernel B
   at d = 16, Kernel C's wide chain at 4 heads), ``pallas`` (Kernel B also
   at d = 48 and, on the run-time-d kernel, 96), ``VDA_FUSED_MOTION=1``
   (the wide chain on all four modules) and fp32 ``pallas``; each against
   the plain path with the exact launches of DOMAIN_WINDOWS (Kernel B's by
   head width, the tail's by C); then (c): Kernel B at every width the
   gate admits at 4, 8 and 16 heads (in fp32 also one head of 320 and of
   512, two of 256 and C = 6 at one head on 19² locations: the fp32
   run-time-d kernel's several boxes a row and its cp.async loader,
   DOMAIN_F32_EXTRA), Kernel C at every width it admits at
   8 heads, two blocks and ff_mult 4 (forced) and at 4 and 16 heads, 1
   and 3 blocks and ff_mult 2 at C = 64, 96, 320 and 512, each in bf16
   and fp32 against its plain version with its mutants (Kernel B: d
   rounded up to the next instantiated width, the last box of a row of
   several never loaded; Kernel C: 8 heads whatever
   the config says, the last attention block dropped; the tail: the map
   read at half its channels), and the kernels whose domains did not change
   re-timed beside PERF.md's times (PERF_MS).  Kernel B's bound there is the
   largest of its FLOPs, its bytes and its softmax's exponentials on the
   SFU (``temporal_bound``).
4. cli: ``python -m video_depth_anything_torch.run --random_init`` (called
   in-process through ``run.main``) on synthetic 480x480 and 854x480 mp4s
   of 76 frames with vits, and on the 480x480 one with vitl and vitb, and
   with vitl under ``--attn_impl pallas``; the depth must be finite and of
   the clip's shape and every kernel's launch count must move.  This is
   the main path: the counts are zeroed just before and read just after.
5. stream: feature-cache streaming (``--process_single_image``).  The
   pipeline's kernel path against its plain path on a 76-frame 854x480
   clip (31 warm-up frames, 21 transition steps, 3 steady chunks of 8),
   plain mode under auto:fast and aligned mode; the CLI in streaming mode
   on 76-frame clips, vits 854x480 under auto:fast, vits and vitl on
   480x480, vits on 480x480 under pallas, with their launch plans (the
   main path of streaming: counts zeroed before each run, read after).  KV-cache streaming
   (``--kv_cache``): ``KVStreamingPipeline``'s kernel path against its
   plain path on 76-frame clips (vits 854x480, vitb 480x480, whose warm-up
   runs Kernel B at d = 16; plain and aligned mode, chunk 8) and the CLI
   with ``--kv_cache`` (vits 854x480, vitb 480x480) with launch plans
   (main path).  Steady-state frames/s at chunks 8 and 1 of both modes
   (``profile_streaming``).
6. train: one ``Trainer.step`` (encoder trained, bf16) on the kernel path
   against one on the plain path, same noised weights and batch: vits at
   518x518 with 16 frames (Kernels A forward and backward, B and C) and
   vitl at 266x266 with 8 (A at 16 heads, the tail kernel); the loss, the
   gradient of every parameter group, no parameter without a gradient, and
   the launch counts.  Then a frozen-encoder step, which must leave the
   encoder bit-identical.
7. train-cli: ``python -m video_depth_anything_torch.train`` (in-process)
   on a synthetic PointOdyssey tree, vits at 518x518 with 32-frame clips,
   6 steps and a resume for 2 more; the losses must be finite, the steps
   continue, and Kernels A (forward and backward), B and C must all run.
   The main path of training: counts zeroed before, read after.
8. eval: ``python -m video_depth_anything_torch.eval`` (``main``,
   in-process, ``--random_init``) on synthetic KITTI (two scenes of 40
   frames at 375x1242, sparse GT; the model runs at 280x924) and Sintel
   (one scene of 40 frames at 436x1024 with cameras; 392x924) trees: vits
   windows on KITTI, the feature cache and the KV cache on Sintel, a vitl
   window and a vits --fp32 window on one KITTI scene, each with its launch
   plan (the main path: counts zeroed before, read after), finite metrics
   in its CSV, frames/s and peak device memory; the first scene's raw
   predictions of every run (noised weights) against the plain path, within
   WINDOW_TOL (``rounding_tol``) in bf16 and F32_WINDOW_TOL (TF32 off) for
   --fp32; then ``video_depth_anything_torch.compare``'s two ``--run``
   subprocesses (one checkpoint of noised weights, with and without
   --skip_tmp_block) on a 40-frame 375x1242 mp4, their alignment and
   ``comparison.json`` (``run_methods``, ``score_methods``: the card has no
   matplotlib for the renderings).
9. probes: ``python -m video_depth_anything_torch.bench_spatial_variants``
   and ``bench_softmax_chain`` (their ``main``, in-process) at full shapes
   with their default lists, and ``ResizeConvFn`` forward and backward at
   the vitl junction against autograd through the plain chain: the path of
   the probe kernels and of the resize -> conv kernel (counts zeroed
   before, read after).
10. fp32 (``--fp32``, TF32 off in matrix products and convolutions): each
   fp32 kernel (Kernel A at vits 32x1370 and 32x2443, exact and fast, and
   D = 192; Kernel B at every shape of ``bench_temporal``; Kernel C at
   phase kernels' nine shapes and the wide chain's six; each also at phase eval's --fp32 KITTI
   shapes, 280x924) against its plain fp32 version within
   F32_TOL, the mutants of phase kernels at fp32 and the plain version in
   one TF32 pass missing by more, with ms, bound, plain and library ms and
   the bf16 kernel's error on the same inputs; fp32 vits, vitb and vitl
   518x518 windows, kernel path against plain path within F32_WINDOW_TOL,
   with exact fp32 launch plans, wall ms and frames/s; the CLI with
   ``--fp32`` (window mode, ``--process_single_image`` and ``--kv_cache``:
   the main path of the fp32 kernels, each must launch, but Kernel C in the
   KV mode, and no bf16 kernel may) and vitl with ``--fp32_island`` (the
   tail kernel never launches).
11. bench: ``python -m video_depth_anything_torch.bench`` with
   VDA_BENCH_FAST=1 (the card line, then the headline line), then each of
   its row functions once at iters=2, their fields checked.
12. parallel: the multi-GPU layer (``video_depth_anything_torch/parallel``),
   ranks started as subprocesses (``torch.distributed.run`` or the
   multi-host flags), each printing its rank, device, backend, peak
   memory and launch counts: ``run --data_parallel`` vits at world size 1
   over NCCL (bit for bit the single-process depth); over gloo, two ranks
   sharing the card: ``run --data_parallel`` and the multi-host CLI
   (``--coordinator 127.0.0.1:<port> --num_hosts 2 --host_id i``; each
   rank decodes its span only), ``run --pipeline_parallel 2
   --pp_microbatches 8`` (bit for bit) and ``run --model_parallel 2`` on a
   vitl 518x518 window of noised weights (Kernels A and C and the tail on
   both ranks), ``--process_single_image`` with and without ``--kv_cache``
   at ``--model_parallel 2``, each against the single-process run; then
   ``train`` and ``train --zero1`` at world size 2 against ``train`` in one
   process on the same global batch, parameter by parameter (with two
   ZeRO-1 mutants that must miss).  Its times are two ranks sharing one
   card.  Every run of this phase decodes with cv2 (``VDA_NATIVE_DECODE=0``),
   as the data-parallel ranks' ranged decode does.
13. vitg: Kernel A at 24 heads of 64 (1370 and 2443 tokens) and Kernel C
   at C = 384 over 5476 and 9768 locations, bf16 and fp32, against their
   plain versions with phase kernels' mutants; a seeded vitg, every
   parameter noised, through ``VideoDepthPipeline`` on 32-frame 480x480 and
   854x480 clips (518x518 and 518x924) under ``--attn_impl auto`` and
   ``pallas`` against the plain path (WINDOW_TOL, ``rounding_tol``) with
   exact launch plans (VITG_PLANS, from the gates that
   tests/test_torch_dispatch.py holds to JAX's), and an fp32 518x518 window
   (F32_WINDOW_TOL, TF32 off); ms of a window on either path (the main path
   of vitg: counts zeroed before each pipeline run, read after).
14. tooling: the native host libraries built from ``native/*.cpp`` on the
   card's host (preprocessing within 2e-3 of cv2, the gather bit for bit,
   the decoder's pixels cv2's on a 848-wide clip in JAX's four cases, the
   854-wide one refused and decoded by cv2, a 76-frame 854x480 window CLI
   with the native switches off and on in turns, frames/s and host paths);
   ``python -m video_depth_anything_torch.app`` twice (seeded init: uploads
   for vits, vitb and vitl; a .pth of noised vits weights: one), each
   request's depth video against ``run``'s on the same clip and weights,
   its launches (Kernels A and C) from the server's line; ``profile_model``
   for vits at 518x518x32 and vitl at 518x518x8, and ``examples.quickstart``
   (``param_counts`` against the port's module); ``examples.feature_pca``'s
   level features on the card against the CPU's; ``tools.stress`` for 2 s.
The card's line (``nvidia-smi``'s name and power limit) comes first and
stands beside every time.  The last two lines are the kernels JSON object
(launches summed over the main-path runs of phases cli, stream, train-cli,
eval, fused_switch, domain, the ranks of phase parallel, phase vitg's pipeline runs and the
demo server's requests, for the probe kernels and the resize -> conv those of phase
probes, for the fp32 kernels those of phase fp32's ``--fp32`` runs and
phases eval's and vitg's; Kernel
A's fast variant, each fp32 kernel and Kernel B's run-time-d kernel, whose
launches come from phase domain, are entries of their own) and the
contract line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s (data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s


def log(*a):
    print(*a, flush=True)


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def chain_bound(mix: dict, scores: float) -> float:
    """ms for ``scores`` exponentials of an instruction mix (per score, by
    pipe) on every SM of card 0 at its largest SM clock."""
    import torch

    from video_depth_anything_torch.bench_probe_split import chain_bound_ms, max_sm_clock_hz

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return chain_bound_ms(mix, scores, sms, max_sm_clock_hz())


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# -- phase 2: each kernel against its plain version ---------------------------

# The PR 1-6 designs of Kernel C and the tail at phase kernels' shapes (ms,
# NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6 rows 7-8: chip_smoke.py in
# PR 4's run 3 and PR 6's run 4), printed beside the current kernels' ms.
PARENT_MS = {
    ("motion_module", "m3 518x518"): 0.6341, ("motion_module", "m0 518x924"): 1.3235,
    ("motion_module", "m2 518x924"): 0.3010, ("motion_module", "m3 518x924"): 1.0770,
    ("motion_module", "vitl m3 518x518"): 3.6506, ("motion_module", "vitl m2 518x924"): 1.7554,
    ("motion_module", "vitl m3 518x924"): 6.4841, ("motion_module", "vitb m3 518x518"): 1.5558,
    ("motion_module", "vitb m0 518x924"): 3.7050,
    ("output_tail", "vitl 518x518"): 3.2812, ("output_tail", "vitl 518x924"): 5.6299,
    # Kernel B's earlier one-frame-per-lane design (PERF.md section 6, step 0:
    # bench_temporal --root on its checkout, device ms over rotated inputs, as
    # phase kernels times the current kernel); it took d = 8, 16 and 24 only
    ("temporal_attention", "vits m0 518x518"): 0.1062,
    ("temporal_attention", "vits m2 518x518"): 0.0405,
    ("temporal_attention", "vitb m2 518x518"): 0.0706,
    ("temporal_attention", "ragged T=17 C=64"): 0.0065,
    # Kernel A at D = 192 and the sbf16 probes, their earlier mma.sync
    # kernels (PERF.md section 6: bench_probe_split on the checkout before
    # the Hopper ones, in turns with them)
    ("flash_attention", "synthetic D=192"): 0.5462,
    ("flash_attention_fast", "synthetic D=192"): 0.5180,
    ("sbf16_attention", "vitl sbf16"): 2.4708, ("sbf16_attention", "vitl sbf16:fast"): 1.6700,
    ("sbf16_attention", "vitl ceiling"): 1.0965, ("sbf16_attention", "vits sbf16"): 0.9425,
    ("sbf16_attention", "vits sbf16:fast"): 0.6371, ("sbf16_attention", "vits ceiling"): 0.4090,
    # the ilv and chunk probes' earlier mma.sync design (PERF.md section 6:
    # bench_probe_split on its checkout, in turns with the Hopper kernels)
    ("ilv_attention", "vitl ilv"): 2.7439, ("ilv_attention", "vitl nomask"): 1.8813,
    ("chunk_attention", "vitl chunk2"): 2.5141, ("chunk_attention", "vitl chunk4"): 2.6099,
    ("ilv_attention", "vits ilv"): 1.0141, ("ilv_attention", "vits nomask"): 0.7485,
    ("chunk_attention", "vits chunk2"): 0.9755, ("chunk_attention", "vits chunk4"): 1.1348,
    # the chain probe's and resize -> conv's mma.sync kernels (PERF.md section
    # 6: bench_probe_split and bench_resize_conv on the checkout before the
    # Hopper ones, in turns with them; resize -> conv the launch alone)
    ("softmax_chain", "gemms"): 1.0528, ("softmax_chain", "exp"): 1.2252,
    ("softmax_chain", "exact"): 1.1665, ("softmax_chain", "sexp"): 1.0527,
    ("softmax_chain", "pexp"): 1.4534, ("softmax_chain", "bf16s"): 1.2511,
    ("softmax_chain", "bf16x"): 2.0853,
    ("resize_conv", "vitl junction"): 5.9131,
}

# The Hopper probe kernels' softmax chain, instructions per score by pipe
# (PERF.md section 6: bench_probe_split's reading of their SASS; exact
# sbf16's includes its max pass); chain_bound_ms is this times the run's
# scores over the pipes' rates on every SM (bench_probe_split.chain_bound_ms).
PROBE_CHAIN = {
    "ilv": {"conversion": 0.5, "fp32": 10.594, "integer": 1.961, "total": 14.859},
    "nomask": {"conversion": 0.5, "fp32": 10.188, "integer": 1.125, "total": 13.375},
    "chunk": {"conversion": 0.5, "fp32": 10.156, "integer": 1.25, "total": 14.12},
    "sbf16": {"conversion": 1.5, "fp32": 12.594, "integer": 4.094, "total": 19.867},
    "sbf16:fast": {"conversion": 1.0, "fp32": 10.594, "integer": 2.945, "total": 16.359},
}
# The chain probe's chain by mode (PERF.md section 6: bench_probe_split's
# reading of chain_hopper's SASS, with what its chain-free build keeps),
# over its 512 x 1408^2 scores; "mufu" runs at 16 a clock.
CHAIN_MIX = {
    "exp": {"conversion": 0.5, "fp32": 3.714, "mufu": 1.0, "total": 5.214},
    "exact": {"conversion": 0.5, "fp32": 7.0, "mufu": 1.0, "integer": -0.371, "total": 8.509},
    "sexp": {"conversion": 1.5, "fp32": 1.0, "total": 2.496},
    "pexp": {"conversion": 2.5, "fp32": 5.0, "integer": 0.871, "total": 8.522},
    "bf16s": {"conversion": 1.0, "fp32": 3.0, "integer": 1.0, "mufu": 1.0, "total": 6.0},
    "bf16x": {"conversion": 1.5, "fp32": 5.0, "integer": 2.0, "mufu": 1.0, "total": 9.5},
}


def motion_params(c: int, seed: int, device):
    """Raw motion-module parameters (JAX layout) with seeded noise."""
    import torch

    g = torch.Generator().manual_seed(seed)
    n = lambda *s, std=1.0: torch.randn(*s, generator=g) * std  # noqa: E731
    p = dict(
        gn_scale=1 + n(c, std=0.1), gn_bias=n(c, std=0.1),
        w_in=n(c, c, std=c**-0.5), b_in=n(c, std=0.1),
        ln_scale=1 + n(3, c, std=0.1), ln_bias=n(3, c, std=0.1),
        wq=n(2, c, c, std=c**-0.5), wk=n(2, c, c, std=c**-0.5), wv=n(2, c, c, std=c**-0.5),
        wo=n(2, c, c, std=c**-0.5), bo=n(2, c, std=0.1),
        w1=n(c, 8 * c, std=c**-0.5), b1=n(8 * c, std=0.1),
        w2=n(4 * c, c, std=(4 * c) ** -0.5), b2=n(c, std=0.1),
        w_out=n(c, c, std=c**-0.5), b_out=n(c, std=0.1),
    )
    return {k: v.to(device) for k, v in p.items()}


QK_STD = 1.6  # q, k ~ N(0, 1.6^2), v ~ N(0, 1): scores q.k.d^-0.5 spread
# with a std of ~2.6, as a trained ViT's do, so each softmax row is peaked
# and the running max moves between key tiles.
ATTN_TOL = 1e-2  # Kernels A and B, relative to max|plain|: probabilities and
# outputs are rounded to bf16 at different points (~2.5 bf16 ulps of the
# largest output).  mutant_errors shows that wrong kernels miss by far more.
# Kernel C's rows in phases kernels and fp32: (label, C, S, T)
MOTION_ROWS = tuple((label, c, s, 32) for label, c, s in (
    ("m3 518x518", 64, 5476), ("m0 518x924", 192, 2442), ("m2 518x924", 64, 2442),
    ("m3 518x924", 64, 9768), ("vitl m3 518x518", 256, 5476), ("vitl m2 518x924", 256, 2442),
    ("vitl m3 518x924", 256, 9768), ("vitb m3 518x518", 128, 5476),
    ("vitb m0 518x924", 384, 2442))) + tuple(
    (label, c, 5476, t) for label, c in (("m3 518x518", 64), ("vitl m3 518x518", 256))
    for t in (12, 16, 20, 24))
# The kernels' shapes at phase eval's native sizes (KITTI 375x1242 -> 280x924,
# 1320 tokens; Sintel 436x1024 -> 392x924, 1848): Kernel A's vits token
# counts (N = 1321 is ragged), Kernel B's vits m0 (d = 24) and m2 (d = 8)
# calls, Kernel C's vits m3 (and vitl m3 at 280x924).  The KITTI rows come
# first: phase fp32 takes them for the --fp32 run.
EVAL_ATTN = (("KITTI 280x924", 1321), ("Sintel 392x924", 1849))
EVAL_TEMPORAL = tuple((f"vits {m} {size}", 1, 32, s, c)
                      for size, s in (("280x924", 1320), ("392x924", 1848))
                      for m, c in (("m0", 192), ("m2", 64)))
EVAL_MOTION = (("m3 280x924", 64, 5280, 32), ("m3 392x924", 64, 7392, 32),
               ("vitl m3 280x924", 256, 5280, 32))
# Kernel C at the widths VDA_FUSED_MOTION=1 sends to the wide chain
# (csrc/motion_module_wide.cu): vitb m1 (C = 768) and vitl m0 and m1 (1024)
# of one 32-frame window at 518x518 (19x19 and 37x37 locations) and 518x924
# (19x33, 37x66).  Phase kernels holds them in bf16, phase fp32 in fp32.
WIDE_MOTION_ROWS = (("vitb m1 518x518", 768, 361, 32), ("vitb m1 518x924", 768, 627, 32),
                    ("vitl m0 518x518", 1024, 1369, 32), ("vitl m0 518x924", 1024, 2442, 32),
                    ("vitl m1 518x518", 1024, 361, 32), ("vitl m1 518x924", 1024, 627, 32))
MOTION_TOL = 5e-2  # Kernel C, relative to max|plain - x| (the module's own
# contribution): the plain version rounds each GEMM output and each bias add
# to bf16 separately, the kernel once per fused epilogue, through ~10
# chained products.
BWD_TOL = 2e-2  # Kernel A's backward, relative to max|plain| of each of dq,
# dk and dv: the kernel recomputes P from Kernel A's log-sum-exp and takes
# Delta from the bf16 output, and its fp32 sums over 64-wide tiles run in
# another order than the dense plain version's; ds, p and the gradients
# are rounded to bf16 at the same points in both.  bwd_mutant_errors shows
# that wrong kernels miss by far more.
TAIL_TOL = 2.5 * 2.0**-8  # the output tail, relative to max|plain|: the JAX
# package's bound for its fused tail against the XLA chain
# (tests/test_output_stack.py:56).  Kernel and plain chain round at the same
# points; they differ in fp32 summation order.
RESIZE_CONV_TOL = 2.5 * 2.0**-8  # the fused resize -> conv, relative to
# max|plain|: the JAX package's bound for its kernel against the XLA chain
# (tests/test_resize_conv.py:49); the same rounding points, other fp32 sums.
RESIZE_CONV_GRAD_TOL = 5e-2  # ResizeConvFn's gradients against autograd
# through the plain chain, relative to each gradient's max: both run the
# same plain backward, whose bilinear-resize backward adds bf16 gradients
# with atomics in an order that changes from run to run; phase probes logs
# how far two plain runs differ.
CHAIN_TOL = 1e-2  # the softmax-chain probe, relative to max|plain| of its
# unnormalised output: P is rounded to bf16 at the same point in both, the
# exponentials differ in their last fp32 bits (and exact's online max in
# its rescale order), which can move a bf16 rounding of P.


def attention_inputs(shape, gen, device):
    """bf16 ``(..., 3 * C)`` for ``shape = (..., C)``, with the q and k parts
    scaled by QK_STD; the caller splits q, k and v off the last axis."""
    import torch

    x = torch.randn(*shape[:-1], 3 * shape[-1], generator=gen, device=device)
    x[..., : 2 * shape[-1]] *= QK_STD
    return x.to(torch.bfloat16)


def rel_err(got, want) -> float:
    return max_err(got, want) / float(want.float().abs().max())


FLAT_Q = 0.2  # Kernel A's second check scales q down: q.k.d^-0.5 then has a
# std of ~0.5, every softmax row is near-uniform, and the zero-filled pad
# keys of a ragged last tile would take a share of each row's sum (22 of
# 384 keys at N = 362, 38 of 1408 at 1370, 117 of 2560 at 2443) that the
# peaked inputs' large row sums hide.


def flat_inputs(q):
    """``q`` scaled by FLAT_Q, in its dtype."""
    return (q.float() * FLAT_Q).to(q.dtype)


def zero_pad_error(plain, q, k, v, scale, tile: int) -> float:
    """How far a kernel that counts the zero-filled pad keys of its ragged
    last ``tile``-key tile in the softmax (TMA fills them; a zero key
    scores 0, not -inf) misses the plain version, relative to max|plain|:
    the plain version over k and v padded with zero rows to a multiple of
    ``tile`` keys, on ``(B, N, H, D)`` inputs."""
    import torch.nn.functional as F

    pad = -(-k.shape[1] // tile) * tile - k.shape[1]
    kp, vp = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (k, v))
    return rel_err(plain(q, kp, vp, scale), plain(q, k, v, scale))


def mutant_errors(plain, q, k, v, scale, axis: int, tile: int) -> dict:
    """How far two wrong kernels miss the plain version on the same inputs,
    relative to max|plain|: uniform attention (the mean of v over the
    attended axis) and attention that drops the last ``tile`` keys (the
    last, ragged key tile of Kernel A; the last frame of Kernel B)."""
    want = plain(q, k, v, scale)
    n = k.shape[axis]
    keep = (n - 1) // tile * tile
    uniform = v.float().mean(axis, keepdim=True).expand(v.shape).to(v.dtype)
    dropped = plain(q, k.narrow(axis, 0, keep), v.narrow(axis, 0, keep), scale)
    return {"uniform": rel_err(uniform, want), "drop_last_tile": rel_err(dropped, want)}


def temporal_mutant_errors(plain, q, k, v, scale, locs: int) -> dict:
    """mutant_errors over the frame axis (uniform attention, the last frame
    dropped) and wrong Kernel B tilings, relative to max|plain|: the
    rows of the last location tile (``locs`` locations, ragged at the end
    of S) never stored (left zero); at B > 1 every batch given batch 0's
    output (a tile walk that drops the batch index); and at T < 32 the
    zero-filled key rows of the 32-frame tile counted in the softmax (a
    zero key scores 0, not -inf)."""
    out = mutant_errors(plain, q, k, v, scale, axis=1, tile=1)
    want = plain(q, k, v, scale)
    s = q.shape[2]
    dropped = want.clone()
    dropped[:, :, (s - 1) // locs * locs:] = 0
    out["last_location_tile_dropped"] = rel_err(dropped, want)
    if q.shape[0] > 1:
        out["batch_index_dropped"] = rel_err(want[:1].expand(want.shape), want)
    if q.shape[1] < 32:
        out["unmasked_zero_keys"] = zero_pad_error(plain, q, k, v, scale, 32)
    return out


def rounded_width_plain(q, k, v, heads: int, scale: float):
    """Kernel B built for the next instantiated head width above d (8, 16,
    24, 32, 48 or 128): each head's scores over that many columns from its
    own first one (the next heads' columns, zeros past C), its out from its
    own d columns of v; plain PyTorch on ``(B, T, S, C)``."""
    import torch
    import torch.nn.functional as F

    from video_depth_anything_torch.ops import temporal_attention as ta

    b, t, s, c = q.shape
    d = c // heads
    dr = next((w for w in ta._SUPPORTED_D if w >= d), d)
    cols = (torch.arange(heads)[:, None] * d + torch.arange(dr)[None]).to(q.device)
    qh, kh = (F.pad(x.float(), (0, dr))[..., cols] for x in (q, k))
    probs = torch.softmax(torch.einsum("bqshd,bkshd->bshqk", qh, kh) * scale, dim=-1)
    v5 = v.reshape(b, t, s, heads, d).float()
    out = torch.einsum("bshqk,bkshd->bqshd", probs.to(q.dtype).float(), v5)
    return out.to(q.dtype).reshape(b, t, s, c)


def motion_mutant_errors(x, p: dict, cfg, heads: int) -> dict:
    """How far four wrong motion modules miss the plain version on the same
    inputs, relative to max|plain - x| (Kernel C's tolerance base): one
    whose frame attention is uniform (the mean of v over the frames), one
    that adds no APE rows, one that projects k with q's weights (a ring
    block read for the wrong product), and one that drops the last quarter
    of the feed-forward's hidden units (a short feed-forward loop).  Where
    T is not 8, 16 or 32, a fifth: the frame attention over T padded up to
    the kernel's Tp with zero keys and values left unmasked."""
    from unittest import mock

    import numpy as np
    import torch.nn.functional as F

    from video_depth_anything_torch.ops import motion_module as mm
    from video_depth_anything_torch.ops import temporal_attention as ta

    def uniform(q, k, v, heads, scale):
        return v.float().mean(1, keepdim=True).expand(v.shape).to(v.dtype)

    def no_table(n, c):
        return np.zeros((n, c), np.float32)

    want = mm.motion_module_plain(x, p, cfg, heads)
    base = float((want.float() - x.float()).abs().max())
    with mock.patch.object(ta, "temporal_attention_plain", uniform):
        got_uniform = mm.motion_module_plain(x, p, cfg, heads)
    with mock.patch.object(mm, "sinusoidal_position_table", no_table):
        got_no_ape = mm.motion_module_plain(x, p, cfg, heads)
    got_k_from_q = mm.motion_module_plain(x, {**p, "wk": p["wq"]}, cfg, heads)
    w2 = p["w2"].clone()
    w2[-x.shape[-1]:] = 0  # the last C of the 4C hidden units contribute nothing
    got_short_ff = mm.motion_module_plain(x, {**p, "w2": w2}, cfg, heads)
    out = {"uniform": max_err(got_uniform, want) / base,
           "no_ape": max_err(got_no_ape, want) / base,
           "k_from_q_weights": max_err(got_k_from_q, want) / base,
           "last_ff_chunk_dropped": max_err(got_short_ff, want) / base}
    t = x.shape[1]
    tp = mm.padded_frames(t)
    if tp > t:
        plain = ta.temporal_attention_plain

        def unmasked(q, k, v, heads, scale):  # zero frames t..tp-1 of k and v, as keys
            pad = (0, 0, 0, 0, 0, tp - t)
            return plain(q, F.pad(k, pad), F.pad(v, pad), heads, scale)

        with mock.patch.object(ta, "temporal_attention_plain", unmasked):
            out["unmasked_padded_keys"] = max_err(mm.motion_module_plain(x, p, cfg, heads),
                                                  want) / base
    return out


def wide_chain_mutant_errors(x, p: dict, cfg, heads: int, want) -> dict:
    """How far the wide chain's persistent GEMM would miss the plain version
    with four wrong plans, relative to max|plain - x|: each GEGLU tile's h
    and gate halves swapped (w1's and b1's halves exchanged), the in-place
    residual read after the tile was stored over it (y + 2 part: wo, bo, w2
    and b2 doubled), and at proj_out (its part the plain output less x and
    b_out) the walk's ragged corner tile never stored (read as zeros) and
    each CTA's accumulator carried into its next tile (``wide_schedule``'s
    walk on this card's SMs)."""
    import torch
    import torch.nn.functional as F

    from video_depth_anything_torch.ops import motion_module as mm

    base = float((want.float() - x.float()).abs().max())
    c, f = x.shape[-1], p["w1"].shape[1] // 2
    swapped = {**p, "w1": torch.cat([p["w1"][:, f:], p["w1"][:, :f]], 1),
               "b1": torch.cat([p["b1"][f:], p["b1"][:f]])}
    twice = {**p, **{k: 2 * p[k] for k in ("wo", "bo", "w2", "b2")}}
    out = {"geglu_halves_swapped": max_err(mm.motion_module_plain(x, swapped, cfg, heads), want) / base,
           "residual_after_store": max_err(mm.motion_module_plain(x, twice, cfg, heads), want) / base}
    m = x.numel() // c
    bn = mm.wide_bn(c, x.dtype)
    nm, nn = -(-m // mm.WIDE_BM), -(-c // bn)

    def tiles(v):  # (M, C) -> (row block, rows, column block, columns), zero-padded
        return F.pad(v, (0, nn * bn - c, 0, nm * mm.WIDE_BM - m)).view(nm, mm.WIDE_BM, nn, bn)

    def err(t):
        return max_err(t.reshape(nm * mm.WIDE_BM, nn * bn)[:m, :c].reshape(want.shape), want) / base

    got = tiles(want.float().reshape(m, c))
    part = tiles((want.float() - x.float()).reshape(m, c) - p["b_out"].float())
    skipped = got.clone()
    skipped[nm - 1, :, nn - 1] = 0
    carried = got.clone()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count if x.is_cuda else 132
    pairs = [(cm, cn, pm, pn) for cta in mm.wide_schedule(m, c, bn, sms)
             for (pm, pn), (cm, cn) in zip(cta, cta[1:])]  # (tile, the CTA's tile before it)
    out["edge_tile_skipped"] = err(skipped)
    if pairs:  # some CTA walks more than one tile
        i = torch.tensor(pairs, device=x.device)
        carried[i[:, 0], :, i[:, 1]] += part[i[:, 2], :, i[:, 3]]
        out["acc_carried"] = err(carried)
    return out


def wide_library_ms(x, w, cfg) -> str:
    """``torch.matmul``'s ms on each of the wide chain's products (operands
    of x's dtype at the products' shapes; GEGLU without its epilogue), as
    ``" library_ms name=ms ..."``; never called by the port."""
    import torch

    from video_depth_anything_torch.bench_motion_tail import wide_product_shapes
    from video_depth_anything_torch.utils.device import event_ms

    c = x.shape[-1]
    g = torch.Generator(device=x.device).manual_seed(1)
    out = []
    for name, (m, k, n) in wide_product_shapes(x.numel() // c, c, w["b1"].numel() // 2,
                                               cfg.num_attention_blocks).items():
        a = torch.randn(m, k, device=x.device, generator=g).to(x.dtype)
        b = (torch.randn(k, n, device=x.device, generator=g) * k**-0.5).to(x.dtype)
        out.append(f"{name}={event_ms(lambda: torch.matmul(a, b)):.4f}")
    return " library_ms " + " ".join(out)


def bwd_rel_err(got, want) -> float:
    """The worst of dq, dk and dv, each relative to its own max|plain|."""
    return max(rel_err(a, b) for a, b in zip(got, want))


def bwd_inputs(b: int, n: int, h: int, gen, device, fast: bool = False):
    """Peaked bf16 q, k, v (``attention_inputs``) as strided views of one
    qkv tensor, Kernel A's output and log-sum-exp on them (its fast
    variant's where ``fast``), and a cotangent g ~ N(0, 1)."""
    import torch

    from video_depth_anything_torch.ops.flash_attention import flash_attention

    d = 64
    qkv = attention_inputs((b, n, h * d), gen, device)
    q, k, v = (t.view(b, n, h, d) for t in qkv.split(h * d, dim=-1))
    o, lse = flash_attention(q, k, v, d**-0.5, with_lse=True, fast=fast)
    g = torch.randn(b, n, h, d, generator=gen, device=device).to(torch.bfloat16)
    return q, k, v, o, lse, g


def bwd_mutant_errors(q, k, v, o, g, scale) -> dict:
    """How far two wrong backward kernels miss the plain version on the
    same inputs (``bwd_rel_err``): one that takes Delta = 0, and one whose
    dK/dV loop drops the last (ragged) query tile."""
    from video_depth_anything_torch.ops.flash_attention import flash_attention_bwd_plain as bwd

    want = bwd(q, k, v, o, g, scale)
    no_delta = bwd(q, k, v, o * 0, g, scale)
    keep = (q.shape[1] - 1) // 64 * 64
    _, dk, dv = bwd(q[:, :keep], k, v, o[:, :keep], g[:, :keep], scale)
    return {"delta_zero": bwd_rel_err(no_delta, want),
            "drop_last_query_tile": bwd_rel_err((want[0], dk, dv), want)}


def tail_inputs(n: int, h: int, w: int, gen, device):
    """x ~ N(0, 1) bf16 ``(n, h, w, 128)`` and output_conv2's weights (torch
    layout) at the scales of the JAX tail test (tests/test_output_stack.py:25-31)."""
    import torch

    c = 128
    r = lambda *s, std: torch.randn(*s, generator=gen, device=device) * std  # noqa: E731
    x = r(n, h, w, c, std=1.0).to(torch.bfloat16)
    return x, r(32, c, 3, 3, std=0.1), r(32, std=0.1), r(1, 32, 1, 1, std=0.3), r(1, std=0.1)


def tail_mutant_errors(x, w1, b1, w2, b2, out_h: int, out_w: int) -> dict:
    """How far four wrong tails miss the plain version on the same inputs,
    relative to max|plain|: align_corners=False taps, a conv3x3 that keeps
    only its centre tap, one whose every tap reads one pixel further right
    (a tap's dx off by one: the conv's output shifted left by a column,
    zeros past the right edge), and one that reads only the first C / 2
    channels of the map (a kernel built for half the width)."""
    import torch
    import torch.nn.functional as F

    from video_depth_anything_torch.ops.output_tail import output_tail_plain
    from video_depth_anything_torch.ops.resize import bilinear_resize

    want = output_tail_plain(x, w1, b1, w2, b2, out_h, out_w)
    dt = x.dtype
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(out_h, out_w), mode="bilinear",
                      align_corners=False)
    y = torch.relu(F.conv2d(y, w1.to(dt), b1.to(dt), padding=1))
    shifted = torch.relu(F.conv2d(y, w2.to(dt), b2.to(dt))).permute(0, 2, 3, 1)
    centre = torch.zeros_like(w1)
    centre[:, :, 1, 1] = w1[:, :, 1, 1]
    centre_only = output_tail_plain(x, centre, b1, w2, b2, out_h, out_w)
    y = F.pad(bilinear_resize(x, out_h, out_w).permute(0, 3, 1, 2), (0, 1))
    y = torch.relu(F.conv2d(y, w1.to(dt), b1.to(dt), padding=1)[..., 1:])
    dx_shifted = torch.relu(F.conv2d(y, w2.to(dt), b2.to(dt))).permute(0, 2, 3, 1)
    half = x.clone()
    half[..., x.shape[-1] // 2:] = 0
    return {"align_corners_false": rel_err(shifted, want),
            "centre_tap_only": rel_err(centre_only, want),
            "tap_dx_shifted": rel_err(dx_shifted, want),
            "half_channels": rel_err(output_tail_plain(half, w1, b1, w2, b2, out_h, out_w), want)}


def probe_inputs(b: int, n: int, h: int, gen, device):
    """bf16 ``(b, n, h * 64)`` q, k ~ N(0, 0.5²) and v ~ N(0, 1): the spatial
    probe script's inputs (scripts/bench_spatial_variants.py:250-252)."""
    import torch

    return tuple((torch.randn(b, n, h * 64, generator=gen, device=device) * std).to(torch.bfloat16)
                 for std in (0.5, 0.5, 1.0))


def sbf16_running_max(q, k, v, scale, heads: int):
    """Exact ``sbf16`` with a running max, the max of the 64-key tiles seen
    so far with no rescale, in place of the global row max: the one-pass
    plan the kernel may not take (s - m is rounded to bf16, so even a
    rescaled running max computes another function)."""
    import torch
    import torch.nn.functional as F

    from video_depth_anything_torch.ops.attention_variants import LOG2E, exp2_poly

    b, n, hd = q.shape
    d, dt = hd // heads, q.dtype
    n_pad = -(-n // 128) * 128
    qs = (q.float() * (scale * LOG2E)).to(dt)
    kp, vp = (F.pad(t, (0, 0, 0, n_pad - n)) for t in (k, v))
    neg = torch.tensor(-1e30, dtype=torch.bfloat16, device=q.device)
    valid = torch.arange(n_pad, device=q.device) < n
    out = torch.empty_like(q)
    for h in range(heads):
        sl = slice(h * d, (h + 1) * d)
        s = torch.where(valid, (qs[..., sl].float() @ kp[..., sl].float().mT).to(torch.bfloat16),
                        neg)
        m = s.view(b, n, n_pad // 64, 64).amax(-1).cummax(-1).values.repeat_interleave(64, -1)
        p = exp2_poly((s - m).float())
        out[..., sl] = ((p.to(dt).float() @ vp[..., sl].float()) / p.sum(-1, keepdim=True)).to(dt)
    return out


def probe_mutant_errors(variant: str, q, k, v, scale, heads: int) -> dict:
    """How far wrong spatial probe kernels miss the plain version of
    ``variant`` on the same inputs, relative to max|plain|: uniform
    attention, a dropped last (ragged) key tile, the pair's two heads
    exchanged, P V paired with the wrong key tile (V rolled by 64 keys),
    for the no-mask variants a missing pad correction (zero pad keys
    counted in l), for ``sbf16`` and ``sbf16:fast`` the key mask dropped
    (zero pad keys scoring 0) and for exact ``sbf16`` a running max in
    place of the global one."""
    import torch.nn.functional as F

    from video_depth_anything_torch.ops.attention_variants import parse_variant, spatial_kernel_plain

    kind, arg = parse_variant(variant, q.shape[1])
    plain = lambda k_, v_, kind=kind, arg=arg: spatial_kernel_plain(  # noqa: E731
        kind, arg, q, k_, v_, scale, heads)
    want = plain(k, v)
    n = k.shape[1]
    keep = (n - 1) // 64 * 64
    if keep == 0:
        raise ValueError(f"{n} keys leave no full key tile to keep")
    uniform = v.float().mean(1, keepdim=True).expand(v.shape).to(v.dtype)
    b, nq, hd = want.shape
    swapped = want.view(b, nq, heads // 2, 2, hd // heads).flip(3).reshape(b, nq, hd)
    out = {"uniform": rel_err(uniform, want),
           "drop_last_tile": rel_err(plain(k[:, :keep], v[:, :keep]), want),
           "heads_swapped": rel_err(swapped, want),
           "v_tile_shifted": rel_err(plain(k, v.roll(64, dims=1)), want)}
    pad = -(-n // 128) * 128 - n
    kp, vp = (F.pad(t, (0, 0, 0, pad)) for t in (k, v))
    if kind == "chunk" or (kind == "ilv" and arg):
        out["no_pad_correction"] = rel_err(spatial_kernel_plain("ilv", False, q, kp, vp, scale,
                                                                heads), want)
    if kind == "sbf16" and not arg[1]:
        out["unmasked_pad_keys"] = rel_err(plain(kp, vp), want)
        if not arg[0]:
            out["running_max"] = rel_err(sbf16_running_max(q, k, v, scale, heads), want)
    return out


def chain_inputs(bh: int, gen, device, nq: int = 1376, nk: int = 1408):
    """The chain probe script's inputs (scripts/bench_softmax_chain.py:
    48-51): q, k ~ N(0, 0.35²) of width 64, v ~ N(0, 1) of width 128."""
    import torch

    return tuple((torch.randn(*shape, generator=gen, device=device) * std).to(torch.bfloat16)
                 for shape, std in (((bh, nq, 64), 0.35), ((bh, nk, 64), 0.35),
                                    ((bh, nk, 128), 1.0)))


def chain_mutant_errors(mode: str, q, k, v) -> dict:
    """How far two wrong chain kernels miss the plain version of ``mode``,
    relative to max|plain|: uniform attention (the mean of v's first 64
    columns over the keys) and a dropped last key tile."""
    from video_depth_anything_torch.ops.attention_variants import softmax_chain_plain

    want = softmax_chain_plain(mode, q, k, v)
    d = q.shape[-1]
    uniform = v[..., :d].float().mean(1, keepdim=True).expand(want.shape)
    dropped = softmax_chain_plain(mode, q, k[:, :-64], v[:, :-64])
    return {"uniform": rel_err(uniform, want), "drop_last_tile": rel_err(dropped, want)}


def resize_conv_inputs(n: int, h: int, w: int, c: int, gen, device):
    """x ~ N(0, 1) bf16 ``(n, h, w, c)``, w ~ N(0, 0.1²) ``(128, c, 3, 3)`` and
    b ~ N(0, 0.1²): the JAX test's scales (tests/test_resize_conv.py:22-26)."""
    import torch

    r = lambda *s, std: torch.randn(*s, generator=gen, device=device) * std  # noqa: E731
    return r(n, h, w, c, std=1.0).to(torch.bfloat16), r(128, c, 3, 3, std=0.1), r(128, std=0.1)


def resize_conv_mutant_errors(x, w, b, out_h: int, out_w: int) -> dict:
    """How far two wrong kernels miss the plain version, relative to
    max|plain|: half-pixel (align_corners False) taps, and a conv3x3 that
    keeps only its centre tap.  At the input's own size both corner rules
    give the identity, so the first is left out there."""
    import torch
    import torch.nn.functional as F

    from video_depth_anything_torch.ops.resize_conv import resize_conv_plain

    want = resize_conv_plain(x, w, b, out_h, out_w)
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(out_h, out_w), mode="bilinear",
                      align_corners=False)
    shifted = F.conv2d(y, w.to(x.dtype), padding=1).permute(0, 2, 3, 1) + b.to(x.dtype)
    centre = torch.zeros_like(w)
    centre[:, :, 1, 1] = w[:, :, 1, 1]
    errors = {"centre_tap_only": rel_err(resize_conv_plain(x, centre, b, out_h, out_w), want)}
    if (out_h, out_w) != tuple(x.shape[1:3]):
        errors["align_corners_false"] = rel_err(shifted, want)
    return errors


def attention_row(kernel: str, label: str, bt: int, n: int, h: int, d: int, g, dev) -> dict:
    """Kernel A (``kernel`` names the exact or the fast variant) against its
    plain version in bf16 on peaked and on flat inputs, with the mutants,
    kernel, plain and SDPA ms and the bound."""
    import torch.nn.functional as F

    from video_depth_anything_torch.ops import flash_attention as fa
    from video_depth_anything_torch.utils.device import event_ms as time_ms

    fast = kernel == "flash_attention_fast"
    qkv = attention_inputs((bt, n, h * d), g, dev)
    q, k, v = (t.view(bt, n, h, d) for t in qkv.split(h * d, dim=-1))
    scale = d**-0.5
    tile = 128 if d == 64 else 64  # the key tile of the Hopper kernel, of D = 192's
    plain = lambda q_, k_, v_, sc: fa.flash_attention_plain(q_, k_, v_, sc, fast=fast)  # noqa: E731
    got = fa.flash_attention(q, k, v, scale, fast=fast)
    want = plain(q, k, v, scale)
    mutants = mutant_errors(plain, q, k, v, scale, axis=1, tile=tile)
    qf = flat_inputs(q)  # the second check: near-uniform rows
    flat_err = rel_err(fa.flash_attention(qf, k, v, scale, fast=fast), plain(qf, k, v, scale))
    mutants["unmasked_zero_pad"] = zero_pad_error(plain, qf, k, v, scale, tile)
    ms = time_ms(lambda: fa.flash_attention(q, k, v, scale, fast=fast))
    plain_ms = time_ms(lambda: plain(q, k, v, scale), iters=3, warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale))
    b_ms, b_by = bound(4.0 * bt * h * n * n * d, 4.0 * bt * n * h * d * 2)
    row = dict(kernel=kernel, shape=f"{label} (B*T={bt}, N={n}, H={h}, D={d})",
               max_abs_err=max_err(got, want), rel_err=max(rel_err(got, want), flat_err),
               tol=ATTN_TOL, mutants=mutants, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=lib_ms,
               extra=f" (peaked {rel_err(got, want):.3e}, flat {flat_err:.3e})")
    if (kernel, label) in PARENT_MS:
        row["parent_ms"] = PARENT_MS[(kernel, label)]
    return row


def motion_row(label: str, c: int, s: int, t: int, g, dev, split: bool = False) -> dict:
    """Kernel C on one bf16 module of width ``c`` over ``s`` locations and
    ``t`` frames, with the kernel's own weight layout (``kernel_weights``,
    as TemporalModule caches them) and a GroupNorm fold done before (timed
    on its own), against its plain version, with the mutants, the bound and
    (``split``) the split by stage."""
    import torch

    from video_depth_anything_torch.config import MotionModuleConfig
    from video_depth_anything_torch.ops import motion_module as mm
    from video_depth_anything_torch.utils.device import event_ms as time_ms

    cfg = MotionModuleConfig()
    b = 1
    x = (torch.randn(b, t, s, c, device=dev, generator=g)).to(torch.bfloat16)
    p = motion_params(c, seed=c, device=dev)
    w = mm.kernel_weights(p, cfg)
    gna, gnb = mm.gn_fold(x, w, cfg)
    got = mm.motion_module_launch(x, gna, gnb, w, cfg, 8)
    want = mm.motion_module_plain(x, p, cfg, 8)
    err = max_err(got, want)
    rel = err / float((want.float() - x.float()).abs().max())
    mutants = motion_mutant_errors(x, p, cfg, 8)
    ms = time_ms(lambda: mm.motion_module_launch(x, gna, gnb, w, cfg, 8))
    extra = ""
    if split:
        parts = mm.motion_module_split(x, gna, gnb, w, cfg, 8)
        extra = " split_ms " + " ".join(f"{k}={v:.4f}" for k, v in parts.items())
    if not mm.resident(c, 8, cfg):  # the wide chain: by launch, the library beside each product
        mutants.update(wide_chain_mutant_errors(x, p, cfg, 8, want))
        parts = mm.motion_module_wide_split(x, gna, gnb, w, cfg, 8)
        extra = (" split_ms " + " ".join(f"{k}={v:.4f}" for k, v in parts.items())
                 + wide_library_ms(x, w, cfg))
    fold_ms = time_ms(lambda: mm.gn_fold(x, w, cfg))
    plain_ms = time_ms(lambda: mm.motion_module_plain(x, p, cfg, 8), iters=5)
    tokens = b * t * s
    flops = tokens * (44.0 * c * c + 2 * 4.0 * t * c)
    nbytes = 2 * tokens * c * 2 + (22 * c * c) * 2 + 2 * b * t * c * 4
    b_ms, b_by = bound(flops, nbytes)
    name = "motion_module" if mm.resident(c, 8, cfg) else "motion_module_wide"
    return dict(kernel=name, shape=f"{label} (B={b}, T={t}, S={s}, C={c})",
                max_abs_err=err, rel_err=rel, tol=MOTION_TOL, mutants=mutants, ms=ms,
                gn_fold_ms=fold_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, extra=extra)


def phase_kernels(dev):
    import torch
    import torch.nn.functional as F

    from video_depth_anything_torch.ops import attention_variants as av
    from video_depth_anything_torch.ops import cuda_build
    from video_depth_anything_torch.ops import flash_attention as fa
    from video_depth_anything_torch.ops import motion_module as mm
    from video_depth_anything_torch.ops import output_tail as ot
    from video_depth_anything_torch.ops import resize_conv as rc
    from video_depth_anything_torch import bench_temporal
    from video_depth_anything_torch.ops import temporal_attention as ta
    from video_depth_anything_torch.utils.device import event_ms as time_ms
    from video_depth_anything_torch.utils.device import graph_ms

    g = torch.Generator(device=dev).manual_seed(0)
    rows = []

    # Kernel A: vits (6 heads) and vitl (16 heads) token counts at 518x518
    # and 518x924; the fast (no-max) variant at the vits window shapes and
    # the streaming steps' (one frame, and a chunk of 8, at 518x924); D = 192
    # and an odd head count on synthetic shapes (no shipped encoder has
    # them: the JAX package's _flash_kernel_single domain).
    for kernel, label, bt, n, h, d in (
            ("flash_attention", "518x518", 32, 1370, 6, 64),
            ("flash_attention", "518x924", 32, 2443, 6, 64),
            ("flash_attention", "vitl 518x518", 32, 1370, 16, 64),
            ("flash_attention", "vitl 518x924", 32, 2443, 16, 64),
            ("flash_attention", "synthetic D=192", 32, 1370, 2, 192),
            ("flash_attention_fast", "synthetic D=192", 32, 1370, 2, 192),
            ("flash_attention", "synthetic D=192 ragged", 32, 2443, 2, 192),
            ("flash_attention", "synthetic odd heads", 32, 1370, 3, 64),
            ("flash_attention_fast", "518x924", 32, 2443, 6, 64),
            ("flash_attention_fast", "518x518", 32, 1370, 6, 64),
            ("flash_attention_fast", "stream 518x924 frame", 1, 2443, 6, 64),
            ("flash_attention_fast", "stream 518x924 chunk", 8, 2443, 6, 64),
            *(("flash_attention", label, 32, n, 6, 64) for label, n in EVAL_ATTN)):
        rows.append(attention_row(kernel, label, bt, n, h, d, g, dev))

    # Kernel A's backward at the training shapes: a 518² window of 32
    # frames and the CLI's default clip (8 frames at 266², 362 tokens) for
    # vits (6 heads) and vitl (16), and at 518² from the fast forward's
    # log-sum-exp.  The library call is the backward alone of SDPA through
    # autograd.
    for label, bt, n, h, fast in (("vits 518x518", 32, 1370, 6, False),
                                  ("vits 266x266", 8, 362, 6, False),
                                  ("vitl 266x266", 8, 362, 16, False),
                                  ("vits 518x518, fast forward's lse", 32, 1370, 6, True)):
        d = 64
        scale = d**-0.5
        q, k, v, o, lse, g_ = bwd_inputs(bt, n, h, g, dev, fast=fast)
        got = fa.flash_attention_bwd(q, k, v, o, lse, g_, scale)
        want = fa.flash_attention_bwd_plain(q, k, v, o, g_, scale)
        mutants = bwd_mutant_errors(q, k, v, o, g_, scale)
        ms = time_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, g_, scale))
        split = fa.flash_attention_bwd_split(q, k, v, o, lse, g_, scale)
        plain_ms = time_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, o, g_, scale), iters=3,
                           warmup=1)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
        gt = g_.transpose(1, 2)
        lib_ms = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True))
        elems = bt * n * h * d
        b_ms, b_by = bound(10.0 * bt * h * n * n * d, 8.0 * elems * 2 + bt * h * n * 4)
        rows.append(dict(kernel="flash_attention_bwd",
                         shape=f"{label} (B*T={bt}, N={n}, H={h}, D={d})",
                         max_abs_err=max(max_err(a, b) for a, b in zip(got, want)),
                         rel_err=bwd_rel_err(got, want), tol=BWD_TOL, mutants=mutants, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                         extra=" split_ms " + " ".join(f"{k}={v:.4f}" for k, v in split.items())))
        del q, k, v, o, lse, g_, got, want, qt, kt, vt, out, gt

    # Kernel B at every width of its domain (vits m0/m2/m1, vitb m2/m0, vitl
    # m2/m0 at 518x518 and m0 at 518x924; d = 32, 48 and 128 are --attn_impl
    # pallas's), two ragged T = 17 cases (a ragged last location tile at
    # C = 64), and the vits and vitb window calls at the pipeline's batch of
    # 4 windows (the tile walk's batch index).  Times are device times over
    # inputs rotated through more bytes than L2 holds (bench_temporal.inputs,
    # graph_ms): the kernel's launch path outlasts its few microseconds on
    # the host.
    for n_row, (label, b, t, s, c) in enumerate(bench_temporal.SHAPES
                                                + bench_temporal.WINDOW_SHAPES + EVAL_TEMPORAL):
        heads = bench_temporal.HEADS
        copies = bench_temporal.inputs(b, t, s, c, 100 + n_row, dev)
        q, k, v = copies[0]
        scale = (c // heads) ** -0.5
        got = ta.temporal_attention(q, k, v, heads, scale)
        want = ta.temporal_attention_plain(q, k, v, heads, scale)
        plain = lambda q_, k_, v_, sc: ta.temporal_attention_plain(q_, k_, v_, heads, sc)  # noqa: E731
        mutants = temporal_mutant_errors(plain, q, k, v, scale, ta.tile_plan(c, heads)[0])
        ms = graph_ms([lambda x=x: ta.temporal_attention(*x, heads, scale) for x in copies])
        plain_ms = graph_ms([lambda: ta.temporal_attention_plain(q, k, v, heads, scale)], reps=5)
        d = c // heads
        q5, k5, v5 = (x.view(b, t, s, heads, d).permute(0, 2, 3, 1, 4) for x in (q, k, v))
        lib_ms = graph_ms([lambda: F.scaled_dot_product_attention(q5, k5, v5, scale=scale)])
        b_ms, b_by = bound(4.0 * b * s * c * t * t, 4.0 * b * t * s * c * 2)
        row = dict(kernel="temporal_attention",
                   shape=f"{label} (B={b}, T={t}, S={s}, C={c}, d={d})",
                   max_abs_err=max_err(got, want), rel_err=rel_err(got, want), tol=ATTN_TOL,
                   mutants=mutants, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=lib_ms, extra=f" ms/bound_ms={ms / b_ms:.2f}")
        # the parent was timed at B = 1 only, and not at phase eval's shapes
        if b == 1 and (label, b, t, s, c) not in EVAL_TEMPORAL:
            row["parent_ms"] = PARENT_MS.get(("temporal_attention", label))
        rows.append(row)
        del copies, q, k, v, got, want, q5, k5, v5

    # Kernel C: ``ms`` times the launch alone on weights prepared once
    # (``kernel_weights``, as TemporalModule caches them) and a GroupNorm
    # fold done before; the fold is timed on its own.  The first shape of
    # each width in mm.SPLIT_C also prints the split by stage; every row
    # prints the earlier kernel's ms (PARENT_MS) beside its own.  vits and
    # vitl m3 at 518x518 also at T = 12, 16, 20 and 24 (the feature cache's
    # --inference_length; T = 12, 20, 24 padded to 16, 32, 32 rows a
    # location, with the unmasked-padded-keys mutant).
    split_done = set()
    for label, c, s, t in MOTION_ROWS + EVAL_MOTION + WIDE_MOTION_ROWS:
        row = motion_row(label, c, s, t, g, dev, split=c in mm.SPLIT_C and c not in split_done)
        split_done.add(c)
        # the earlier kernel was timed at T = 32, and not at phase eval's shapes
        # (nor at the wide chain's widths, which it could not hold)
        if t == 32 and (label, c, s, t) in MOTION_ROWS:
            row["parent_ms"] = PARENT_MS[("motion_module", label)]
        rows.append(row)

    # The output tail at vitl's map sizes; 518x924 is beyond the JAX gate's
    # VMEM term, so only this phase runs the kernel there.  ``plain_ms`` is
    # the library chain (F.interpolate and cuDNN's conv2d); no single
    # PyTorch call computes the tail, so ``library_ms`` is None.
    for label, (n, h, w, oh, ow) in (("vitl 518x518", (32, 296, 296, 518, 518)),
                                     ("vitl 518x924", (32, 296, 528, 518, 924))):
        x, w1, b1, w2, b2 = tail_inputs(n, h, w, g, dev)
        got = ot.output_tail(x, w1, b1, w2, b2, oh, ow)
        want = ot.output_tail_plain(x, w1, b1, w2, b2, oh, ow)
        mutants = tail_mutant_errors(x, w1, b1, w2, b2, oh, ow)
        ms = time_ms(lambda: ot.output_tail(x, w1, b1, w2, b2, oh, ow))
        split = ot.output_tail_split(x, w1, b1, w2, b2, oh, ow)
        plain_ms = time_ms(lambda: ot.output_tail_plain(x, w1, b1, w2, b2, oh, ow), iters=5)
        c = x.shape[-1]
        flops = n * oh * ow * (2.0 * 9 * c * 32 + 2.0 * 32)
        nbytes = x.numel() * 2 + n * oh * ow * 2 + (9 * c * 32 + 65) * 2
        b_ms, b_by = bound(flops, nbytes)
        rows.append(dict(kernel="output_tail", shape=f"{label} ({n}x{h}x{w}x{c} -> {oh}x{ow})",
                         max_abs_err=max_err(got, want), rel_err=rel_err(got, want),
                         tol=TAIL_TOL, mutants=mutants, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None,
                         parent_ms=PARENT_MS[("output_tail", label)],
                         extra=" split_ms " + " ".join(f"{k}={v:.4f}" for k, v in split.items())))
        del x, got, want

    # Kernel A's probe kernels (TPU row 10) at the probe script's shapes,
    # vitl (16 heads) then vits (6), every variant the JAX domain admits at
    # n = 1370 (chunk8 is outside it); the library call is SDPA, except for
    # ceiling, which computes no softmax.
    probe_kernel = {"ilv": "ilv_attention", "chunk": "chunk_attention", "sbf16": "sbf16_attention"}
    for enc, h in (("vitl", 16), ("vits", 6)):
        bt, n, d = 32, 1370, 64
        scale = d**-0.5
        q, k, v = probe_inputs(bt, n, h, g, dev)
        qt, kt, vt = (t.view(bt, n, h, d).transpose(1, 2) for t in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale))
        b_ms, b_by = bound(4.0 * bt * h * n * n * d, 4.0 * bt * n * h * d * 2)
        for variant in av.SPATIAL_VARIANTS:
            try:
                kind, _ = av.parse_variant(variant, n)
            except ValueError:
                continue
            run = lambda: av.spatial_variant(variant, q, k, v, scale, n, h)  # noqa: E731
            got = run()
            want = av.spatial_variant_plain(variant, q, k, v, scale, n, h)
            mutants = probe_mutant_errors(variant, q, k, v, scale, h)
            ms = time_ms(run)
            plain_ms = time_ms(lambda: av.spatial_variant_plain(variant, q, k, v, scale, n, h),
                               iters=3, warmup=1)
            row = dict(kernel=probe_kernel[kind],
                       shape=f"{enc} {variant} (B*T={bt}, N={n}, H={h}, D={d})",
                       max_abs_err=max_err(got, want), rel_err=rel_err(got, want),
                       tol=ATTN_TOL, mutants=mutants, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=None if variant == "ceiling" else lib_ms)
            row["parent_ms"] = PARENT_MS[(probe_kernel[kind], f"{enc} {variant}")]
            mix = PROBE_CHAIN.get("chunk" if kind == "chunk" else variant)
            if mix is not None:  # ceiling has no chain
                n_pad = -(-n // 128) * 128
                row["extra"] = f" chain_bound_ms={chain_bound(mix, bt * h * n_pad**2):.4f}"
            rows.append(row)
            del got, want
        del q, k, v, qt, kt, vt

    # The softmax-chain probe (TPU row 11) at its script's shapes, each of
    # the seven modes; mutants on the first 64 batch-heads.  No single
    # PyTorch call computes these unnormalised chains.
    bh, nq, nk, d = 512, 1376, 1408, 64
    qc, kc, vc = chain_inputs(bh, g, dev, nq, nk)
    b_ms, b_by = bound(2.0 * 2 * bh * nq * nk * d, (2 * bh * nq * d + 2 * bh * nk * d) * 2)
    for mode in av.CHAIN_MODES:
        got = av.softmax_chain(mode, qc, kc, vc)
        want = av.softmax_chain_plain(mode, qc, kc, vc)
        mutants = chain_mutant_errors(mode, qc[:64], kc[:64], vc[:64])
        ms = time_ms(lambda: av.softmax_chain(mode, qc, kc, vc))
        plain_ms = time_ms(lambda: av.softmax_chain_plain(mode, qc, kc, vc), iters=3, warmup=1)
        row = dict(kernel="softmax_chain", shape=f"{mode} (BH={bh}, Nq={nq}, Nk={nk}, D={d}, Dv=128)",
                   max_abs_err=max_err(got, want), rel_err=rel_err(got, want), tol=CHAIN_TOL,
                   mutants=mutants, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=None, parent_ms=PARENT_MS[("softmax_chain", mode)])
        if mode in CHAIN_MIX:  # both kernels compute 1408 query rows
            row["extra"] = f" chain_bound_ms={chain_bound(CHAIN_MIX[mode], bh * 1408.0 * nk):.4f}"
        rows.append(row)
        del got, want
    del qc, kc, vc

    # The fused resize -> conv (TPU row 9) at the vitl refinenet1 ->
    # output_conv1 junction; the library yardstick is the chain
    # F.interpolate + cuDNN's conv2d with its bias.
    n, h, w, c, oh, ow = 32, 148, 148, 256, 296, 296
    x, wc, bc = resize_conv_inputs(n, h, w, c, g, dev)
    got = rc.resize_conv(x, wc, bc, oh, ow)
    want = rc.resize_conv_plain(x, wc, bc, oh, ow)
    mutants = resize_conv_mutant_errors(x, wc, bc, oh, ow)
    ms = time_ms(lambda: rc.resize_conv(x, wc, bc, oh, ow))
    _, keep, launch = rc._launch_args(x, wc, bc, oh, ow)  # the kernel's launch alone
    kernel_ms = time_ms(lambda: cuda_build.check(rc._kernel()(*launch), "resize_conv"))
    plain_ms = time_ms(lambda: rc.resize_conv_plain(x, wc, bc, oh, ow), iters=5)
    xn, wb, bb = x.permute(0, 3, 1, 2), wc.to(x.dtype), bc.to(x.dtype)
    lib_ms = time_ms(lambda: F.conv2d(F.interpolate(xn, size=(oh, ow), mode="bilinear",
                                                    align_corners=True), wb, bb, padding=1))
    b_ms, b_by = bound(n * oh * ow * 2.0 * 9 * c * 128,
                       x.numel() * 2 + n * oh * ow * 128 * 2 + (wc.numel() + 128) * 2)
    rows.append(dict(kernel="resize_conv", shape=f"vitl junction ({n}x{h}x{w}x{c} -> {oh}x{ow}x128)",
                     max_abs_err=max_err(got, want), rel_err=rel_err(got, want),
                     tol=RESIZE_CONV_TOL, mutants=mutants, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                     bound_by=b_by, library_ms=lib_ms,
                     parent_ms=PARENT_MS[("resize_conv", "vitl junction")],
                     extra=f" kernel_ms={kernel_ms:.4f} (the launch alone, as parent_ms)"))
    del x, got, want, xn, keep, launch

    # The kernel tests' shapes (tests/test_torch_cuda_kernels.py), each with
    # its mutants: the chain at an odd count of query blocks and of key
    # tiles; resize -> conv downsampling, at and near the same size (taps
    # read from global memory), at a large upsampling and with more tiles
    # than SMs.
    for mode, (nq, nk) in [(m, (300, 384)) for m in av.CHAIN_MODES] + [("exp", (200, 320))]:
        q, k, v = chain_inputs(8, g, dev, nq, nk)
        got, want = av.softmax_chain(mode, q, k, v), av.softmax_chain_plain(mode, q, k, v)
        b_ms, b_by = bound(4.0 * 8 * nq * nk * 64, (2 * 8 * nq * 64 + 2 * 8 * nk * 64) * 2)
        rows.append(dict(kernel="softmax_chain", shape=f"test {mode} (BH=8, Nq={nq}, Nk={nk})",
                         max_abs_err=max_err(got, want), rel_err=rel_err(got, want),
                         tol=CHAIN_TOL, mutants=chain_mutant_errors(mode, q, k, v),
                         ms=time_ms(lambda: av.softmax_chain(mode, q, k, v)),
                         plain_ms=time_ms(lambda: av.softmax_chain_plain(mode, q, k, v)),
                         bound_ms=b_ms, bound_by=b_by, library_ms=None))
    for n, h, w, c, oh, ow in ((2, 40, 36, 128, 19, 23), (1, 19, 21, 256, 19, 21),
                               (1, 19, 21, 256, 21, 23), (1, 5, 7, 128, 64, 90),
                               (140, 8, 8, 128, 16, 16)):
        x, wc, bc = resize_conv_inputs(n, h, w, c, g, dev)
        got, want = rc.resize_conv(x, wc, bc, oh, ow), rc.resize_conv_plain(x, wc, bc, oh, ow)
        b_ms, b_by = bound(n * oh * ow * 2.0 * 9 * c * 128,
                           x.numel() * 2 + n * oh * ow * 128 * 2 + (wc.numel() + 128) * 2)
        rows.append(dict(kernel="resize_conv", shape=f"test {n}x{h}x{w}x{c} -> {oh}x{ow}x128",
                         max_abs_err=max_err(got, want), rel_err=rel_err(got, want),
                         tol=RESIZE_CONV_TOL, mutants=resize_conv_mutant_errors(x, wc, bc, oh, ow),
                         ms=time_ms(lambda: rc.resize_conv(x, wc, bc, oh, ow)),
                         plain_ms=time_ms(lambda: rc.resize_conv_plain(x, wc, bc, oh, ow)),
                         bound_ms=b_ms, bound_by=b_by, library_ms=None))
        del x, got, want
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    check_rows(rows, "kernels")
    return rows


def check_rows(rows, tag: str) -> None:
    """Print each kernel row; fail if a kernel misses its tolerance or a
    mutant meets it."""
    failed = False
    for r in rows:
        err = r["rel_err"]
        mutants = r.get("mutants", {})
        ok = err <= r["tol"] and all(m > r["tol"] for m in mutants.values())
        failed |= not ok
        extra = r.get("extra", "") + "".join(f" mutant {k} rel_err={v:.3e}"
                                             for k, v in mutants.items())
        if "gn_fold_ms" in r:
            extra += f" gn_fold_ms={r['gn_fold_ms']:.4f}"
        if "parent_ms" in r:
            extra += (" parent_ms=none (outside the earlier kernel's domain)" if r["parent_ms"] is None
                      else f" parent_ms={r['parent_ms']:.4f}")
        ratio = "" if r["library_ms"] is None else f" ms/library_ms={r['ms'] / r['library_ms']:.3f}"
        log(f"[{tag}] {r['kernel']:<20} {r['shape']:<62} rel_err={err:.3e} (tol {r['tol']}) "
            f"max_abs_err={r['max_abs_err']:.3e}{extra} ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            f"library_ms={r['library_ms']}{ratio} {'OK' if ok else 'FAIL'}")
    if failed:
        raise SystemExit("a kernel disagrees with its plain version, or the check cannot "
                         "tell a wrong kernel from a right one")


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "video_depth_anything_torch", "csrc")):
        log("chip_smoke: video_depth_anything_torch/ is not beside this script")
        return 2
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 3
    sys.path.insert(0, REPO)
    from video_depth_anything_torch.ops import cuda_build
    from video_depth_anything_torch.utils.device import card_line

    smi = card_line()
    log(smi)
    dev = torch.device("cuda")

    t_start = t0 = time.time()
    cuda_build.build_all()
    log(f"[card] kernels built in {time.time() - t0:.1f} s")
    for name in cuda_build.SOURCES:
        logf = cuda_build.BUILD_DIR / f"{name}.log"
        if logf.exists():
            for line in logf.read_text().splitlines():
                if "entry function" in line or "registers" in line or "spill" in line:
                    log(f"[ptxas] {name}: {line.strip()}")

    def timed(name, phase, *args):
        t = time.time()
        out = phase(*args)
        log(f"[time] phase {name}: {time.time() - t:.1f} s")
        return out

    rows = timed("kernels", phase_kernels, dev)
    timed("window", phase_window, dev, smi)
    switch_launches = timed("fused_switch", phase_fused_switch, dev, smi)
    domain_launches, domain = timed("domain", phase_domain, dev, smi)
    wide_launches, wide = timed("wide", phase_wide, dev, smi)
    launches = timed("cli", phase_cli, smi)
    stream_launches = timed("stream", phase_stream, dev, smi)
    timed("train", phase_train_check, dev, smi)
    train_launches = timed("train-cli", phase_train_cli, smi)
    eval_launches = timed("eval", phase_eval, smi)
    probe_launches = timed("probes", phase_probes, dev, smi)
    f32_rows, f32_launches = timed("fp32", phase_fp32, dev, smi)
    timed("bench", phase_bench, smi)
    par_launches = timed("parallel", phase_parallel, smi)
    vitg_launches = timed("vitg", phase_vitg, dev, smi)
    demo_launches = timed("tooling", phase_tooling, dev, smi)
    rows = rows + f32_rows + domain + wide

    info = {
        "flash_attention": ("flash_attention", "csrc/flash_attention.cu",
                            "video_depth_anything_tpu/ops/pallas_attention.py:202"),
        "flash_attention_fast": ("flash_attention_fast", "csrc/flash_attention.cu",
                                 "video_depth_anything_tpu/ops/pallas_attention.py:123"),
        "flash_attention_bwd": ("flash_attention_bwd", "csrc/flash_attention_bwd.cu",
                                "video_depth_anything_tpu/ops/pallas_attention.py:248"),
        "temporal_attention": ("temporal_attention", "csrc/temporal_attention.cu",
                               "video_depth_anything_tpu/ops/pallas_temporal.py:59"),
        "motion_module": ("fused_motion_module", "csrc/motion_module.cu",
                          "video_depth_anything_tpu/ops/pallas_motion.py:107"),
        "output_tail": ("output_tail", "csrc/output_tail.cu",
                        "video_depth_anything_tpu/ops/pallas_output_stack.py:180"),
        # the probe kernels and the fused resize -> conv: phase probes
        "resize_conv": ("resize_conv", "csrc/resize_conv.cu",
                        "video_depth_anything_tpu/ops/pallas_resize_conv.py:63"),
        "ilv_attention": ("ilv_attention", "csrc/attention_variants_hopper.cu",
                          "scripts/bench_spatial_variants.py:49"),
        "chunk_attention": ("chunk_attention", "csrc/attention_variants_hopper.cu",
                            "scripts/bench_spatial_variants.py:86"),
        "sbf16_attention": ("sbf16_attention", "csrc/attention_variants_hopper.cu",
                            "scripts/bench_spatial_variants.py:130"),
        "softmax_chain": ("softmax_chain", "csrc/attention_variants_hopper.cu",
                          "scripts/bench_softmax_chain.py:54"),
        # the fp32 kernels: phase fp32's --fp32 CLI runs
        "flash_attention_f32": ("flash_attention_f32", "csrc/flash_attention_f32.cu",
                                "video_depth_anything_tpu/ops/pallas_attention.py:202"),
        "temporal_attention_f32": ("temporal_attention_f32", "csrc/temporal_attention_f32.cu",
                                   "video_depth_anything_tpu/ops/pallas_temporal.py:59"),
        "motion_module_f32": ("fused_motion_module_f32", "csrc/motion_module_f32.cu",
                              "video_depth_anything_tpu/ops/pallas_motion.py:107"),
        # Kernel C at C = 768 and 1024 (VDA_FUSED_MOTION=1): phase fused_switch
        "motion_module_wide": ("fused_motion_module_wide", "csrc/motion_module_wide.cu",
                               "video_depth_anything_tpu/ops/pallas_motion.py:107"),
        "motion_module_wide_f32": ("fused_motion_module_wide_f32", "csrc/motion_module_wide.cu",
                                   "video_depth_anything_tpu/ops/pallas_motion.py:107"),
        # Kernel B off its six instantiated widths: phase domain
        "temporal_attention_any": ("temporal_attention_any", "csrc/temporal_attention_any.cu",
                                   "video_depth_anything_tpu/ops/pallas_temporal.py:59"),
        "temporal_attention_any_f32": ("temporal_attention_any_f32",
                                       "csrc/temporal_attention_any_f32.cu",
                                       "video_depth_anything_tpu/ops/pallas_temporal.py:59"),
        # Kernel A at D >= 320: phase wide
        "flash_attention_wide": ("flash_attention_wide", "csrc/flash_attention_wide.cu",
                                 "video_depth_anything_tpu/ops/pallas_attention.py:159"),
        "flash_attention_wide_f32": ("flash_attention_wide_f32", "csrc/flash_attention_wide.cu",
                                     "video_depth_anything_tpu/ops/pallas_attention.py:159"),
    }
    kernels = []
    for name, (wrapper, src, replaces) in info.items():
        # the first row at a main-path shape (synthetic rows are off the path)
        first = next(r for r in rows if r["kernel"] == name and "synthetic" not in r["shape"])
        if wrapper in probe_launches:
            count = probe_launches[wrapper]
        elif wrapper in f32_launches:
            count = f32_launches[wrapper] + eval_launches[wrapper] + vitg_launches[wrapper]
        else:
            count = sum(d.get(wrapper, 0) for d in (
                launches, stream_launches, train_launches, eval_launches, par_launches,
                vitg_launches, demo_launches))
        count += (switch_launches.get(wrapper, 0) + domain_launches.get(wrapper, 0)
                  + wide_launches.get(wrapper, 0))
        kernels.append({
            "name": name, "route": "cuda", "source": f"video_depth_anything_torch/{src}",
            "replaces": replaces, "launches": count,
            **{k: first[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")},
        })
    if any(k["launches"] == 0 for k in kernels):
        raise SystemExit(f"a kernel of the main path never launched: {kernels}")
    log(f"[done] Kernel B's launches by head width over the main path (phases cli, stream, "
        f"train-cli, eval): {dict(sorted(MAIN_PATH_WIDTHS.items()))}")
    log(f"[done] every phase passed in {time.time() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def launch_counts() -> dict:
    from video_depth_anything_torch.run import kernel_launches

    return kernel_launches()


MAIN_PATH_WIDTHS = {}  # Kernel B's launches by head width over the main-path runs


def main_path_launches() -> dict:
    """``launch_counts()`` after a main-path run; Kernel B's launches by
    head width are added to MAIN_PATH_WIDTHS."""
    from video_depth_anything_torch.ops.temporal_attention import temporal_attention

    for d, n in temporal_attention.width_launches.items():
        MAIN_PATH_WIDTHS[d] = MAIN_PATH_WIDTHS.get(d, 0) + n
    return launch_counts()


def probe_wrappers() -> tuple:
    """The wrappers of the kernels that phase probes drives."""
    from video_depth_anything_torch.ops import attention_variants as av
    from video_depth_anything_torch.ops.resize_conv import resize_conv

    return (av.ilv_attention, av.chunk_attention, av.sbf16_attention, av.softmax_chain,
            resize_conv)


def zero_counts() -> None:
    from video_depth_anything_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from video_depth_anything_torch.ops.motion_module import fused_motion_module
    from video_depth_anything_torch.ops.output_tail import output_tail
    from video_depth_anything_torch.ops.temporal_attention import temporal_attention

    for f in (flash_attention, flash_attention_bwd, temporal_attention, fused_motion_module,
              output_tail) + probe_wrappers():
        f.launches = 0
    flash_attention.fast_launches = 0
    flash_attention.wide_launches = flash_attention.wide_f32_launches = 0
    for f in (flash_attention, temporal_attention, fused_motion_module):
        f.f32_launches = 0
    fused_motion_module.wide_launches = fused_motion_module.wide_f32_launches = 0
    temporal_attention.any_launches = temporal_attention.any_f32_launches = 0
    temporal_attention.width_launches = {}
    temporal_attention.f32_width_launches = {}
    output_tail.width_launches = {}


def phase_probes(dev, smi: str) -> dict:
    """The probe kernels' and the fused resize -> conv's path:
    ``bench_spatial_variants.main`` and ``bench_softmax_chain.main``
    in-process at their full shapes with their default lists (the only
    error rows allowed are the JAX domain's: chunk8 at n = 1370), then
    ``ResizeConvFn`` forward and backward at the vitl junction against
    autograd through ``resize_conv_plain``.  Counts zeroed before, read
    after."""
    import contextlib
    import io

    import torch

    from video_depth_anything_torch import bench_softmax_chain, bench_spatial_variants
    from video_depth_anything_torch.ops import resize_conv as rc
    from video_depth_anything_torch.utils.device import event_ms as time_ms

    zero_counts()
    expected = {bench_spatial_variants: 2 * (2 + 8), bench_softmax_chain: 7 + 2}
    for bench, n_rows in expected.items():
        name = bench.__name__.rsplit(".", 1)[-1]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc_main = bench.main([])
        lines = buf.getvalue().splitlines()
        for line in lines:
            log(f"[probes] {name}: {line}")
        rows = [json.loads(x) for x in lines[1:]]
        errors = {r["variant"] for r in rows if "error" in r}
        timed_ok = all(r.get("ms_per_call", r.get("ms", 0)) > 0 for r in rows if "error" not in r)
        ok = (rc_main == 0 and lines[0] == smi and len(rows) == n_rows and timed_ok
              and errors <= {"chunk8"})
        if not ok:
            raise SystemExit(f"{name} failed: rc {rc_main}, error rows {errors}")

    g = torch.Generator(device=dev).manual_seed(4)
    n, h, w, c, oh, ow = 32, 148, 148, 256, 296, 296
    x, wc, bc = (t.requires_grad_() for t in resize_conv_inputs(n, h, w, c, g, dev))
    cot = torch.randn(n, oh, ow, 128, generator=g, device=dev).to(torch.bfloat16)

    def kernel_path():
        out = rc.ResizeConvFn.apply(x, wc, bc, oh, ow)
        return (out, *torch.autograd.grad(out, (x, wc, bc), cot))

    def plain_path():
        out = rc.resize_conv_plain(x, wc, bc, oh, ow)
        return (out, *torch.autograd.grad(out, (x, wc, bc), cot))

    got = kernel_path()
    counts = {f.__name__: f.launches for f in probe_wrappers()}
    want, again = plain_path(), plain_path()
    with torch.no_grad():
        errs = [rel_err(a, b) for a, b in zip(got, want)]
        spread = [rel_err(a, b) for a, b in zip(again, want)]
    ms, plain_ms = time_ms(kernel_path, iters=3, warmup=1), time_ms(plain_path, iters=3, warmup=1)
    ok = (errs[0] <= RESIZE_CONV_TOL and all(e <= RESIZE_CONV_GRAD_TOL for e in errs[1:])
          and counts["resize_conv"] > 0)
    log(f"[probes] ResizeConvFn {n}x{h}x{w}x{c} -> {oh}x{ow}x128 forward and backward vs autograd "
        f"through resize_conv_plain: rel err out/dx/dw/db " + "/".join(f"{e:.3e}" for e in errs)
        + f" (tol {RESIZE_CONV_TOL} / {RESIZE_CONV_GRAD_TOL}); two plain runs differ by "
        + "/".join(f"{e:.3e}" for e in spread) + f"; forward+backward {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms ({smi}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("ResizeConvFn disagrees with autograd through the plain chain")
    del x, wc, bc, got, want, again
    torch.cuda.empty_cache()
    log(f"[probes] launches: {counts}")
    return counts


def noise_weights(module, seed: int, device=None) -> None:
    """Seeded noise on every parameter (weights ~ N(0, 1/fan_in), norm
    scales ~ 1 + N(0, 0.1²), the rest ~ N(0, 0.1²)), so that no motion
    module is the identity that its zero proj_out would make it.  Drawn on
    the CPU, or on ``device`` (seconds faster for a model on the card;
    other values than the CPU's)."""
    import torch

    g = torch.Generator(device=device or "cpu").manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            n = torch.randn(p.shape, generator=g, device=device or "cpu")
            if p.dim() >= 2:
                val = n / float(p[0].numel()) ** 0.5
            elif name.endswith("weight") or name.endswith("gamma"):
                val = 1 + 0.1 * n
            else:
                val = 0.1 * n
            p.copy_(val)


def write_noised_pth(encoder: str, path: str, device: str = "cpu") -> None:
    """A ``.pth`` of the model's seeded parameters under ``noise_weights``,
    in the fp32 that the module holds (what ``run --checkpoint`` and
    ``train --init_checkpoint`` load)."""
    import torch

    from video_depth_anything_torch.io.checkpoint import save_pth
    from video_depth_anything_torch.models.vda import VDAModel

    model = VDAModel(encoder, device=device, dtype=torch.float32)
    noise_weights(model.module, seed=1, device=device)
    save_pth(path, model.module.state_dict())


WINDOW_TOL = 5e-2  # relative to max|plain|: bf16 rounding differs at every
# fused epilogue and attention through 12 (vits) or 24 (vitl) ViT blocks and
# 4 motion modules
ROUNDING_FACTOR = 1.5  # A model whose plain bf16 path lies farther than
# WINDOW_TOL / 1.5 from the same path with fp32 activations (on an H100, vitb
# with these noised weights: 5.3e-2-5.9e-2) is held to 1.5 times that
# distance: two bf16 evaluations that round at different points differ by
# about as much as either differs from fp32 (0.82-1.02 times on the H100,
# over vits, vitb and vitl at both sizes).  Below that the fixed tolerance
# holds, so vits and vitl keep WINDOW_TOL.


@contextlib.contextmanager
def fp32_plain(model):
    """The plain path with fp32 activations on the card (the weights are
    fp32 already; TF32 off in convolutions as in matrix products): the
    yardstick of a model's own bf16 rounding."""
    import torch

    from video_depth_anything_torch.ops.dispatch import plain_reference

    prev = model.dtype, torch.backends.cudnn.allow_tf32
    model.dtype, torch.backends.cudnn.allow_tf32 = torch.float32, False
    try:
        with plain_reference():
            yield
    finally:
        model.dtype, torch.backends.cudnn.allow_tf32 = prev


def rounding_tol(fixed: float, plain, fp32) -> tuple:
    """``(tolerance, rel distance of the plain bf16 output from its fp32
    evaluation)``: the larger of ``fixed`` and ROUNDING_FACTOR times that
    distance.  Tensors or numpy arrays."""
    noise = float(abs(plain - fp32).max() / abs(fp32).max())
    return max(fixed, ROUNDING_FACTOR * noise), noise

# Kernels each window must launch (count > 0) and must not launch (count 0),
# from the port's gates (tests/test_torch_dispatch.py holds them to JAX's);
# inference never runs the backward.  vitb's plans also fix the counts of
# one window: at 518x518 Kernel C once (m3) and Kernel B twice (m2's two
# attentions, d = 16); at 518x924 Kernel C three times (m0 at C = 384, m2
# and m3 at C = 128).
WINDOW_PLANS = {
    ("vits", 518, 518): (("flash_attention", "temporal_attention", "fused_motion_module"),
                         ("output_tail", "flash_attention_bwd", "flash_attention_fast")),
    ("vits", 518, 924): (("flash_attention", "fused_motion_module"),
                         ("output_tail", "flash_attention_bwd", "flash_attention_fast")),
    ("vitl", 518, 518): (("flash_attention", "fused_motion_module", "output_tail"),
                         ("flash_attention_bwd", "flash_attention_fast")),
    ("vitl", 518, 924): (("flash_attention", "fused_motion_module"),
                         ("output_tail", "flash_attention_bwd", "flash_attention_fast")),
    ("vitb", 518, 518): (dict(flash_attention=12, temporal_attention=2, fused_motion_module=1),
                         ("output_tail", "flash_attention_bwd", "flash_attention_fast")),
    ("vitb", 518, 924): (dict(flash_attention=12, fused_motion_module=3),
                         ("temporal_attention", "output_tail", "flash_attention_bwd",
                          "flash_attention_fast")),
}
# Under --attn_impl pallas (vits and vitl at 518x518) Kernel B also takes
# the modules whose head width auto leaves to the plain path: exact Kernel B
# launches of one window by head width d (two attentions a module: vits m0
# d = 24, m1 48, m2 8; vitl m0 and m1 d = 128, m2 32), Kernel C at m3 once.
PALLAS_WINDOW_PLANS = {
    "vits": (dict(flash_attention=12, temporal_attention=6, fused_motion_module=1),
             {24: 2, 48: 2, 8: 2}, ("output_tail", "flash_attention_bwd", "flash_attention_fast")),
    "vitl": (dict(flash_attention=24, temporal_attention=6, fused_motion_module=1, output_tail=1),
             {128: 4, 32: 2}, ("flash_attention_bwd", "flash_attention_fast")),
}
# window batch of the timed calls: the pipeline's default
WINDOW_BATCH = {"vits": 4, "vitb": 4, "vitl": 1}
# under --attn_impl auto:fast every ViT block takes Kernel A's fast variant
FAST_WINDOW_PLAN = (("flash_attention_fast", "fused_motion_module"),
                    ("flash_attention", "output_tail", "flash_attention_bwd"))


def check_window(model, x, label: str, needed, absent, widths=None) -> None:
    """One window on the kernel path against the plain path: relative max
    error, finite output and the launch plan (``needed`` names kernels
    that must launch, or maps them to their exact count; ``widths`` maps
    Kernel B's head widths to their exact launch counts)."""
    import torch

    from video_depth_anything_torch.ops.dispatch import plain_reference
    from video_depth_anything_torch.ops.temporal_attention import temporal_attention

    zero_counts()
    got = model.infer_window(x)
    torch.cuda.synchronize()
    counts = launch_counts()
    by_width = dict(temporal_attention.width_launches)
    torch.cuda.reset_peak_memory_stats()
    with plain_reference():
        want = model.infer_window(x)
    torch.cuda.synchronize()
    plain_peak = torch.cuda.max_memory_allocated() / 2**30
    with fp32_plain(model):
        ref32 = model.infer_window(x)
    tol, noise = rounding_tol(WINDOW_TOL, want, ref32)
    ref = want.float()
    rel = float((got.float() - ref).abs().max() / ref.abs().max())
    finite = bool(torch.isfinite(got).all())
    log(f"[window] {label}: rel err kernels vs plain {rel:.3e} (tol {tol:.3e}: plain bf16 vs "
        f"fp32 activations {noise:.3e}), finite={finite}, launches {counts}, Kernel B by head "
        f"width {by_width}, plain reference peak device memory {plain_peak:.2f} GiB")
    exact = needed if isinstance(needed, dict) else {}
    if (not finite or not rel <= tol or any(counts[k] == 0 for k in needed)
            or any(counts[k] != n for k, n in exact.items())
            or any(counts[k] != 0 for k in absent)
            or (widths is not None and by_width != widths)):
        raise SystemExit(f"window {label} failed")


def time_window(model, xb, label: str, smi: str) -> None:
    import torch

    model.infer_window(xb)
    torch.cuda.synchronize()
    iters = 1  # one timed call after the warm one: the script's time limit
    t0 = time.perf_counter()
    for _ in range(iters):
        model.infer_window(xb)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    log(f"[window] {label} window_batch {len(xb)}: {dt * 1e3:.2f} ms per call, "
        f"{len(xb) * 32 / dt:.1f} frames/s ({smi})")


def phase_window(dev, smi: str):
    import torch

    from video_depth_anything_torch.models.vda import VDAModel
    from video_depth_anything_torch.ops.dispatch import plain_reference

    g = torch.Generator(device=dev).manual_seed(2)
    for encoder, wb in WINDOW_BATCH.items():
        model = VDAModel(encoder, device=dev)
        noise_weights(model.module, seed=1, device=dev)
        for (enc, h, w), (needed, absent) in WINDOW_PLANS.items():
            if enc != encoder:
                continue
            x = torch.randn(1, 32, h, w, 3, device=dev, generator=g)
            check_window(model, x, f"{encoder} 1x32x{h}x{w}", needed, absent)
            xb = torch.randn(wb, 32, h, w, 3, device=dev, generator=g)
            time_window(model, xb, f"{encoder} {h}x{w}", smi)
            if encoder in PALLAS_WINDOW_PLANS and (h, w) == (518, 518):
                pal = VDAModel(encoder, device=dev, attn_impl="pallas")
                pal.module.load_state_dict(model.module.state_dict())
                needed_p, widths, absent_p = PALLAS_WINDOW_PLANS[encoder]
                check_window(pal, x, f"{encoder} 1x32x{h}x{w} pallas", needed_p, absent_p, widths)
                time_window(pal, xb, f"{encoder} {h}x{w} pallas", smi)
                del pal
            if (encoder, h, w) == ("vits", 518, 924):
                fast = VDAModel(encoder, device=dev, attn_impl="auto:fast")
                fast.module.load_state_dict(model.module.state_dict())
                check_window(fast, x, f"vits 1x32x{h}x{w} auto:fast", *FAST_WINDOW_PLAN)
                time_window(fast, xb, f"vits {h}x{w} auto:fast", smi)
                del fast
            with plain_reference():
                model.infer_window(xb[:1])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.infer_window(xb[:1])
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            log(f"[window] {encoder} {h}x{w} plain path, window_batch 1: {dt * 1e3:.2f} ms per "
                f"call, {32 / dt:.1f} frames/s ({smi})")
            del xb
        del model
        torch.cuda.empty_cache()


# VDA_FUSED_MOTION=1 (JAX models/temporal.py:400-422): every motion module
# that the gate's other terms admit takes Kernel C, so one window of vitb
# runs it at C = 384 (m0), 128 (m2, m3) and, on the wide chain, 768 (m1);
# one of vitl at 256 (m2, m3) and, wide, 1024 (m0, m1).  Kernel B never
# runs (every module is fused).  Exact launches of one window; every other
# count 0.
SWITCH_PLANS = {
    ("vitb", 518, 518): dict(flash_attention=12, fused_motion_module=3, fused_motion_module_wide=1),
    ("vitb", 518, 924): dict(flash_attention=12, fused_motion_module=3, fused_motion_module_wide=1),
    ("vitl", 518, 518): dict(flash_attention=24, fused_motion_module=2, fused_motion_module_wide=2,
                             output_tail=1),
    ("vitl", 518, 924): dict(flash_attention=24, fused_motion_module=2, fused_motion_module_wide=2),
}
SWITCH_F32_PLAN = dict(flash_attention_f32=24, fused_motion_module_f32=2,
                       fused_motion_module_wide_f32=2)  # vitl --fp32 518x518


@contextlib.contextmanager
def fused_switch(mode: str = "1"):
    """``VDA_FUSED_MOTION=mode`` in this process and the processes it starts."""
    prev = os.environ.get("VDA_FUSED_MOTION")
    os.environ["VDA_FUSED_MOTION"] = mode
    try:
        yield
    finally:
        if prev is None:
            del os.environ["VDA_FUSED_MOTION"]
        else:
            os.environ["VDA_FUSED_MOTION"] = prev


def phase_fused_switch(dev, smi: str) -> dict:
    """Under ``VDA_FUSED_MOTION=1``: vitb and vitl windows (noised seeded
    weights) at 518x518 and 518x924, kernel path against plain path within
    WINDOW_TOL (``rounding_tol``), with the exact launch plans of
    SWITCH_PLANS (Kernel C's wide chain once a vitb window at C = 768, twice
    a vitl window at 1024); ms of a window at the pipeline's window batch
    with the switch and without it, in turns (on, off, off, on); a vitl
    --fp32 518x518 window within F32_WINDOW_TOL (TF32 off; SWITCH_F32_PLAN);
    ``python -m video_depth_anything_torch.run --encoder vitl`` on a
    76-frame 480x480 clip (a subprocess, its printed launches: both wide
    widths run).  Returns the launches of the main-path runs (the windows
    and the CLI run; counts zeroed before each, read after)."""
    import numpy as np
    import torch

    from video_depth_anything_torch.models.vda import VDAModel
    from video_depth_anything_torch.ops.dispatch import plain_reference

    totals = dict.fromkeys(launch_counts(), 0)
    g = torch.Generator(device=dev).manual_seed(7)
    for encoder in ("vitb", "vitl"):
        model = VDAModel(encoder, device=dev)
        noise_weights(model.module, seed=1, device=dev)
        for (enc, h, w), plan in SWITCH_PLANS.items():
            if enc != encoder:
                continue
            x = torch.randn(1, 32, h, w, 3, device=dev, generator=g)
            absent = tuple(k for k in totals if k not in plan)
            with fused_switch():
                check_window(model, x, f"{encoder} 1x32x{h}x{w} VDA_FUSED_MOTION=1", plan, absent)
            counts = launch_counts()
            totals = {k: totals[k] + counts[k] for k in totals}
            xb = torch.randn(WINDOW_BATCH[encoder], 32, h, w, 3, device=dev, generator=g)
            for mode in ("1", "auto", "auto", "1"):
                with fused_switch(mode):
                    time_window(model, xb, f"{encoder} {h}x{w} VDA_FUSED_MOTION={mode}", smi)
            del x, xb
        if encoder == "vitl":
            prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
            try:
                m32 = VDAModel(encoder, device=dev, dtype=torch.float32)
                m32.module.load_state_dict(model.module.state_dict())
                del model
                torch.cuda.empty_cache()
                x = torch.randn(1, 32, 518, 518, 3, device=dev, generator=g)
                with fused_switch():
                    zero_counts()
                    got = m32.infer_window(x)
                    torch.cuda.synchronize()
                    counts = launch_counts()
                    with plain_reference():
                        want = m32.infer_window(x)
                rel = float((got - want).abs().max() / want.abs().max())
                finite = bool(torch.isfinite(got).all())
                ok = (finite and rel <= F32_WINDOW_TOL
                      and all(counts[k] == SWITCH_F32_PLAN.get(k, 0) for k in counts))
                log(f"[fused_switch] window vitl 1x32x518x518 fp32 VDA_FUSED_MOTION=1: rel err "
                    f"kernels vs plain {rel:.3e} (tol {F32_WINDOW_TOL}), finite={finite}, "
                    f"launches {counts} ({smi}) {'OK' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit("fp32 window of vitl under VDA_FUSED_MOTION=1 failed")
                totals = {k: totals[k] + counts[k] for k in totals}
                del m32, x, got, want
            finally:
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
        else:
            del model
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp, fused_switch():
        clip = os.path.join(tmp, "square.mp4")
        write_clip(clip, 480, 480)
        out = launch([[sys.executable, "-m", "video_depth_anything_torch.run", "--input_video",
                       clip, "--output_dir", tmp, "--encoder", "vitl", "--random_init",
                       "--save_npz"]], "run --encoder vitl VDA_FUSED_MOTION=1", timeout=300.0,
                     tag="fused_switch")[0]
        line = next((ln for ln in out.splitlines() if ln.startswith("kernel launches: ")), None)
        counts = json.loads(line[len("kernel launches: "):]) if line else {}
        depth = np.load(os.path.join(tmp, "square_depth.npz"))["depth"]
        finite = bool(np.isfinite(depth).all())
        ok = (depth.shape == (76, 480, 480) and finite and counts.get("fused_motion_module_wide", 0) > 0
              and counts.get("fused_motion_module", 0) > 0 and counts.get("temporal_attention", 1) == 0)
        log(f"[fused_switch] cli vitl 480x480 VDA_FUSED_MOTION=1: depth {depth.shape} "
            f"finite={finite} launches {counts} {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("run --encoder vitl under VDA_FUSED_MOTION=1 failed")
        totals = {k: totals[k] + counts.get(k, 0) for k in totals}
    log(f"[fused_switch] launches over the main path: {totals} ({smi})")
    return totals


# -- phase domain: every shape the JAX gates admit -----------------------------

# (c)'s op-level sweeps: one 32-frame window (B = 1) at 74² locations, 19²
# at C >= 640 (vitl m1's count: a 74² module that wide would hold 1.4 GB a
# tensor in fp32 for nothing the kernels' plans can see).
DOMAIN_S, DOMAIN_S_WIDE = 74 * 74, 19 * 19
DOMAIN_B_HEADS = (4, 8, 16)  # Kernel B: every width the gate admits at these heads
# Kernel C off the shipped config: (heads, attention blocks, ff_mult) at
# DOMAIN_C_WIDTHS where the gate admits them; at 8 heads, 2 blocks and
# ff_mult 4 every width it admits, forced
DOMAIN_C_CFGS = ((4, 2, 4), (16, 2, 4), (8, 1, 4), (8, 3, 4), (8, 2, 2))
DOMAIN_C_WIDTHS = (64, 96, 320, 512)
# PERF.md section 6's times of the kernels whose domains did not change (ms,
# NVIDIA H100 80GB HBM3, 700 W: rows 6-8, from chip_smoke.py and
# bench_temporal), re-timed by phase domain beside them
PERF_MS = {
    ("temporal_attention", "vits m0 518x518"): 0.0340,
    ("temporal_attention", "vits m2 518x518"): 0.0180,
    ("temporal_attention", "vitb m2 518x518"): 0.0242,
    ("temporal_attention", "vits m1 518x518"): 0.0184,
    ("temporal_attention", "vitb m0 518x518"): 0.0571,
    ("temporal_attention", "vitl m2 518x518"): 0.0385,
    ("temporal_attention", "vitl m0 518x518"): 0.1302,
    ("temporal_attention", "vitl m0 518x924"): 0.2291,
    ("motion_module", "m3 518x518"): 0.3154, ("motion_module", "m0 518x924"): 0.6453,
    ("motion_module", "m2 518x924"): 0.1484, ("motion_module", "m3 518x924"): 0.5386,
    ("motion_module", "vitl m3 518x518"): 2.4085,
    ("motion_module", "vitl m2 518x924"): 1.1495,
    ("motion_module", "vitl m3 518x924"): 4.1916,
    ("motion_module", "vitb m3 518x518"): 0.8214,
    ("motion_module", "vitb m0 518x924"): 3.2675,
    # the wide chain (bench_motion_tail --wide, in turns with the chain it replaced)
    ("motion_module_wide", "vitb m1 518x518"): 0.7836,
    ("motion_module_wide", "vitb m1 518x924"): 1.1948,
    ("motion_module_wide", "vitl m0 518x518"): 3.7717,
    ("motion_module_wide", "vitl m0 518x924"): 6.9746,
    ("motion_module_wide", "vitl m1 518x518"): 1.0900,
    ("motion_module_wide", "vitl m1 518x924"): 1.8020,
    ("output_tail", "vitl 518x518"): 2.7828,
    # Kernel A's Hopper kernels (rows 1 and 4)
    ("flash_attention", "vits 518x518"): 0.2680,
    ("flash_attention", "synthetic D=192"): 0.1992,
}
# (a) and (b): the windows of phase domain, vits (and vitb) 518x518 at the
# pipeline's window batch of 4 with noised weights, and their exact launches
# a call (tests/test_torch_dispatch.py holds these plans to the JAX gates);
# every other count 0.  Kernel B's launches by head width, the tail's by C.
DOMAIN_WINDOWS = (
    # (a) packed_output_stack=False: the tail kernel at vits' C = 32, vitb's 64
    ("unpacked", "vits", "auto", "auto",
     dict(flash_attention=12, temporal_attention=4, fused_motion_module=1, output_tail=1),
     {24: 2, 8: 2}, {32: 1}),
    ("unpacked", "vitb", "auto", "auto",
     dict(flash_attention=12, temporal_attention=2, fused_motion_module=1, output_tail=1),
     {16: 2}, {64: 1}),
    # (b) 4 heads, one attention block: Kernel B at d = 16 (m2), the wide
    # chain at 4 heads (m3); under pallas Kernel B also at d = 48 (m0) and,
    # the run-time-d kernel, 96 (m1); under the switch Kernel C everywhere
    ("kv_motion", "vits", "auto", "auto",
     dict(flash_attention=12, temporal_attention=1, fused_motion_module_wide=1), {16: 1}, {}),
    ("kv_motion", "vits", "pallas", "auto",
     dict(flash_attention=12, temporal_attention=2, temporal_attention_any=1,
          fused_motion_module_wide=1), {48: 1, 96: 1, 16: 1}, {}),
    ("kv_motion", "vits", "auto", "1", dict(flash_attention=12, fused_motion_module_wide=4),
     {}, {}),
)
# (b) in fp32 under pallas, B = 1 (the fp32 kernels' main path here)
DOMAIN_F32_PLAN = dict(flash_attention_f32=12, temporal_attention_f32=2,
                       temporal_attention_any_f32=1, fused_motion_module_wide_f32=1)


def domain_model_config(name: str, encoder: str):
    """The port's config of (a) ``"unpacked"`` or (b) ``"kv_motion"``."""
    import dataclasses

    from video_depth_anything_torch.config import MotionModuleConfig, get_model_config

    cfg = get_model_config(encoder)
    if name == "unpacked":
        return dataclasses.replace(cfg, packed_output_stack=False)
    return dataclasses.replace(cfg, motion=MotionModuleConfig(num_heads=4, num_attention_blocks=1))


def domain_b_shapes() -> list:
    """(C, heads) of (c)'s Kernel B sweep: every width, a multiple of 8 up to
    2048, that the gate admits under ``pallas`` (a superset of ``auto``'s)."""
    from video_depth_anything_torch.ops import temporal_attention as ta

    return [(c, h) for h in DOMAIN_B_HEADS for c in range(8, 2049, 8)
            if ta.temporal_gate((1, 32, DOMAIN_S, c), h, auto=False)]


def domain_c_shapes() -> list:
    """(C, heads, blocks, ff_mult) of (c)'s Kernel C sweep, each admitted by
    the gate forced (``VDA_FUSED_MOTION=1``)."""
    from video_depth_anything_torch.config import MotionModuleConfig
    from video_depth_anything_torch.ops import motion_module as mm

    out = [(c, 8, 2, 4) for c in range(8, 2049, 8)
           if mm.motion_gate(MotionModuleConfig(), c, c, 32, 74, 74, force=True)]
    for heads, blocks, ff in DOMAIN_C_CFGS:
        cfg = MotionModuleConfig(num_heads=heads, num_attention_blocks=blocks, ff_mult=ff)
        out += [(c, heads, blocks, ff) for c in DOMAIN_C_WIDTHS
                if mm.motion_gate(cfg, c, c, 32, 74, 74, force=True)]
    return out


def last_box_plain(q, k, v, heads: int, scale: float, w: int):
    """The fp32 run-time-d kernel with the last box of each one-head tile's
    row never loaded (read as zeros): every column from the last box's
    first, ``w · (nb - 1)``, zero in q, k and v; plain PyTorch."""
    from video_depth_anything_torch.ops import temporal_attention as ta

    d = q.shape[-1] // heads
    nb = -(-d // w)
    cut = [x.clone() for x in (q, k, v)]
    for x in cut:
        x.view(*x.shape[:3], heads, d)[..., w * (nb - 1):] = 0
    return ta.temporal_attention_plain(*cut, heads, scale)


def temporal_bound(c: int, heads: int, s: int, itemsize: int, f32: bool) -> tuple:
    """Kernel B's bound on a 1×32×S×C window: the largest of the FLOPs (bf16
    tensor cores, or fp32 CUDA cores), the bytes, and the softmax's
    S·heads·32² exponentials on the SFU (bench_temporal.sfu_ms); ``bound_by``
    "operations" where the FLOPs or the exponentials bind."""
    from video_depth_anything_torch import bench_temporal

    flops, nbytes = 4.0 * s * c * 32 * 32, 4.0 * 32 * s * c * itemsize
    b_ms, b_by = (bound_f32 if f32 else bound)(flops, nbytes)
    exp_ms = bench_temporal.sfu_ms(1, s, heads, 32)
    return (exp_ms, "operations") if exp_ms > b_ms else (b_ms, b_by)


def domain_temporal_row(c: int, heads: int, dtype, seed: int, dev, s: int = 0,
                        label: str = "") -> dict:
    """Kernel B at (C, heads) on a 32-frame window of ``s`` locations (0:
    DOMAIN_S, or DOMAIN_S_WIDE at C >= 640) against its plain version, with
    the mutants (uniform attention, the last location tile never stored, off
    the instantiated widths and at several heads d rounded up to the next of
    them, and where the
    fp32 kernel reads a row in several boxes the last box never loaded),
    device ms over inputs rotated past the L2, plain and SDPA ms, and the
    bound (``temporal_bound``: bytes, FLOPs or the softmax's exponentials)."""
    import torch
    import torch.nn.functional as F

    from video_depth_anything_torch import bench_temporal
    from video_depth_anything_torch.ops import temporal_attention as ta
    from video_depth_anything_torch.utils.device import graph_ms

    s = s or (DOMAIN_S if c < 640 else DOMAIN_S_WIDE)
    f32 = dtype == torch.float32
    copies = bench_temporal.inputs(1, 32, s, c, seed, dev)
    if f32:
        copies = [tuple(x.float() for x in cp) for cp in copies]
    q, k, v = copies[0]
    d = c // heads
    scale = d**-0.5
    got = ta.temporal_attention(q, k, v, heads, scale)
    want = ta.temporal_attention_plain(q, k, v, heads, scale)
    uniform = v.float().mean(1, keepdim=True).expand(v.shape)
    locs = ta.tile_plan(c, heads, q.element_size())[0]
    dropped = want.clone()
    dropped[:, :, (s - 1) // locs * locs:] = 0
    mutants = {"uniform": rel_err(uniform, want), "last_location_tile_dropped": rel_err(dropped, want)}
    # (at one head the rounded width reads zeros past C: no wrong kernel)
    if not ta.instantiated(c, heads) and d < 128 and heads > 1:
        mutants["d_rounded_up"] = rel_err(rounded_width_plain(q, k, v, heads, scale), want)
    extra = ""
    if f32 and not ta.instantiated(c, heads):
        plan = ta.any_f32_plan(q.shape, heads)
        if plan["nb"] > 1:
            mutants["last_box_dropped"] = rel_err(last_box_plain(q, k, v, heads, scale, plan["w"]),
                                                  want)
        extra = (f" loader={plan['loader']} boxes={plan['nb']}x{plan['bw']} class={plan['kind']}"
                 f" {'tensor' if plan['split'] else 'tile'} slots={plan['slots']} warps={plan['nw']}")
    ms = graph_ms([lambda x=x: ta.temporal_attention(*x, heads, scale) for x in copies], reps=10)
    plain_ms = graph_ms([lambda: ta.temporal_attention_plain(q, k, v, heads, scale)], reps=3)
    q5, k5, v5 = (x.view(1, 32, s, heads, d).permute(0, 2, 3, 1, 4) for x in (q, k, v))
    lib_ms = graph_ms([lambda: F.scaled_dot_product_attention(q5, k5, v5, scale=scale)], reps=5)
    b_ms, b_by = temporal_bound(c, heads, s, q.element_size(), f32)
    name = ("temporal_attention" if ta.instantiated(c, heads) else "temporal_attention_any") + \
        ("_f32" if f32 else "")
    row = dict(kernel=name, shape=f"{label or 'domain'} (B=1, T=32, S={s}, C={c}, heads={heads}, "
               f"d={d})", max_abs_err=max_err(got, want), rel_err=rel_err(got, want),
               tol=F32_TOL if f32 else ATTN_TOL, mutants=mutants, ms=ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
               extra=f" ms/bound_ms={ms / b_ms:.2f}{extra}")
    if (name, label) in PERF_MS:
        row["extra"] += f" perf_md_ms={PERF_MS[(name, label)]:.4f}"
    return row


# fp32 rows of the run-time-d kernel beyond the sweep's heads: (C, heads, S,
# label): one head of 320 and of 512 and two of 256 (a row in two or three
# TMA boxes, two or three slots), and C = 6 at one head on 19² locations (S·C·4
# bytes not a multiple of 16: the cp.async loader)
DOMAIN_F32_EXTRA = ((320, 1, DOMAIN_S, "one head of 320"), (512, 1, DOMAIN_S, "one head of 512"),
                    (512, 2, DOMAIN_S, "two heads of 256"), (6, 1, DOMAIN_S_WIDE, "cp.async C=6"))


def domain_motion_params(c: int, blocks: int, ff: int, seed: int, dev) -> dict:
    """Seeded raw parameters of a motion module of ``blocks`` attention
    blocks and ff·C hidden units, drawn on the card."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    n = lambda *s, std=1.0: torch.randn(*s, generator=g, device=dev) * std  # noqa: E731
    return dict(gn_scale=1 + n(c, std=0.1), gn_bias=n(c, std=0.1), w_in=n(c, c, std=c**-0.5),
                b_in=n(c, std=0.1), ln_scale=1 + n(blocks + 1, c, std=0.1),
                ln_bias=n(blocks + 1, c, std=0.1), wq=n(blocks, c, c, std=c**-0.5),
                wk=n(blocks, c, c, std=c**-0.5), wv=n(blocks, c, c, std=c**-0.5),
                wo=n(blocks, c, c, std=c**-0.5), bo=n(blocks, c, std=0.1),
                w1=n(c, 2 * ff * c, std=c**-0.5), b1=n(2 * ff * c, std=0.1),
                w2=n(ff * c, c, std=(ff * c) ** -0.5), b2=n(c, std=0.1),
                w_out=n(c, c, std=c**-0.5), b_out=n(c, std=0.1))


def domain_motion_row(c: int, heads: int, blocks: int, ff: int, dtype, dev, s: int = 0,
                      label: str = "") -> dict:
    """Kernel C at (C, heads, blocks, ff_mult) on a 32-frame window of ``s``
    locations (0: DOMAIN_S, or DOMAIN_S_WIDE at C >= 640) against its plain
    version (TF32 off in fp32), with the mutants (the last attention block
    dropped; 8 heads whatever the config says, or at 8 heads 4), the launch
    alone timed on prepared weights, plain ms and the tensor-core bound."""
    import math

    import torch

    from video_depth_anything_torch.config import MotionModuleConfig
    from video_depth_anything_torch.ops import motion_module as mm
    from video_depth_anything_torch.utils.device import event_ms as time_ms

    s = s or (DOMAIN_S if c < 640 else DOMAIN_S_WIDE)
    f32 = dtype == torch.float32
    cfg = MotionModuleConfig(num_heads=heads, num_attention_blocks=blocks, ff_mult=ff,
                             norm_num_groups=math.gcd(32, c))
    p = domain_motion_params(c, blocks, ff, c * 7 + heads + blocks + ff, dev)
    x = torch.randn(1, 32, s, c, device=dev, generator=torch.Generator(device=dev).manual_seed(c))
    x = x.to(dtype)
    w = mm.kernel_weights(p, cfg, dtype)
    gna, gnb = mm.gn_fold(x, w, cfg)
    got = mm.motion_module_launch(x, gna, gnb, w, cfg, heads)
    want = mm.motion_module_plain(x, p, cfg, heads)
    base = float((want.float() - x.float()).abs().max())
    short = {**p, "wq": p["wq"][:-1], "wk": p["wk"][:-1], "wv": p["wv"][:-1], "wo": p["wo"][:-1],
             "bo": p["bo"][:-1], "ln_scale": torch.cat([p["ln_scale"][:blocks - 1], p["ln_scale"][-1:]]),
             "ln_bias": torch.cat([p["ln_bias"][:blocks - 1], p["ln_bias"][-1:]])}
    short_cfg = MotionModuleConfig(num_heads=heads, num_attention_blocks=blocks - 1, ff_mult=ff,
                                   norm_num_groups=cfg.norm_num_groups)
    other = 8 if heads != 8 else 4
    mutants = {"last_block_dropped": max_err(mm.motion_module_plain(x, short, short_cfg, heads),
                                             want) / base,
               f"{other}_heads": max_err(mm.motion_module_plain(x, p, cfg, other), want) / base}
    resident = mm.resident(c, heads, cfg)
    if not resident:
        mutants.update(wide_chain_mutant_errors(x, p, cfg, heads, want))
    ms = time_ms(lambda: mm.motion_module_launch(x, gna, gnb, w, cfg, heads), iters=5, warmup=1)
    plain_ms = time_ms(lambda: mm.motion_module_plain(x, p, cfg, heads), iters=3, warmup=1)
    tokens = 32.0 * s
    flops = tokens * ((2 + 4 * blocks) * c * c + 6 * ff * c * c + 4 * blocks * 32 * c)
    if f32:
        b_ms, b_by = 3 * flops / PEAK_TF32 * 1e3, "operations"  # 3xTF32 on the tensor cores
    else:
        b_ms, b_by = bound(flops, 2 * tokens * c * 2 + w["w"].numel() * 2)
    name = ("motion_module" if resident else "motion_module_wide") + ("_f32" if f32 else "")
    row = dict(kernel=name, shape=f"{label or 'domain'} (B=1, T=32, S={s}, C={c}, heads={heads}, "
               f"blocks={blocks}, ff_mult={ff})", max_abs_err=max_err(got, want),
               rel_err=max_err(got, want) / base, tol=F32_TOL if f32 else MOTION_TOL,
               mutants=mutants, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=None, extra=f" ms/bound_ms={ms / b_ms:.2f}")
    if (name, label) in PERF_MS:
        row["extra"] += f" perf_md_ms={PERF_MS[(name, label)]:.4f}"
    return row


def domain_tail_row(c: int, n: int, h: int, w: int, oh: int, ow: int, g, dev,
                    label: str = "") -> dict:
    """The output tail at width C on ``(n, h, w, C)`` → ``oh x ow`` against
    its plain chain, with the mutants (also the map read at half its
    channels), ms, plain ms and the tensor-core bound."""
    import torch

    from video_depth_anything_torch.ops import output_tail as ot
    from video_depth_anything_torch.utils.device import event_ms as time_ms

    r = lambda *s, std: torch.randn(*s, generator=g, device=dev) * std  # noqa: E731
    x = r(n, h, w, c, std=1.0).to(torch.bfloat16)
    w1, b1, w2, b2 = r(32, c, 3, 3, std=0.1), r(32, std=0.1), r(1, 32, 1, 1, std=0.3), r(1, std=0.1)
    got = ot.output_tail(x, w1, b1, w2, b2, oh, ow)
    want = ot.output_tail_plain(x, w1, b1, w2, b2, oh, ow)
    mutants = tail_mutant_errors(x, w1, b1, w2, b2, oh, ow)
    ms = time_ms(lambda: ot.output_tail(x, w1, b1, w2, b2, oh, ow))
    plain_ms = time_ms(lambda: ot.output_tail_plain(x, w1, b1, w2, b2, oh, ow), iters=5)
    b_ms, b_by = bound(n * oh * ow * (2.0 * 9 * c * 32 + 2.0 * 32),
                       x.numel() * 2 + n * oh * ow * 2 + (9 * c * 32 + 65) * 2)
    row = dict(kernel="output_tail", shape=f"{label} ({n}x{h}x{w}x{c} -> {oh}x{ow})",
               max_abs_err=max_err(got, want), rel_err=rel_err(got, want), tol=TAIL_TOL,
               mutants=mutants, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=None, extra=f" ms/bound_ms={ms / b_ms:.2f}")
    if ("output_tail", label) in PERF_MS:
        row["extra"] += f" perf_md_ms={PERF_MS[('output_tail', label)]:.4f}"
    return row


def domain_rows(dev) -> list:
    """(c) and the re-timed rows: Kernel B at every (C, heads) of
    ``domain_b_shapes``, Kernel C at every config of ``domain_c_shapes``,
    each in bf16 and fp32; the tail at C = 32, 64 and 128; Kernel A at D =
    64 and 192, Kernel B's six instantiated widths, the resident Kernel C
    and the wide chain at C = 768 / 1024 and the C = 128 tail at phase
    kernels' shapes, beside PERF.md's times (PERF_MS)."""
    import torch

    from video_depth_anything_torch import bench_temporal

    rows = []
    g = torch.Generator(device=dev).manual_seed(21)
    for label, n, h, d in (("vits 518x518", 1370, 6, 64), ("synthetic D=192", 1370, 2, 192)):
        row = attention_row("flash_attention", label, 32, n, h, d, g, dev)
        rows.append({**row, "extra": row["extra"] + " perf_md_ms="
                     f"{PERF_MS[('flash_attention', label)]:.4f}"})
    for n_row, (label, b, t, s, c) in enumerate(bench_temporal.SHAPES[:8]):
        rows.append(domain_temporal_row(c, 8, torch.bfloat16, 100 + n_row, dev, s=s, label=label))
    for label, c, s, _ in MOTION_ROWS[:9] + WIDE_MOTION_ROWS:
        rows.append(domain_motion_row(c, 8, 2, 4, torch.bfloat16, dev, s=s, label=label))
    for c in (32, 64, 128):
        label = "vitl 518x518" if c == 128 else f"{'vits' if c == 32 else 'vitb'} 518x518 unpacked"
        rows.append(domain_tail_row(c, 32, 296, 296, 518, 518, g, dev, label=label))
    rows.append(domain_tail_row(32, 4, 10, 24, 18, 42, g, dev, label="ragged"))
    with no_tf32():
        for dtype in (torch.bfloat16, torch.float32):
            for n_row, (c, heads) in enumerate(domain_b_shapes()):
                rows.append(domain_temporal_row(c, heads, dtype, 300 + n_row, dev))
            if dtype == torch.float32:
                for n_row, (c, heads, s, label) in enumerate(DOMAIN_F32_EXTRA):
                    rows.append(domain_temporal_row(c, heads, dtype, 400 + n_row, dev, s=s,
                                                    label=label))
            for c, heads, blocks, ff in domain_c_shapes():
                rows.append(domain_motion_row(c, heads, blocks, ff, dtype, dev))
            torch.cuda.empty_cache()
    return rows


def phase_domain(dev, smi: str) -> tuple:
    """(a) vits and vitb 518x518 windows with ``packed_output_stack=False``,
    (b) vits 518x518 windows with 4 heads and one attention block under
    ``auto``, ``pallas`` and ``VDA_FUSED_MOTION=1`` (and fp32 under
    ``pallas``), noised weights, at the window batch of 4: kernel path
    against plain path within ``rounding_tol`` (fp32: F32_WINDOW_TOL, TF32
    off) with the exact launches of DOMAIN_WINDOWS, Kernel B's by head
    width and the tail's by C; (a) timed against the shipped config (the
    tail's plain chain) in turns.  Then (c), ``domain_rows``.  Returns the
    main-path launches (the windows) and the rows."""
    import torch

    from video_depth_anything_torch.models.vda import VDAModel
    from video_depth_anything_torch.ops.dispatch import plain_reference
    from video_depth_anything_torch.ops.output_tail import output_tail

    totals = dict.fromkeys(launch_counts(), 0)
    g = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn(WINDOW_BATCH["vits"], 32, 518, 518, 3, device=dev, generator=g)
    for name, encoder, impl, mode, plan, widths, tails in DOMAIN_WINDOWS:
        model = VDAModel(cfg=domain_model_config(name, encoder), device=dev, attn_impl=impl)
        noise_weights(model.module, seed=1, device=dev)
        label = f"{name} {encoder} 4x32x518x518 {impl} VDA_FUSED_MOTION={mode}"
        with fused_switch(mode):
            check_window(model, x, label, plan, tuple(k for k in totals if k not in plan), widths)
            counts = launch_counts()
            if output_tail.width_launches != tails:
                raise SystemExit(f"window {label}: tail launches by C {output_tail.width_launches}, "
                                 f"want {tails}")
            totals = {k: totals[k] + counts[k] for k in totals}
            if name == "unpacked":  # the tail kernel against the shipped config's plain tail
                shipped = VDAModel(encoder, device=dev)
                shipped.module.load_state_dict(model.module.state_dict())
                for m, tag in ((model, "unpacked"), (shipped, "shipped"), (shipped, "shipped"),
                               (model, "unpacked")):
                    time_window(m, x, f"domain {encoder} 518x518 {tag}", smi)
                del shipped
        del model
        torch.cuda.empty_cache()
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        m32 = VDAModel(cfg=domain_model_config("kv_motion", "vits"), device=dev,
                       dtype=torch.float32, attn_impl="pallas")
        noise_weights(m32.module, seed=1, device=dev)
        zero_counts()
        got = m32.infer_window(x[:1])
        torch.cuda.synchronize()
        counts = launch_counts()
        with plain_reference():
            want = m32.infer_window(x[:1])
        rel = float((got - want).abs().max() / want.abs().max())
        finite = bool(torch.isfinite(got).all())
        ok = (finite and rel <= F32_WINDOW_TOL
              and all(counts[k] == DOMAIN_F32_PLAN.get(k, 0) for k in counts))
        log(f"[domain] window kv_motion vits 1x32x518x518 fp32 pallas: rel err kernels vs plain "
            f"{rel:.3e} (tol {F32_WINDOW_TOL}), finite={finite}, launches {counts} ({smi}) "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("fp32 window of the 4-head, one-block config failed")
        totals = {k: totals[k] + counts[k] for k in totals}
        del m32, got, want
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    del x
    torch.cuda.empty_cache()
    log(f"[domain] launches over the main path: {totals} ({smi})")
    rows = domain_rows(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    check_rows(rows, "domain")
    return totals, rows


# Kernel A at D >= 320 (csrc/flash_attention_wide.cu), phase wide.  The d320
# configuration: ViT-H/14's width, 1280, in 4 heads of 320 (a head count that
# puts D in that domain; no released checkpoint has such heads), 24 blocks,
# with vitl's DPT head and motion modules, so that Kernels B, C and the tail
# take vitl's plan unchanged and only Kernel A's 24 launches a window are new.
D320_VIT = dict(embed_dim=1280, depth=24, num_heads=4)
D320_GRAD_DEPTH = 4  # the gradient check's encoder depth
# The d320 windows (one 32-frame window, noised weights) and their exact
# launches a call, every other count 0, with Kernel B's by head width
# (tests/test_torch_dispatch.py holds these plans to the JAX gates): vitl's
# head plan, Kernel A on the wide kernel in every block.
WIDE_WINDOWS = {
    (518, 518, "auto"): (dict(flash_attention_wide=24, fused_motion_module=1, output_tail=1), {}),
    (518, 518, "auto:fast"): (dict(flash_attention_wide=24, fused_motion_module=1, output_tail=1),
                              {}),
    (518, 518, "pallas"): (dict(flash_attention_wide=24, temporal_attention=6,
                                fused_motion_module=1, output_tail=1), {128: 4, 32: 2}),
    (518, 924, "auto"): (dict(flash_attention_wide=24, fused_motion_module=2), {}),
    (518, 924, "auto:fast"): (dict(flash_attention_wide=24, fused_motion_module=2), {}),
    (518, 924, "pallas"): (dict(flash_attention_wide=24, temporal_attention=4,
                                fused_motion_module=2), {128: 4}),
}
WIDE_F32_PLAN = dict(flash_attention_wide_f32=24, fused_motion_module_f32=1)  # fp32, 518x518 auto
# The wide kernel alone: the d320 windows' shapes (B*T, N, H), then at every
# D = 64 (mod 128) from 320 to 1984 at one frame of 3 heads and 32 frames of
# 2, ragged N (26 and 44 keys in the last 64-key tile)
WIDE_ROWS = (("d320 518x518", 32, 1370, 4), ("d320 518x924", 32, 2443, 4))
WIDE_SWEEP_D = tuple(range(320, 1985, 128))
WIDE_SWEEP_SHAPES = ((1, 1370, 3), (32, 300, 2))


def d320_config(depth: int = 24):
    """The port's d320 ``ModelConfig``; ``depth`` blocks, taps spread over them."""
    import dataclasses

    from video_depth_anything_torch.config import ViTConfig, get_model_config

    taps = (4, 11, 17, 23) if depth == 24 else tuple(round(i * (depth - 1) / 3) for i in range(4))
    vit = ViTConfig(**dict(D320_VIT, depth=depth))
    return dataclasses.replace(get_model_config("vitl"), encoder="d320", vit=vit,
                               intermediate_layer_idx=taps)


def wide_mutant_errors(plain, q, k, v, qf, scale, f32: bool = False) -> dict:
    """How far the wide kernel's wrong plans miss the plain version,
    relative to max|plain|: the consumer storing its 320-column slice's
    panel t at panel t + 1 (mod 5); S summed without the last 64 columns;
    the zero-filled pad keys of the ragged last key tile (64 keys in bf16,
    32 in fp32) counted in the softmax (on the flat inputs ``qf``); in fp32
    also Vᵀ's keys left in order under P's permuted ones (key 2j at
    position j < 4 of each 8, 2(j − 4) + 1 after)."""
    import torch
    import torch.nn.functional as F

    from video_depth_anything_torch.ops.flash_attention import WIDE_PANEL, WIDE_SLICE

    want = plain(q, k, v, scale)
    n, d = q.shape[1], q.shape[-1]
    rotated = want.clone()
    for sl in range(-(-d // WIDE_SLICE)):
        c0 = min(sl * WIDE_SLICE, d - WIDE_SLICE)
        block = want[..., c0:c0 + WIDE_SLICE].unflatten(-1, (-1, WIDE_PANEL))
        new = max(sl * WIDE_SLICE, c0)  # the columns the slice stores
        rotated[..., new:c0 + WIDE_SLICE] = torch.roll(block, 1, dims=-2).flatten(-2)[
            ..., new - c0:]
    out = {"panels_rotated": rel_err(rotated, want),
           "panel_dropped_from_s": rel_err(plain(q[..., :d - WIDE_PANEL], k[..., :d - WIDE_PANEL],
                                                 v, scale), want),
           "unmasked_zero_pad": zero_pad_error(plain, qf, k, v, scale, 32 if f32 else 64)}
    if f32:  # P at position j is key PERM[j], V at position j key j: V's rows by PERM's inverse
        inv = torch.tensor([0, 4, 1, 5, 2, 6, 3, 7], device=q.device)
        n8 = -(-n // 8) * 8
        order = (torch.arange(n8, device=q.device) // 8 * 8 + inv.repeat(n8 // 8))[:n]
        vp = F.pad(v, (0, 0, 0, 0, 0, n8 - n))[:, order]
        out["v_keys_unpermuted"] = rel_err(plain(q, k, vp, scale), want)
    return out


def sdpa_ms(q, k, v, scale):
    """ms of ``scaled_dot_product_attention`` on ``(B, N, H, D)`` inputs, and
    the backend it picks for them (its flash backend stops at head_dim 256)."""
    import torch
    import torch.nn.functional as F

    from video_depth_anything_torch.utils.device import event_ms as time_ms

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    try:
        backend = torch.nn.attention.SDPBackend(
            torch._fused_sdp_choice(qt, kt, vt, scale=scale)).name.lower()
    except (AttributeError, RuntimeError, ValueError) as e:  # a private call: name what failed
        backend = f"unknown ({type(e).__name__})"
    ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), iters=3,
                 warmup=1)
    return ms, backend


def wide_ptxas(f32: bool, fast: bool) -> str:
    """The registers and spills ptxas gave the wide kernel's entry functions
    of this dtype and variant (Q resident and streamed), from the build
    log."""
    import re

    from video_depth_anything_torch.ops import cuda_build

    log_path = cuda_build.BUILD_DIR / "flash_attention_wide.log"
    text = log_path.read_text() if log_path.exists() else ""
    want = rf"flash_wideI{'f' if f32 else '13__nv_bfloat16'}Lb{int(fast)}ELb([01])E"
    out, name = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = re.search(want, m.group(1))
            spill = None
        elif name and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif name and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{'q-resident' if name.group(1) == '1' else 'q-streamed'} {regs} regs "
                       f"{spill} B spilled")
            name = None
    return "; ".join(sorted(out)) or "not in the build log"


def wide_row(label: str, bt: int, n: int, h: int, d: int, dtype, fast: bool, g, dev) -> dict:
    """The wide kernel at ``(bt, n, h, d)`` against its plain version on
    peaked and flat inputs (bf16: ATTN_TOL; fp32, TF32 off: F32_TOL), with
    wide_mutant_errors (fp32 also one TF32 pass), ms, the dense bound (the
    row's ``bound_ms``) and the bound of the kernel's plan (S once a
    320-column slice), plain ms, SDPA's ms, ratio and backend, and the
    registers and spills of the kernel's entry functions (``wide_ptxas``)."""
    import torch

    from video_depth_anything_torch.ops import flash_attention as fa
    from video_depth_anything_torch.utils.device import event_ms as time_ms

    f32 = dtype == torch.float32
    qkv = (f32_inputs if f32 else attention_inputs)((bt, n, h * d), g, dev)
    q, k, v = (t.view(bt, n, h, d) for t in qkv.split(h * d, dim=-1))
    scale = d**-0.5
    plain = lambda q_, k_, v_, sc: fa.flash_attention_plain(q_, k_, v_, sc, fast=fast)  # noqa: E731
    got = fa.flash_attention(q, k, v, scale, fast=fast)
    want = plain(q, k, v, scale)
    qf = flat_inputs(q)
    flat_err = rel_err(fa.flash_attention(qf, k, v, scale, fast=fast), plain(qf, k, v, scale))
    mutants = wide_mutant_errors(plain, q, k, v, qf, scale, f32=f32)
    if f32:  # one TF32 pass
        mutants["tf32_plain"] = rel_err(tf32_plain(lambda *t: plain(*t, scale), q, k, v), want)
    ms = time_ms(lambda: fa.flash_attention(q, k, v, scale, fast=fast), iters=3, warmup=1)
    plain_ms = time_ms(lambda: plain(q, k, v, scale), iters=1, warmup=1)
    lib_ms, backend = sdpa_ms(q, k, v, scale)
    dense, plan = 4.0 * bt * h * n * n * d, fa.wide_flops(bt, n, h, d)
    nbytes = 4.0 * bt * n * h * d * q.element_size()
    if f32:  # 3xTF32 on the tensor cores
        b_ms, b_by = max(3 * dense / PEAK_TF32 * 1e3, nbytes / PEAK_BYTES * 1e3), "operations"
        plan_ms = 3 * plan / PEAK_TF32 * 1e3
    else:
        (b_ms, b_by), plan_ms = bound(dense, nbytes), bound(plan, nbytes)[0]
    err = rel_err(got, want)
    return dict(kernel="flash_attention_wide" + ("_f32" if f32 else ""),
                shape=f"{label} (B*T={bt}, N={n}, H={h}, D={d}{', fast' if fast else ''})",
                max_abs_err=max_err(got, want), rel_err=max(err, flat_err),
                tol=F32_TOL if f32 else ATTN_TOL, mutants=mutants, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                extra=f" (peaked {err:.3e}, flat {flat_err:.3e}) ms/bound_ms={ms / b_ms:.2f} "
                      f"plan_bound_ms={plan_ms:.4f} ms/plan_bound_ms={ms / plan_ms:.2f} "
                      f"ms/sdpa_ms={ms / lib_ms:.3f} sdpa_backend={backend} "
                      f"ptxas [{wide_ptxas(f32, fast)}]")


def wide_rows(dev) -> list:
    """(e): the wide kernel at the d320 windows' shapes and over WIDE_SWEEP_D
    x WIDE_SWEEP_SHAPES, bf16 and fp32 (TF32 off), exact and fast."""
    import torch

    rows = []
    g = torch.Generator(device=dev).manual_seed(22)
    shapes = [(label, bt, n, h, 320) for label, bt, n, h in WIDE_ROWS]
    shapes += [("synthetic", bt, n, h, d) for d in WIDE_SWEEP_D for bt, n, h in WIDE_SWEEP_SHAPES]
    with no_tf32():
        for label, bt, n, h, d in shapes:
            for dtype in (torch.bfloat16, torch.float32):
                for fast in (False, True):
                    rows.append(wide_row(label, bt, n, h, d, dtype, fast, g, dev))
            torch.cuda.empty_cache()
    return rows


def phase_wide(dev, smi: str) -> tuple:
    """Kernel A at D >= 320: (d) one d320 window at 518x518 and at 518x924
    under ``auto``, ``auto:fast`` and ``pallas`` (noised weights) against
    the plain path within ``rounding_tol`` with the exact launches of
    WIDE_WINDOWS, each window's ms on the kernel and the plain path; an fp32
    518x518 window (TF32 off) within F32_WINDOW_TOL with WIDE_F32_PLAN; one
    ``Trainer.step`` of d320 cut to D320_GRAD_DEPTH blocks at 266x266x8,
    kernel path (the wide forward, the plain backward) against plain path.
    Then (e), ``wide_rows``.  Returns the main-path launches (the windows)
    and the rows."""
    import torch

    from video_depth_anything_torch.models.vda import VDAModel
    from video_depth_anything_torch.ops.dispatch import plain_reference
    from video_depth_anything_torch.ops.temporal_attention import temporal_attention

    totals = dict.fromkeys(launch_counts(), 0)
    g = torch.Generator(device=dev).manual_seed(22)
    cfg = d320_config()
    t0 = time.time()
    with torch.device(dev):  # parameters made on the card
        models = {impl: VDAModel(cfg=cfg, device=dev, attn_impl=impl)
                  for impl in ("auto", "auto:fast", "pallas")}
        noise_weights(models["auto"].module, seed=1, device=dev)
    state = models["auto"].module.state_dict()
    for impl in ("auto:fast", "pallas"):
        models[impl].module.load_state_dict(state)
    n_params = sum(p.numel() for p in models["auto"].module.parameters())
    log(f"[wide] d320: {n_params / 1e6:.1f} M parameters, built and noised in "
        f"{time.time() - t0:.1f} s")
    for h, w in ((518, 518), (518, 924)):
        x = torch.randn(1, 32, h, w, 3, device=dev, generator=g)
        base = models["auto"]
        with plain_reference():
            want = base.infer_window(x)
        with fp32_plain(base):
            ref32 = base.infer_window(x)
        tol, noise = rounding_tol(WINDOW_TOL, want, ref32)
        for impl, model in models.items():
            plan, widths = WIDE_WINDOWS[(h, w, impl)]
            zero_counts()
            got = model.infer_window(x)
            torch.cuda.synchronize()
            counts = launch_counts()
            by_width = dict(temporal_attention.width_launches)
            rel = float((got.float() - want.float()).abs().max() / want.float().abs().max())
            finite = bool(torch.isfinite(got).all())
            ok = finite and rel <= tol and plan_ok(counts, plan) and by_width == widths
            log(f"[wide] window d320 1x32x{h}x{w} {impl}: rel err kernels vs plain {rel:.3e} "
                f"(tol {tol:.3e}: plain bf16 vs fp32 activations {noise:.3e}), finite={finite}, "
                f"launches {counts}, Kernel B by head width {by_width} {'OK' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"d320 window {h}x{w} {impl} failed")
            totals = {k: totals[k] + counts[k] for k in totals}
        log(f"[wide] window d320 1x32x{h}x{w} bf16 auto: kernel path "
            f"{window_ms(base, x, False):.2f} ms, plain path {window_ms(base, x, True):.2f} ms "
            f"({smi})")
        del x, want, ref32, got
        torch.cuda.empty_cache()
    for impl in ("auto:fast", "pallas"):
        del models[impl]
    with torch.device(dev):
        m32 = VDAModel(cfg=cfg, device=dev, dtype=torch.float32)
    m32.module.load_state_dict(state)
    del models, state
    torch.cuda.empty_cache()
    x = torch.randn(1, 32, 518, 518, 3, device=dev, generator=g)
    with no_tf32():
        zero_counts()
        got = m32.infer_window(x)
        torch.cuda.synchronize()
        counts = launch_counts()
        with plain_reference():
            want = m32.infer_window(x)
        rel = float((got - want).abs().max() / want.abs().max())
        finite = bool(torch.isfinite(got).all())
        ok = finite and rel <= F32_WINDOW_TOL and plan_ok(counts, WIDE_F32_PLAN)
        log(f"[wide] window d320 1x32x518x518 fp32 (TF32 off): rel err kernels vs plain {rel:.3e} "
            f"(tol {F32_WINDOW_TOL}), finite={finite}, launches {counts} {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("d320 fp32 window failed")
        totals = {k: totals[k] + counts[k] for k in totals}
        log(f"[wide] window d320 1x32x518x518 fp32: kernel path {window_ms(m32, x, False):.2f} ms, "
            f"plain path {window_ms(m32, x, True):.2f} ms ({smi})")
    del m32, x, got, want
    torch.cuda.empty_cache()

    # the gradient check: the wide forward, the plain backward (bwd_gate holds
    # at D = 64 only, as JAX's VJP is the dense einsum backward elsewhere)
    with torch.device(dev):
        model = VDAModel(cfg=d320_config(D320_GRAD_DEPTH), device=dev)
        noise_weights(model.module, seed=1, device=dev)
    init = {k: v.clone() for k, v in model.module.state_dict().items()}
    batch = train_batch(8, 266, g, dev)
    got, g_kernel, counts = train_step(model, init, batch)
    with plain_reference():
        want, g_plain, _ = train_step(model, init, batch)
    loss_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    sq = {}
    for name in g_plain:
        d2, p2 = sq.get(grad_groups(name), (0.0, 0.0))
        sq[grad_groups(name)] = (d2 + float((g_kernel[name] - g_plain[name]).pow(2).sum()),
                                 p2 + float(g_plain[name].pow(2).sum()))
    total = (sum(d for d, _ in sq.values()) / sum(p for _, p in sq.values())) ** 0.5
    groups = {k: (d / p) ** 0.5 for k, (d, p) in sq.items()}
    ok = (loss_rel <= LOSS_TOL and total <= GRAD_TOL and max(groups.values()) <= GROUP_TOL
          and counts["flash_attention_wide"] == 2 * D320_GRAD_DEPTH
          and counts["flash_attention_bwd"] == counts["flash_attention"] == 0)
    log(f"[wide] train step d320 (depth {D320_GRAD_DEPTH}) 1x8x266x266: loss kernel "
        f"{got['loss']:.6f} plain {want['loss']:.6f} (rel {loss_rel:.3e}, tol {LOSS_TOL}); grad "
        f"rel err all {total:.3e} (tol {GRAD_TOL}), by group "
        + ", ".join(f"{k} {v:.3e}" for k, v in sorted(groups.items()))
        + f" (tol {GROUP_TOL}); launches {counts} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("d320 training check failed")
    del model, init, g_kernel, g_plain
    torch.cuda.empty_cache()

    log(f"[wide] launches over the main path: {totals} ({smi})")
    rows = wide_rows(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    check_rows(rows, "wide")
    return totals, rows


# vitg (24 heads of 64 in 40 blocks; features 384, out_channels 1536), a
# window of 32 frames: the launches its gates plan (tests/test_torch_dispatch.py
# derives them from JAX's gates), every other count 0.  Kernel A in each of
# the 40 blocks; Kernel C on m3 (74² locations at 518x518, 74x132 at
# 518x924) and on m2 at 518x924 (37x66 = 2442 >= 2048 locations); Kernel B
# on m2 under pallas at 518x518 only (d = 48, its two attentions; auto keeps
# the einsum at d > 24 there); m0 and m1 (C = 1536, d = 192) plain; the tail
# refused (C = 192).
VITG_PLANS = {
    (518, 518, "auto"): (dict(flash_attention=40, fused_motion_module=1), {}),
    (518, 518, "pallas"): (dict(flash_attention=40, temporal_attention=2, fused_motion_module=1),
                           {48: 2}),
    (518, 924, "auto"): (dict(flash_attention=40, fused_motion_module=2), {}),
    (518, 924, "pallas"): (dict(flash_attention=40, fused_motion_module=2), {}),
}
VITG_F32_PLAN = dict(flash_attention_f32=40, fused_motion_module_f32=1)
# (source clip h, w) -> the model's 518x518 and 518x924; 32 frames make two
# windows (the second holds the 10 keyframe slots and the tail's padding)
VITG_CLIPS = ((480, 480), (480, 854))
VITG_FRAMES = 32
VITG_ATTN = (("vitg 518x518", 1370), ("vitg 518x924", 2443))
VITG_MOTION = (("vitg m3 518x518", 384, 5476, 32), ("vitg m3 518x924", 384, 9768, 32))


def per_windows(plan: dict, windows: int) -> dict:
    """A window's launch plan over ``windows`` windows."""
    return {k: n * windows for k, n in plan.items()}


def plan_ok(counts: dict, plan: dict) -> bool:
    """Every kernel's launches exactly ``plan``'s (0 where it names none)."""
    return all(n == plan.get(k, 0) for k, n in counts.items())


def vitg_pipeline(model, frames, plain: bool = False):
    """``VideoDepthPipeline`` over ``frames`` (counts zeroed just before):
    ``(depth, launches, Kernel B's launches by head width, wall s)``."""
    import torch

    from video_depth_anything_torch.inference.pipeline import VideoDepthPipeline
    from video_depth_anything_torch.ops.dispatch import plain_reference
    from video_depth_anything_torch.ops.temporal_attention import temporal_attention

    zero_counts()
    with plain_reference() if plain else contextlib.nullcontext():
        t0 = time.perf_counter()
        depth, _ = VideoDepthPipeline(model).infer_video_depth(frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    widths = temporal_attention.f32_width_launches if model.dtype == torch.float32 \
        else temporal_attention.width_launches
    return depth, launch_counts(), dict(widths), wall


def window_ms(model, x, plain: bool) -> float:
    """ms of one ``infer_window`` on the kernel or the plain path; called
    right after a pipeline run of the same path and dtype, which warms it."""
    import torch

    from video_depth_anything_torch.ops.dispatch import plain_reference

    with plain_reference() if plain else contextlib.nullcontext():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.infer_window(x)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_vitg(dev, smi: str) -> dict:
    """vitg on the card: Kernels A and C alone at the shapes a vitg window
    gives them (24 heads of 64 at 1370 and 2443 tokens; C = 384 at 5476
    and 9768 locations; bf16 and fp32, with phase kernels' mutants); then a
    seeded vitg with every parameter noised (``noise_weights``: its zero
    proj_out would make every motion module the identity), run through
    ``VideoDepthPipeline`` on 32-frame clips at 518x518 and 518x924 under
    ``--attn_impl auto`` and ``pallas``, each against the plain path within
    WINDOW_TOL (``rounding_tol``) with its launch plan (VITG_PLANS), and an
    fp32 518x518 window within F32_WINDOW_TOL (TF32 off; VITG_F32_PLAN);
    ms of a window, kernel and plain path, and the plain path's peak
    device memory.  Returns the launches summed over the kernel-path
    pipeline runs (the main path of vitg)."""
    import numpy as np
    import torch

    from video_depth_anything_torch.inference.pipeline import num_windows
    from video_depth_anything_torch.models.vda import VDAModel

    windows = num_windows(VITG_FRAMES)
    g = torch.Generator(device=dev).manual_seed(19)
    rows = [attention_row("flash_attention", label, 32, n, 24, 64, g, dev)
            for label, n in VITG_ATTN]
    rows += [motion_row(*m, g, dev) for m in VITG_MOTION]
    with no_tf32():
        rows += [attention_f32_row(VITG_ATTN[0][0], 32, VITG_ATTN[0][1], 24, 64, False, g, dev)]
        rows += [motion_f32_row(*m, g, dev) for m in VITG_MOTION]
    check_rows(rows, "vitg")
    torch.cuda.empty_cache()

    t0 = time.time()
    with torch.device(dev):  # parameters made on the card, not on the host and copied
        model = VDAModel("vitg", device=dev)
        noise_weights(model.module, seed=1, device=dev)  # every parameter: no init needed
        pal = VDAModel("vitg", device=dev, attn_impl="pallas")
    pal.module.load_state_dict(model.module.state_dict())
    n_params = sum(p.numel() for p in model.module.parameters())
    log(f"[vitg] {n_params / 1e9:.3f} B parameters, built and noised in {time.time() - t0:.1f} s")
    total = {}
    for h, w in VITG_CLIPS:
        frames = clip_frames(h, w, VITG_FRAMES)
        x = torch.randn(1, 32, 518, 518 if w == h else 924, 3, device=dev, generator=g)
        torch.cuda.reset_peak_memory_stats()
        want, _, _, plain_wall = vitg_pipeline(model, frames, plain=True)
        peak = torch.cuda.max_memory_allocated() / 2**30
        plain_ms = window_ms(model, x, True)
        with fp32_plain(model):
            ref32, _, _, _ = vitg_pipeline(model, frames, plain=True)
        tol, noise = rounding_tol(WINDOW_TOL, want, ref32)
        for impl, m in (("auto", model), ("pallas", pal)):
            got, counts, widths, wall = vitg_pipeline(m, frames)
            mh, mw = 518, 518 if w == h else 924
            plan, want_widths = (per_windows(p, windows) for p in VITG_PLANS[(mh, mw, impl)])
            rel = float(np.abs(got - want).max() / np.abs(want).max())
            ok = bool(np.isfinite(got).all()) and rel <= tol and plan_ok(counts, plan) \
                and widths == want_widths
            log(f"[vitg] pipeline {h}x{w} -> {mh}x{mw} {impl}: rel err kernels vs plain "
                f"{rel:.3e} (tol {tol:.3e}: plain bf16 vs fp32 activations {noise:.3e}), "
                f"launches {counts}, Kernel B by head width {widths}, {32 / wall:.2f} frames/s "
                f"(plain path {32 / plain_wall:.2f}; plain peak device memory {peak:.2f} GiB) "
                f"{'OK' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"vitg pipeline {h}x{w} {impl} failed")
            total = {k: total.get(k, 0) + v for k, v in counts.items()}
        log(f"[vitg] window 1x32x{x.shape[2]}x{x.shape[3]} bf16: kernel path "
            f"{window_ms(model, x, False):.2f} ms, plain path {plain_ms:.2f} ms ({smi})")
        del x, want, ref32, got
    del pal
    torch.cuda.empty_cache()

    with torch.device(dev):
        f32 = VDAModel("vitg", device=dev, dtype=torch.float32)
    f32.module.load_state_dict(model.module.state_dict())
    del model
    torch.cuda.empty_cache()
    frames = clip_frames(*VITG_CLIPS[0], VITG_FRAMES)
    x = torch.randn(1, 32, 518, 518, 3, device=dev, generator=g)
    with no_tf32():
        want, _, _, _ = vitg_pipeline(f32, frames, plain=True)
        plain_ms = window_ms(f32, x, True)
        got, counts, _, wall = vitg_pipeline(f32, frames)
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        ok = bool(np.isfinite(got).all()) and rel <= F32_WINDOW_TOL and plan_ok(
            counts, per_windows(VITG_F32_PLAN, windows))
        log(f"[vitg] pipeline 480x480 -> 518x518 fp32 (TF32 off): rel err kernels vs plain "
            f"{rel:.3e} (tol {F32_WINDOW_TOL}), launches {counts} {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("vitg fp32 pipeline failed")
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        log(f"[vitg] window 1x32x518x518 fp32: kernel path {window_ms(f32, x, False):.2f} ms, "
            f"plain path {plain_ms:.2f} ms ({smi})")
    del f32, x
    torch.cuda.empty_cache()
    return total

def clip_frames(h: int, w: int, n: int = 76):
    """uint8 ``(n, h, w, 3)``: colour ramps with a white disc moving across."""
    import cv2
    import numpy as np

    yy, xx = np.mgrid[0:h, 0:w]
    frames = np.zeros((n, h, w, 3), np.uint8)
    for i in range(n):
        frames[i, ..., 0] = (xx * 255 // w).astype(np.uint8)
        frames[i, ..., 1] = (yy * 255 // h).astype(np.uint8)
        cv2.circle(frames[i], (int(w * (0.2 + 0.6 * i / n)), h // 2), h // 6, (255, 255, 255), -1)
    return frames


def write_clip(path: str, h: int, w: int, n: int = 76) -> None:
    import cv2

    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 24, (w, h))
    for f in clip_frames(h, w, n):
        writer.write(f)
    writer.release()


LOSS_TOL = 2e-2  # training check, kernel path vs plain path: the loss, relative
GRAD_TOL = 5e-2  # ||g_kernel - g_plain|| / ||g_plain|| over all parameters
GROUP_TOL = 1e-1  # the same within each group (encoder, each motion module, the
# rest of the head): bf16 rounds at other points in every kernel and the
# error of the forward (WINDOW_TOL) reaches every gradient

# Kernel launches of one kernel-path Trainer.step with the encoder trained
# (whole-forward recompute: Kernel A's forward runs twice per block), and
# the kernels that must run in it.
TRAIN_PLANS = {
    ("vits", 518, 16): ("flash_attention", "flash_attention_bwd", "temporal_attention",
                        "fused_motion_module"),
    ("vitl", 266, 8): ("flash_attention", "flash_attention_bwd", "output_tail"),
}


def grad_groups(name: str) -> str:
    if name.startswith("pretrained."):
        return "encoder"
    if name.startswith("head.motion_modules."):
        return "motion_module_" + name.split(".")[2]
    return "head"


def train_batch(t: int, side: int, gen, device) -> dict:
    """One clip of noise frames with a smooth disparity ramp as the target
    and 10 % of the pixels masked out."""
    import torch

    yy, xx = torch.meshgrid(torch.linspace(0, 1, side, device=device),
                            torch.linspace(0, 1, side, device=device), indexing="ij")
    return {"frames": torch.randn(1, t, side, side, 3, generator=gen, device=device),
            "disparity": (0.3 + 0.5 * xx + 0.2 * yy).expand(1, t, side, side).contiguous(),
            "mask": (torch.rand(1, t, side, side, generator=gen, device=device) > 0.1).float()}


def train_step(model, init: dict, batch: dict, train_encoder: bool = True):
    """Reset the weights to ``init``, run one ``Trainer.step``; return the
    metrics, every parameter's gradient (fp32, zeros where none) and the
    launch counts of that step."""
    import torch

    from video_depth_anything_torch.train.trainer import Trainer, make_optimizer

    model.module.load_state_dict(init)
    trainer = Trainer(model.module, make_optimizer(1e-5, train_encoder=train_encoder),
                      train_encoder=train_encoder)
    zero_counts()
    metrics = trainer.step(batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.float().clone()
             for n, p in model.module.named_parameters()}
    model.module.zero_grad(set_to_none=True)
    del trainer
    return {k: float(v) for k, v in metrics.items()}, grads, counts


def phase_train_check(dev, smi: str) -> None:
    """One Trainer.step on the kernel path against one on the plain path,
    same noised weights and batch, encoder trained, bf16; then one step
    with the encoder frozen, which must leave ``pretrained.*`` bit-identical."""
    import torch

    from video_depth_anything_torch.models.vda import VDAModel
    from video_depth_anything_torch.ops.dispatch import plain_reference

    g = torch.Generator(device=dev).manual_seed(3)
    for (encoder, side, t), needed in TRAIN_PLANS.items():
        model = VDAModel(encoder, device=dev)
        noise_weights(model.module, seed=1, device=dev)
        init = {k: v.clone() for k, v in model.module.state_dict().items()}
        batch = train_batch(t, side, g, dev)
        got, g_kernel, counts = train_step(model, init, batch)
        torch.cuda.reset_peak_memory_stats()
        with plain_reference():
            want, g_plain, _ = train_step(model, init, batch)
        plain_peak = torch.cuda.max_memory_allocated() / 2**30
        depth = model.cfg.vit.depth
        loss_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
        sq = {}
        for n in g_plain:
            d2, p2 = sq.get(grad_groups(n), (0.0, 0.0))
            sq[grad_groups(n)] = (d2 + float((g_kernel[n] - g_plain[n]).pow(2).sum()),
                                  p2 + float(g_plain[n].pow(2).sum()))
        total = (sum(d for d, _ in sq.values()) / sum(p for _, p in sq.values())) ** 0.5
        groups = {k: (d / p) ** 0.5 for k, (d, p) in sq.items()}
        missing = [n for n in g_plain if bool(g_plain[n].any()) and not bool(g_kernel[n].any())]
        ok = (loss_rel <= LOSS_TOL and total <= GRAD_TOL and max(groups.values()) <= GROUP_TOL
              and not missing and all(counts[k] > 0 for k in needed)
              and counts["flash_attention"] == 2 * depth and counts["flash_attention_bwd"] == depth)
        log(f"[train] {encoder} 1x{t}x{side}x{side} encoder trained: loss kernel {got['loss']:.6f} "
            f"plain {want['loss']:.6f} (rel {loss_rel:.3e}, tol {LOSS_TOL}); grad rel err all "
            f"{total:.3e} (tol {GRAD_TOL}), by group "
            + ", ".join(f"{k} {v:.3e}" for k, v in sorted(groups.items()))
            + f" (tol {GROUP_TOL}); parameters with a plain gradient but none on the kernel path: "
            f"{missing}; launches {counts}; plain reference peak device memory {plain_peak:.2f} GiB "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"training check of {encoder} failed")
        if encoder == "vits":
            small = train_batch(8, 266, g, dev)
            got, grads, _ = train_step(model, init, small, train_encoder=False)
            after = model.module.state_dict()
            frozen = all(torch.equal(after[k], init[k]) for k in init if k.startswith("pretrained."))
            moved = any(not torch.equal(after[k], init[k]) for k in init if k.startswith("head."))
            log(f"[train] vits 1x8x266x266 encoder frozen: loss {got['loss']:.6f}, pretrained.* "
                f"bit-identical {frozen}, head moved {moved} {'OK' if frozen and moved else 'FAIL'}")
            if not (frozen and moved):
                raise SystemExit("the frozen-encoder step changed the encoder or left the head")
        del model, init, g_kernel, g_plain
        torch.cuda.empty_cache()


def phase_train_cli(smi: str) -> dict:
    """``python -m video_depth_anything_torch.train`` in-process on a
    synthetic PointOdyssey tree: vits, encoder trained, 518², 32-frame
    clips, 6 steps with accumulation, a schedule, checkpoints and
    validation, then a resume for 2 more.  The main path of training: the
    counts are zeroed just before and read just after."""
    import json

    import numpy as np

    from video_depth_anything_torch.train.__main__ import main as train_main

    with tempfile.TemporaryDirectory() as tmp:
        root, out = os.path.join(tmp, "po"), os.path.join(tmp, "out")
        write_pointodyssey(root)
        args = ["--dataset", "pointodyssey", "--root", root, "--encoder", "vits", "--train_encoder",
                "--input_size", "518", "--clip_len", "32", "--accum_steps", "2", "--warmup_steps",
                "2", "--decay_steps", "6", "--save_every", "3", "--eval_every", "3",
                "--log_every", "1", "--out", out]
        zero_counts()
        rc = train_main(args + ["--steps", "6"])
        rc_resumed = train_main(args + ["--steps", "8", "--resume"])
        counts = main_path_launches()
        lines = [json.loads(x) for x in open(os.path.join(out, "train_log.jsonl"))]
        saved = sorted(f for f in os.listdir(out) if f.endswith(".pth"))
    steps = [x["step"] for x in lines]
    finite = all(np.isfinite(x[k]) for x in lines for k in ("loss", "ssi", "tgm", "grad_norm"))
    needed = ("flash_attention", "flash_attention_bwd", "temporal_attention", "fused_motion_module")
    # the first run's step k was logged (k / sps) s after its start, before
    # that step's validation: steps 2 and 3 run back to back
    t1, t3 = (k / lines[k - 1]["sps"] for k in (1, 3))
    clips_s = 2 / (t3 - t1)
    ok = (rc == 0 and rc_resumed == 0 and steps == list(range(1, 9)) and finite
          and "val_absrel_disp" in lines[2] and all(counts[k] > 0 for k in needed))
    log(f"[train-cli] vits 518x518 clips of 32, encoder trained: rc {rc}/{rc_resumed}, logged steps "
        f"{steps}, losses {[round(x['loss'], 5) for x in lines]}, finite {finite}, validation "
        f"{ {k: lines[2].get(k) for k in ('val_absrel_disp', 'val_delta1_disp')} }, checkpoints "
        f"{saved}, launches {counts} {'OK' if ok else 'FAIL'}")
    log(f"[train-cli] steps 2-3: {clips_s:.3f} clips/s, {32 * clips_s:.1f} frames/s ({smi})")
    if not ok:
        raise SystemExit("the training CLI run failed")
    return counts


def write_pointodyssey(root: str, scenes: int = 2, frames: int = 40, h: int = 360, w: int = 640,
                       seed: int = 0) -> None:
    """A synthetic PointOdyssey tree (``train/<scene>/rgbs/rgb_*.jpg``,
    ``depths/depth_*.png`` 16-bit at meters·65.535, ``anno.npz``): the
    frames of ``scene_frame``."""
    import cv2
    import numpy as np

    rng = np.random.RandomState(seed)
    for s in range(scenes):
        base = os.path.join(root, "train", f"scene_{s:02d}")
        os.makedirs(os.path.join(base, "rgbs"))
        os.makedirs(os.path.join(base, "depths"))
        tilt = rng.uniform(0.5, 2.0, size=2)
        for i in range(frames):
            depth, rgb = scene_frame(i, frames, h, w, tilt, 0.5 + 0.1 * s, rng)
            cv2.imwrite(os.path.join(base, "rgbs", f"rgb_{i:05d}.jpg"), rgb)
            cv2.imwrite(os.path.join(base, "depths", f"depth_{i:05d}.png"),
                        np.round(depth / 1000.0 * 65535.0).astype(np.uint16))
        np.savez(os.path.join(base, "anno.npz"),
                 intrinsics=np.tile(np.eye(3, dtype=np.float32) * 300, (frames, 1, 1)),
                 extrinsics=np.tile(np.eye(4, dtype=np.float32), (frames, 1, 1)))


def scene_frame(i: int, frames: int, h: int, w: int, tilt, row: float, rng):
    """One synthetic frame: metric depth ``(h, w)`` (a tilted ramp, 2-6 m,
    with a disc that moves across and nearer over the scene) and uint8 RGB
    whose brightness follows the depth."""
    import numpy as np

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = 2.0 + tilt[0] * xx / w + tilt[1] * yy / h
    cx, cy = w * (0.2 + 0.6 * i / frames), h * row
    disc = (xx - cx) ** 2 + (yy - cy) ** 2 < (h / 5) ** 2
    depth = np.where(disc, 1.0 + 0.5 * i / frames, depth)
    shade = (255 * (1.2 - depth / 5.0)).clip(0, 255)
    rgb = np.stack([shade, shade * 0.8, 255 - shade], -1) + rng.randint(0, 8, (h, w, 1))
    return depth, rgb.clip(0, 255).astype(np.uint8)


FAST_PNG = (16, 1)  # cv2.IMWRITE_PNG_COMPRESSION, level 1: the synthetic trees write fast


def write_kitti(root: str, drives: int = 1, frames: int = 40, h: int = 375, w: int = 1242,
                split: str = "train", seed: int = 0) -> None:
    """A synthetic KITTI tree in the loader's layout: per drive, both
    cameras' raw frames (``kitti_raw/<date>/<drive>/image_0{2,3}/data``,
    ``frames + 10`` of them) and annotated depth for frames 5 .. frames + 4
    only (``kitti_depth/data_depth_annotated/<split>/<drive>/proj_depth/
    groundtruth/image_0x``, 16-bit PNG at meters·256), valid on a sparse
    lidar-like pattern (every third row of the lower two thirds, 60 % of
    its pixels) and 0 elsewhere; ``calib_cam_to_cam.txt`` with every
    camera's ``P_rect``."""
    import cv2
    import numpy as np

    rng = np.random.RandomState(seed)
    date = "2011_09_26"
    os.makedirs(os.path.join(root, "kitti_raw", date), exist_ok=True)
    with open(os.path.join(root, "kitti_raw", date, "calib_cam_to_cam.txt"), "w") as f:
        f.write("calib_time: 09-Jan-2012 13:57:47\ncorner_dist: 9.950000e-02\n")
        for cam in range(4):
            p = [721.5377 + cam, 0.0, w / 2 - 0.5, 44.857 * cam, 0.0, 721.5377, h / 2 - 0.5, 0.2,
                 0.0, 0.0, 1.0, 2.7e-3]
            f.write(f"P_rect_0{cam}: " + " ".join(f"{x:.6e}" for x in p) + "\n")
    rows = np.zeros((h, 1), bool)
    rows[h // 3::3] = True
    for d in range(drives):
        drive = f"{date}_drive_{d + 1:04d}_sync"
        for c, cam in enumerate(("image_02", "image_03")):
            img_dir = os.path.join(root, "kitti_raw", date, drive, cam, "data")
            gt_dir = os.path.join(root, "kitti_depth", "data_depth_annotated", split, drive,
                                  "proj_depth", "groundtruth", cam)
            os.makedirs(img_dir, exist_ok=True)  # the splits share the raw frames
            os.makedirs(gt_dir)
            tilt = rng.uniform(0.5, 2.0, size=2)
            for i in range(frames + 10):
                depth, rgb = scene_frame(i, frames + 10, h, w, tilt, 0.5 + 0.1 * c, rng)
                cv2.imwrite(os.path.join(img_dir, f"{i:010d}.png"), rgb[..., ::-1], FAST_PNG)
                if 5 <= i < frames + 5:
                    valid = rows & (rng.rand(h, w) < 0.6)
                    cv2.imwrite(os.path.join(gt_dir, f"{i:010d}.png"),
                                np.where(valid, np.round(depth * 256.0), 0).astype(np.uint16),
                                FAST_PNG)


def write_sintel(root: str, scenes: int = 1, frames: int = 40, h: int = 436, w: int = 1024,
                 split: str = "training", seed: int = 0) -> None:
    """A synthetic MPI Sintel tree in the loader's layout: ``<split>/final/
    <scene>/frame_NNNN.png``, ``depth/<scene>/frame_NNNN.dpt`` (metres) and
    ``camdata_left/<scene>/frame_NNNN.cam`` (K and a 3×4 world→camera
    matrix: the camera slides along x and turns slowly about y), frames
    numbered from 1."""
    import cv2
    import numpy as np

    from video_depth_anything_torch.data.sintel import write_cam, write_dpt

    rng = np.random.RandomState(seed)
    k = np.array([[1120.0, 0.0, w / 2 - 0.5], [0.0, 1120.0, h / 2 - 0.5], [0.0, 0.0, 1.0]])
    for s in range(scenes):
        name = f"alley_{s + 1}"
        dirs = [os.path.join(root, split, sub, name) for sub in ("final", "depth", "camdata_left")]
        for x in dirs:
            os.makedirs(x)
        tilt = rng.uniform(0.5, 2.0, size=2)
        for i in range(frames):
            depth, rgb = scene_frame(i, frames, h, w, tilt, 0.5 + 0.1 * s, rng)
            stem = f"frame_{i + 1:04d}"
            cv2.imwrite(os.path.join(dirs[0], stem + ".png"), rgb[..., ::-1], FAST_PNG)
            write_dpt(os.path.join(dirs[1], stem + ".dpt"), depth)
            a = 0.002 * i
            rt = np.array([[np.cos(a), 0.0, np.sin(a), -0.01 * i], [0.0, 1.0, 0.0, 0.0],
                           [-np.sin(a), 0.0, np.cos(a), 0.0]])
            write_cam(os.path.join(dirs[2], stem + ".cam"), k, rt)


# -- phase eval: python -m video_depth_anything_torch.eval and .compare ---------

BF16_KERNELS = ("flash_attention", "flash_attention_fast", "flash_attention_bwd",
                "temporal_attention", "fused_motion_module", "output_tail")
F32_KERNELS = ("flash_attention_f32", "temporal_attention_f32", "fused_motion_module_f32")
# The eval runs at the benchmarks' native sizes: KITTI 375x1242 -> 280x924
# (1320 tokens), Sintel 436x1024 -> 392x924 (1848).  Below 2048 locations the
# gate leaves m0-m2 to the motion modules' attention (Kernel B where d <= 24:
# vits m0 d = 24 and m2 d = 8) and m3 (5280 / 7392 locations) to Kernel C.
# (label, dataset, eval flags, kernels that must launch, kernels that must
# not).  The KV mode never reaches Kernel C (its warm-up bypasses the fused
# module, phase stream); vitl's widths (d = 128, 32) leave Kernel B to
# --attn_impl pallas, so its Kernel B and tail counts are printed, not held.
EVAL_RUNS = (
    ("vits window", "kitti", [],
     ("flash_attention", "temporal_attention", "fused_motion_module"),
     ("flash_attention_fast", "flash_attention_bwd", "output_tail") + F32_KERNELS),
    ("vits feature cache", "sintel", ["--streaming"],
     ("flash_attention", "temporal_attention", "fused_motion_module"),
     ("flash_attention_fast", "flash_attention_bwd", "output_tail") + F32_KERNELS),
    ("vits kv cache", "sintel", ["--streaming", "--kv_cache"],
     ("flash_attention", "temporal_attention"),
     ("fused_motion_module", "flash_attention_fast", "flash_attention_bwd", "output_tail")
     + F32_KERNELS),
    ("vitl window", "kitti", ["--encoder", "vitl", "--max_scenes", "1"],
     ("flash_attention", "fused_motion_module"),
     ("flash_attention_fast", "flash_attention_bwd") + F32_KERNELS),
    ("vits fp32 window", "kitti", ["--fp32", "--max_scenes", "1"], F32_KERNELS, BF16_KERNELS),
)
METRIC_RTOL = 1e-4  # compute_all_torch's fp32 where-sums on the card against numpy's masked
# means over the same 2-18 M pixels (the two reductions sum in other orders),
# relative where a metric exceeds 1, absolute below (the deltas lie in [0, 1])


class Recorder:
    """A pipeline that keeps the frames and predictions of every call and
    sums the seconds spent in them."""

    def __init__(self, inner):
        self.inner, self.calls, self.seconds = inner, [], 0.0

    def infer_video_depth(self, frames, *a, **k):
        t0 = time.time()
        out = self.inner.infer_video_depth(frames, *a, **k)
        self.seconds += time.time() - t0
        self.calls.append((frames, out[0]))
        return out


class TimedDataset:
    """A dataset whose ``seconds`` sums the time of its scene loads;
    ``last`` is the last scene loaded."""

    def __init__(self, inner):
        self.inner, self.seconds, self.last = inner, 0.0, None

    def __len__(self):
        return len(self.inner)

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __getitem__(self, i):
        t0 = time.time()
        self.last = self.inner[i]
        self.seconds += time.time() - t0
        return self.last


def csv_summary(path: str):
    """``(per-scene rows, {total_frames, wall_s, fps, host_rss_mb})`` of an
    eval CSV."""
    import csv

    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    scenes = rows[1:rows.index([])]
    return scenes, dict(zip(rows[-2], map(float, rows[-1])))


@contextlib.contextmanager
def no_tf32():
    """TF32 off in matrix products and convolutions, as phase fp32 runs."""
    import torch

    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def eval_prediction_check(args, dataset, tmp: str, label: str, smi: str) -> None:
    """``evaluate_dataset``'s raw predictions of the first scene on the
    kernel path (noised weights) against the plain path on the card for
    the same frames: in bf16 within phase window's tolerance
    (``rounding_tol``); with ``--fp32`` within F32_WINDOW_TOL, and TF32
    off around both paths, as phase fp32 holds its windows.  Prints where
    the kernel-path evaluation's wall time went."""
    import numpy as np
    import torch

    from video_depth_anything_torch import eval as vda_eval
    from video_depth_anything_torch.evals.evaluate import evaluate_dataset
    from video_depth_anything_torch.evals.metrics import compute_all, compute_all_torch
    from video_depth_anything_torch.ops.dispatch import plain_reference

    model = vda_eval.load_model(args)
    noise_weights(model.module, seed=1, device=model.device)
    rec, data = Recorder(vda_eval.build_pipeline(args, model)), TimedDataset(dataset)
    with no_tf32() if args.fp32 else contextlib.nullcontext():
        t0 = time.time()
        evaluate_dataset(rec, data, os.path.join(tmp, f"check_{label.replace(' ', '_')}.csv"),
                         max_scenes=1, compute_tae=False, progress=False)
        wall = time.time() - t0
        (frames, got), = rec.calls
        with plain_reference():
            want = rec.inner.infer_video_depth(frames)[0]
    if args.fp32:
        tol, yardstick = F32_WINDOW_TOL, "fp32, TF32 off"
    else:
        with fp32_plain(model):
            ref32 = rec.inner.infer_video_depth(frames)[0]
        tol, noise = rounding_tol(WINDOW_TOL, want, ref32)
        yardstick = f"plain bf16 vs fp32 activations {noise:.3e}"
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    # the metrics' torch backend on the card against the numpy one, on the
    # raw prediction and the GT frames it is scored against
    n = len(got)
    gt = np.asarray(data.last["depth"])[: len(frames)][-n:]
    valid = np.asarray(data.last["valid_depth"]).astype(bool)[: len(frames)][-n:]
    host = compute_all(got, gt, valid)
    card = compute_all_torch(torch.from_numpy(got).cuda(), gt, valid)
    metric_rel = max(abs(float(card[k]) - v) / max(abs(v), 1.0) for k, v in host.items())
    ok = (got.shape == want.shape and bool(np.isfinite(got).all()) and rel <= tol
          and metric_rel <= METRIC_RTOL)
    log(f"[eval] {label}: raw predictions {got.shape}, rel err kernels vs plain {rel:.3e} (tol "
        f"{tol:.3e}: {yardstick}); compute_all_torch on the card "
        f"vs compute_all on the host, max diff {metric_rel:.3e} (relative above 1; tol "
        f"{METRIC_RTOL}) "
        f"{'OK' if ok else 'FAIL'}")
    log(f"[eval] {label}: one scene of {len(frames)} frames, evaluate_dataset without TAE "
        f"{wall:.3f} s: loading {data.seconds:.3f} s, the pipeline's call {rec.seconds:.3f} s "
        f"(preprocessing, the model, the stitch, the copies to the host), alignment and "
        f"metrics {wall - data.seconds - rec.seconds:.3f} s ({smi})")
    if not ok:
        raise SystemExit(f"eval {label}: the kernel path disagrees with the plain path")
    del model


def phase_eval(smi: str) -> dict:
    """``python -m video_depth_anything_torch.eval`` (``main``, in-process,
    ``--random_init``) on synthetic trees at the benchmarks' native sizes:
    KITTI (two scenes, both cameras of a drive, 40 frames at 375x1242,
    sparse lidar-like GT) and Sintel (one scene of 40 frames at 436x1024
    with cameras, so TAE).  Each run of EVAL_RUNS with its launch plan (the
    main path: counts zeroed before, read after), finite metrics for every
    scene in its CSV, frames/s (the CSV's fps) and peak device memory; the
    raw predictions of every run on the kernel path against the plain path
    (``eval_prediction_check``), with the split of one scene's evaluation
    (loading, the pipeline, alignment and metrics);
    ``video_depth_anything_torch.compare``'s steps before the renderings
    (the card has no matplotlib) on a 40-frame 375x1242 mp4: two ``--run``
    subprocesses over one checkpoint of noised weights, with and without
    --skip_tmp_block, which must differ, and ``comparison.json``, whose
    rows must be the first-frame alignment of the two npz files computed
    here.  Returns the launches summed over the eval runs."""
    import numpy as np
    import torch

    from video_depth_anything_torch import compare as vda_compare
    from video_depth_anything_torch import eval as vda_eval
    from video_depth_anything_torch.data import get_dataset
    from video_depth_anything_torch.evals.metrics import abs_diff
    from video_depth_anything_torch.ops.temporal_attention import temporal_attention

    totals = dict.fromkeys(launch_counts(), 0)
    with tempfile.TemporaryDirectory() as tmp:
        roots = {"kitti": os.path.join(tmp, "kitti"), "sintel": os.path.join(tmp, "sintel")}
        t0 = time.time()
        write_kitti(roots["kitti"])
        write_sintel(roots["sintel"])
        log(f"[eval] synthetic KITTI (2 scenes x 40 frames, 375x1242) and Sintel (1 x 40, "
            f"436x1024) trees written in {time.time() - t0:.1f} s")
        for label, dataset, flags, needed, absent in EVAL_RUNS:
            path = os.path.join(tmp, label.replace(" ", "_") + ".csv")
            argv = ["--dataset", dataset, "--root", roots[dataset], "--csv", path,
                    "--random_init", *flags]
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            t0 = time.time()
            rc = vda_eval.main(argv)
            torch.cuda.synchronize()
            wall = time.time() - t0
            delta = main_path_launches()
            peak = torch.cuda.max_memory_allocated() / 2**30
            totals = {k: totals[k] + delta[k] for k in totals}
            scenes, stats = csv_summary(path)
            finite = bool(scenes) and all(np.isfinite(float(x)) for r in scenes for x in r[2:11])
            tae = [r[11] for r in scenes]
            n_scenes = 2 if dataset == "kitti" and "--max_scenes" not in flags else 1
            ok = (rc == 0 and finite and len(scenes) == n_scenes
                  and all((t == "") == (dataset == "kitti") for t in tae)
                  and all(delta[k] > 0 for k in needed) and all(delta[k] == 0 for k in absent))
            log(f"[eval] {label} {dataset}: rc={rc} scenes {[(r[0], r[1]) for r in scenes]} "
                f"AbsRel {[round(float(r[9]), 4) for r in scenes]} delta1 "
                f"{[round(float(r[4]), 4) for r in scenes]} TAE {tae} finite={finite} launches "
                f"{delta} (tail {delta['output_tail']}, Kernel B by head width "
                f"{dict(temporal_attention.width_launches)}) {'OK' if ok else 'FAIL'}")
            log(f"[eval] {label} {dataset}: {stats['total_frames']:.0f} frames, {stats['fps']} "
                f"frames/s end to end (the CSV's fps: loading, inference, alignment, metrics, "
                f"TAE), the CLI {wall:.2f} s (model set-up included), peak device memory "
                f"{peak:.2f} GiB ({smi})")
            if not ok:
                raise SystemExit(f"eval run {label} failed")
            args = vda_eval.normalize_args(vda_eval.build_parser().parse_args(argv))
            eval_prediction_check(args, get_dataset(dataset, roots[dataset]), tmp, label, smi)
            torch.cuda.empty_cache()

        clip, out = os.path.join(tmp, "kitti.mp4"), os.path.join(tmp, "compare")
        write_clip(clip, 375, 1242, 40)
        ckpt = os.path.join(tmp, "noised_vits.pth")
        write_noised_pth("vits", ckpt, "cuda")
        t0 = time.time()
        os.makedirs(out)
        methods = vda_compare.run_methods(
            clip, [f"base:--checkpoint {ckpt}", f"skip:--checkpoint {ckpt} --skip_tmp_block"],
            out, "cuda")
        _, rows = vda_compare.score_methods(methods, None, out)
        with open(os.path.join(out, "comparison.json")) as f:
            report = json.load(f)
        base, skip = (np.load(os.path.join(out, f"run_{m}", "kitti_depth.npz"))["depth"]
                      for m in ("base", "skip"))
        scale = float(np.abs(base).mean())
        ok = (report == {"reference": "base", "methods": rows} and list(rows) == ["base", "skip"]
              and all(r["frames"] == 40 for r in rows.values())
              and base.shape == skip.shape and len(base) == 40
              and rows["base"]["abs_vs_ref"] < 1e-6 * scale
              and rows["skip"]["abs_vs_ref"] == abs_diff(vda_compare.first_frame_align(skip, base),
                                                        base)
              and rows["skip"]["abs_vs_ref"] > 1e-2 * scale
              and all(np.isfinite(r[k]) for r in rows.values() for k in ("abs_vs_ref",
                                                                           "mse_vs_ref"))
              and sorted(os.listdir(out)) == ["comparison.json", "run_base", "run_skip"])
        log(f"[eval] compare on a 40-frame 375x1242 clip, runs base and skip (--skip_tmp_block) "
            f"over one checkpoint of noised weights: {json.dumps(rows)}, mean |base depth| "
            f"{scale:.4f}, in {time.time() - t0:.1f} s {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("the compare run failed")
    log(f"[eval] launches over the eval runs: {totals} ({smi})")
    return totals


def phase_cli(smi: str) -> dict:
    import numpy as np

    from video_depth_anything_torch import run

    clips = {"square": (480, 480), "wide": (480, 854)}
    runs = (("vits", "square", ("flash_attention", "temporal_attention", "fused_motion_module")),
            ("vits", "wide", ("flash_attention", "fused_motion_module")),
            ("vitl", "square", ("flash_attention", "fused_motion_module", "output_tail")),
            ("vitb", "square", ("flash_attention", "temporal_attention", "fused_motion_module")),
            ("vitl", "square", ("flash_attention", "temporal_attention", "fused_motion_module",
                                "output_tail"), "pallas"))
    with tempfile.TemporaryDirectory() as tmp:
        for name, (h, w) in clips.items():
            write_clip(os.path.join(tmp, f"{name}.mp4"), h, w)
        totals = dict.fromkeys(launch_counts(), 0)
        for encoder, name, needed, *impl in runs:
            h, w = clips[name]
            impl = impl[0] if impl else "auto"
            zero_counts()
            rc = run.main(["--input_video", os.path.join(tmp, f"{name}.mp4"), "--output_dir", tmp,
                           "--encoder", encoder, "--random_init", "--save_npz",
                           "--attn_impl", impl])
            delta = main_path_launches()
            totals = {k: totals[k] + delta[k] for k in totals}
            depth = np.load(os.path.join(tmp, f"{name}_depth.npz"))["depth"]
            ok = (rc == 0 and depth.shape == (76, h, w) and bool(np.isfinite(depth).all())
                  and all(delta[k] > 0 for k in needed))
            log(f"[cli] {encoder} {name} {w}x{h} {impl}: rc={rc} depth {depth.shape} finite="
                f"{bool(np.isfinite(depth).all())} launches {delta} {'OK' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"cli run of {encoder} on the {name} clip failed")
        # the window mode's options: a shape bucket (518x518 -> 504x504),
        # fp16 copies to the host and the extra outputs
        out = os.path.join(tmp, "options")
        zero_counts()
        rc = run.main(["--input_video", os.path.join(tmp, "square.mp4"), "--output_dir", out,
                       "--encoder", "vits", "--random_init", "--save_npz", "--shape_bucket", "56",
                       "--transfer_dtype", "fp16", "--save_vis", "--save_stats", "--save_orig"])
        delta = main_path_launches()
        totals = {k: totals[k] + delta[k] for k in totals}
        depth = np.load(os.path.join(out, "square_depth.npz"))["depth"]
        files = sorted(os.listdir(out))
        with open(os.path.join(out, "inference_log.txt")) as f:
            record = json.loads(f.read().splitlines()[-1])
        ok = (rc == 0 and depth.shape == (76, 480, 480) and bool(np.isfinite(depth).all())
              and files == ["inference_log.txt", "square_depth.mp4", "square_depth.npz",
                            "square_orig.mp4", "square_vis.mp4"]
              and all(os.path.getsize(os.path.join(out, f)) > 0 for f in files)
              and record["frames_predicted"] == 76 and "cuda:0" in record["device_memory"]
              and record["args"]["shape_bucket"] == 56
              and all(delta[k] > 0 for k in ("flash_attention", "temporal_attention",
                                             "fused_motion_module")))
        log(f"[cli] vits square --shape_bucket 56 --transfer_dtype fp16 --save_vis --save_stats "
            f"--save_orig: rc={rc} depth {depth.shape} finite={bool(np.isfinite(depth).all())} "
            f"files {files} device_memory {record['device_memory']} launches {delta} "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("cli run with the window mode's options failed")
    log(f"[cli] launches over the main path: {totals} ({smi})")
    window_overlap_fps(smi)
    return totals


def window_overlap_fps(smi: str) -> None:
    """End-to-end frames/s of the window pipeline (vits, 76-frame clips):
    with the host work overlapped (preprocessing in the producer thread,
    each batch's copy to the host read one batch late) and without (every
    frame preprocessed first, each copy waited for at once), in turns on,
    off, off, on after a warm-up run; the two depths must agree."""
    from unittest import mock

    import numpy as np
    import torch

    from video_depth_anything_torch.inference import pipeline as vp
    from video_depth_anything_torch.models.vda import VDAModel
    from video_depth_anything_torch.utils.transform import model_size_for, preprocess_frames

    model = VDAModel("vits", device=torch.device("cuda"))
    model.init_params(seed=0)
    pipe = vp.VideoDepthPipeline(model)

    def serial(frames):
        n, fh, fw = frames.shape[:3]
        pre = np.empty((vp.padded_length(n),) + model_size_for(fh, fw) + (3,), np.float32)
        pre[:n] = preprocess_frames(frames)
        pre[n:] = pre[n - 1]
        with mock.patch.object(vp, "D2H_OVERLAP_BYTES", 0):
            depths = pipe.compute_window_depths(pre, vp.window_frame_indices(n), fh, fw)
        return vp.stitch_windows(depths, n)

    runs = {True: lambda f: pipe.infer_video_depth(f)[0], False: serial}
    for h, w in ((480, 854),):  # the 16:9 clip (480x480 gave the same picture)
        frames = clip_frames(h, w)
        fps, out = {True: [], False: []}, {}
        runs[True](frames)
        for overlap in (True, False, False, True):
            t = time.time()
            out[overlap] = runs[overlap](frames)
            fps[overlap].append(len(frames) / (time.time() - t))
        diff = float(np.abs(out[True] - out[False]).max() / np.abs(out[False]).max())
        log(f"[cli] window pipeline vits {w}x{h}, {len(frames)} frames, end to end: overlap on "
            f"{fps[True]} frames/s, off {fps[False]} frames/s; max |on - off| / max |off| "
            f"{diff:.3e} ({smi})")
        if diff > 1e-3:  # the same launches on the same inputs (bit for bit on the CPU)
            raise SystemExit("the overlapped window pipeline gives other depths than the serial one")
    del model, pipe
    torch.cuda.empty_cache()


STREAM_TOL = 5e-2  # relative to max|plain depth|, as WINDOW_TOL: each step
# runs the model on one 32-frame window (12 ViT blocks on the new frame, 4
# motion modules over the window); in aligned mode each frame's (s, t) comes
# from those depths, one more scale and shift per frame
STREAM = dict(inference_length=32, keyframe_list=(20,), chunk_size=8)
# 76 frames: 31 warm-up encodes, 21 transition steps (frames 31-51) and 3
# steady chunks of 8 (frames 52-75); plain mode gives depth from frame 31 on
STREAM_FRAMES = 76 - 31

# The streaming CLI runs (--process_single_image, 76-frame clips): the
# kernels each must launch and must not launch.
STREAM_PLANS = (
    ("vits", "wide", "auto:fast", ("flash_attention_fast", "fused_motion_module"),
     ("flash_attention", "temporal_attention", "output_tail", "flash_attention_bwd")),
    ("vits", "square", "auto", ("flash_attention", "temporal_attention", "fused_motion_module"),
     ("flash_attention_fast", "output_tail", "flash_attention_bwd")),
    ("vitl", "square", "auto", ("flash_attention", "fused_motion_module", "output_tail"),
     ("flash_attention_fast", "flash_attention_bwd")),
    ("vits", "square", "pallas", ("flash_attention", "temporal_attention", "fused_motion_module"),
     ("flash_attention_fast", "output_tail", "flash_attention_bwd")),
)


KV = dict(inference_length=32, stream_chunk=8)
# KV-cache streaming of a 76-frame clip: the warm-up window over frames
# 0-31, then 44 steady frames in 5 chunks of 8 and 4 single steps (aligned:
# each chunk or step also predicts the pinned first frame); every frame
# gets a depth.

# The KV-cache CLI runs (--process_single_image --kv_cache, 76-frame clips):
# the warm-up window's attentions reach Kernel B where its gate admits them
# (vits m0, m2, m3; vitb m2, m3; two attentions each), exactly once; no
# step reaches Kernel B (q has fewer frames than k) and nothing reaches
# Kernel C (the warm-up bypasses the fused module).
KV_PLANS = (
    ("vits", "wide", dict(flash_attention=None, temporal_attention=6),
     ("fused_motion_module", "output_tail", "flash_attention_bwd", "flash_attention_fast")),
    ("vitb", "square", dict(flash_attention=None, temporal_attention=4),
     ("fused_motion_module", "output_tail", "flash_attention_bwd", "flash_attention_fast")),
)


def phase_stream(dev, smi: str) -> dict:
    """Feature-cache streaming: the pipeline's kernel path against its plain
    path on a 76-frame 854x480 clip (plain mode under auto:fast, aligned
    mode under auto), the CLI in streaming mode with its launch plans (the
    main path: counts zeroed before each run, read after), and steady-state
    frames/s (``profile_streaming``: time per steady step / chunk).  Then
    KV-cache streaming: ``KVStreamingPipeline``'s kernel path against its
    plain path on 76-frame clips (vits 854x480, vitb 480x480; plain and
    aligned mode, chunk 8), the CLI with ``--kv_cache`` and its launch
    plans (main path), and steady KV frames/s at chunks 8 and 1."""
    import numpy as np
    import torch

    from video_depth_anything_torch import run
    from video_depth_anything_torch.inference.kv_streaming import KVStreamingPipeline
    from video_depth_anything_torch.inference.streaming import StreamingDepthPipeline
    from video_depth_anything_torch.models.vda import VDAModel
    from video_depth_anything_torch.ops.dispatch import plain_reference
    from video_depth_anything_torch.profile_streaming import (
        seconds_per_frame,
        steady_kv_step,
        steady_step,
    )

    frames = clip_frames(480, 854)
    models = {}
    for key, encoder, impl in (("auto:fast", "vits", "auto:fast"), ("auto", "vits", "auto"),
                               ("vitb", "vitb", "auto")):
        models[key] = VDAModel(encoder, device=dev, attn_impl=impl)
        noise_weights(models[key].module, seed=1, device=dev)
    for impl, align in (("auto:fast", False), ("auto", True)):
        pipe = StreamingDepthPipeline(models[impl], align_each_new_frame=align, **STREAM)
        zero_counts()
        got, _ = pipe.infer(frames)
        counts = launch_counts()
        with plain_reference():
            want, _ = pipe.infer(frames)
        n = len(frames) - (1 if align else STREAM["inference_length"] - 1)
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        ok = (got.shape == want.shape == (n, 480, 854) and bool(np.isfinite(got).all())
              and rel <= STREAM_TOL)
        log(f"[stream] vits 854x480 {'aligned' if align else 'plain'} {impl}: depth {got.shape}, "
            f"rel err kernels vs plain {rel:.3e} (tol {STREAM_TOL}), launches {counts} "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"streaming parity ({'aligned' if align else 'plain'}) failed")
    # --inference_length 24: the motion modules run over 24 frames, Kernel C
    # on 32 rows a location
    square = clip_frames(480, 480)
    pipe = StreamingDepthPipeline(models["auto"], **{**STREAM, "inference_length": 24})
    zero_counts()
    got, _ = pipe.infer(square)
    counts = launch_counts()
    with plain_reference():
        want, _ = pipe.infer(square)
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    ok = (got.shape == want.shape == (len(square) - 23, 480, 480) and bool(np.isfinite(got).all())
          and rel <= STREAM_TOL and counts["fused_motion_module"] > 0)
    log(f"[stream] vits 480x480 plain auto --inference_length 24: depth {got.shape}, rel err "
        f"kernels vs plain {rel:.3e} (tol {STREAM_TOL}), launches {counts} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("streaming parity at --inference_length 24 failed")

    clips = {"square": (480, 480), "wide": (480, 854)}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (h, w) in clips.items():
            write_clip(os.path.join(tmp, f"{name}.mp4"), h, w)
        totals = dict.fromkeys(launch_counts(), 0)
        for encoder, name, impl, needed, absent in STREAM_PLANS:
            h, w = clips[name]
            zero_counts()
            rc = run.main(["--input_video", os.path.join(tmp, f"{name}.mp4"), "--output_dir", tmp,
                           "--encoder", encoder, "--random_init", "--save_npz",
                           "--process_single_image", "--attn_impl", impl])
            delta = main_path_launches()
            totals = {k: totals[k] + delta[k] for k in totals}
            depth = np.load(os.path.join(tmp, f"{name}_depth.npz"))["depth"]
            ok = (rc == 0 and depth.shape == (STREAM_FRAMES, h, w)
                  and bool(np.isfinite(depth).all()) and all(delta[k] > 0 for k in needed)
                  and all(delta[k] == 0 for k in absent))
            log(f"[stream] cli {encoder} {name} {w}x{h} {impl}: rc={rc} depth {depth.shape} "
                f"finite={bool(np.isfinite(depth).all())} launches {delta} {'OK' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"streaming cli run of {encoder} on the {name} clip failed")
        zero_counts()
        rc = run.main(["--input_video", os.path.join(tmp, "square.mp4"), "--output_dir", tmp,
                       "--encoder", "vits", "--random_init", "--save_npz",
                       "--process_single_image", "--inference_length", "24"])
        delta = main_path_launches()
        totals = {k: totals[k] + delta[k] for k in totals}
        depth = np.load(os.path.join(tmp, "square_depth.npz"))["depth"]
        ok = (rc == 0 and depth.shape == (76 - 23, 480, 480) and bool(np.isfinite(depth).all())
              and all(delta[k] > 0 for k in ("flash_attention", "temporal_attention",
                                             "fused_motion_module")))
        log(f"[stream] cli vits square 480x480 --inference_length 24: rc={rc} depth {depth.shape} "
            f"finite={bool(np.isfinite(depth).all())} launches {delta} {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("streaming cli run at --inference_length 24 failed")
    log(f"[stream] launches over the streaming CLI runs: {totals} ({smi})")

    for key, (h, w) in (("auto", (480, 854)), ("vitb", (480, 480))):
        kv_frames = clip_frames(h, w)
        for align in (False, True):
            pipe = KVStreamingPipeline(models[key], align_each_new_frame=align, **KV)
            zero_counts()
            got, _ = pipe.infer(kv_frames)
            counts = launch_counts()
            with plain_reference():
                want, _ = pipe.infer(kv_frames)
            with fp32_plain(models[key]):
                ref32, _ = pipe.infer(kv_frames)
            tol, noise = rounding_tol(STREAM_TOL, want, ref32)
            rel = float(np.abs(got - want).max() / np.abs(want).max())
            ok = (got.shape == want.shape == (len(kv_frames), h, w) and bool(np.isfinite(got).all())
                  and rel <= tol and counts["temporal_attention"] > 0
                  and counts["fused_motion_module"] == 0)
            label = f"{models[key].cfg.encoder} {w}x{h} {'aligned' if align else 'plain'}"
            log(f"[stream] kv {label} chunk {KV['stream_chunk']}: depth {got.shape}, rel err "
                f"kernels vs plain {rel:.3e} (tol {tol:.3e}: plain bf16 vs fp32 activations "
                f"{noise:.3e}), launches {counts} {'OK' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"KV streaming parity ({label}) failed")

    with tempfile.TemporaryDirectory() as tmp:
        for name, (h, w) in clips.items():
            write_clip(os.path.join(tmp, f"{name}.mp4"), h, w)
        for encoder, name, needed, absent in KV_PLANS:
            h, w = clips[name]
            zero_counts()
            rc = run.main(["--input_video", os.path.join(tmp, f"{name}.mp4"), "--output_dir", tmp,
                           "--encoder", encoder, "--random_init", "--save_npz",
                           "--process_single_image", "--kv_cache"])
            delta = main_path_launches()
            totals = {k: totals[k] + delta[k] for k in totals}
            depth = np.load(os.path.join(tmp, f"{name}_depth.npz"))["depth"]
            ok = (rc == 0 and depth.shape == (76, h, w) and bool(np.isfinite(depth).all())
                  and all(delta[k] > 0 if n is None else delta[k] == n for k, n in needed.items())
                  and all(delta[k] == 0 for k in absent))
            log(f"[stream] cli kv {encoder} {name} {w}x{h}: rc={rc} depth {depth.shape} finite="
                f"{bool(np.isfinite(depth).all())} launches {delta} {'OK' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"KV streaming cli run of {encoder} on the {name} clip failed")
    log(f"[stream] launches over the streaming and KV-cache CLI runs: {totals} ({smi})")

    models["vitl"] = VDAModel("vitl", device=dev)
    noise_weights(models["vitl"].module, seed=1, device=dev)
    for mode, key, (h, w), chunks in (
            ("feature cache", "auto", (518, 518), (8, 1)),
            ("feature cache", "auto", (518, 924), (8, 1)),
            ("feature cache", "auto:fast", (518, 924), (8, 1)),
            ("feature cache", "vitl", (518, 518), (8,)),
            ("feature cache", "vitb", (518, 518), (8,)),
            ("kv cache", "auto", (518, 518), (8, 1)),
            ("kv cache", "auto", (518, 924), (8, 1)),
            ("kv cache", "vitb", (518, 518), (8, 1))):
        for chunk in chunks:
            make = steady_kv_step if mode == "kv cache" else steady_step
            step, k = make(models[key], h, w, chunk)
            spf = seconds_per_frame(step, k)
            model = models[key]
            label = f"{model.cfg.encoder} {model.attn_impl}"
            log(f"[stream] steady {mode} {label} {h}x{w} chunk {k}: {spf * 1e3:.3f} ms per frame, "
                f"{1 / spf:.2f} frames/s ({smi})")
            del step
    del models
    torch.cuda.empty_cache()
    return totals


# -- phase parallel: the multi-GPU layer (parallel/) on the one card ------------
#
# NCCL refuses two ranks on one device, so the card checks world size 1 over
# NCCL and two ranks sharing the card over gloo (parallel/comm.py stages the
# collectives through pinned host buffers; every rank's compute and kernels
# stay on the card).  Times and memory here are two ranks sharing one card:
# no scaling result.

PARALLEL_STREAM_FRAMES = 40  # --max_len of the TP streaming runs


def free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def rank_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "4")
    return env


def launch(cmds, label: str, timeout: float = 300.0, tag: str = "parallel") -> list:
    """Run each command (one process a command, all started together) from
    the repo root; returns their stdout.  A non-zero exit or a timeout
    fails the phase; every process is stopped before it returns."""
    import subprocess

    t0 = time.time()
    procs = [subprocess.Popen(c, cwd=REPO, env=rank_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for c in cmds]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    except subprocess.TimeoutExpired:
        raise SystemExit(f"[{tag}] {label}: timed out after {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            log(out[-6000:])
            raise SystemExit(f"[{tag}] {label}: exit code {p.returncode}")
    log(f"[{tag}] {label}: {len(cmds)} launch(es) at once, {time.time() - t0:.1f} s wall")
    return outs


def torchrun_cmd(nproc: int, args: list) -> list:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
            str(nproc)] + args


def torchrun(nproc: int, args: list, label: str, timeout: float = 300.0) -> str:
    return launch([torchrun_cmd(nproc, args)], label, timeout)[0]


def rank_report(out: str, label: str, world: int, backend: str, needed=()) -> dict:
    """The ranks' ``comm.rank_line`` lines: every rank of the world on the
    card under ``backend``, each with a launch of every ``needed`` kernel.
    Logs them; returns the launches summed over the ranks."""
    import re

    lines = [ln for ln in out.splitlines() if re.match(r"^rank \d+/\d+ device ", ln)]
    ranks = sorted({int(ln.split()[1].split("/")[0]) for ln in lines})
    total = {}
    for ln in lines:
        log(f"[parallel] {label}: {ln}")
        counts = json.loads(ln.split("kernel launches: ", 1)[1])
        if (f"backend {backend}" not in ln or "device cuda" not in ln
                or any(counts[k] == 0 for k in needed)):
            raise SystemExit(f"[parallel] {label}: rank line fails its plan: {ln}")
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
    if ranks != list(range(world)):
        raise SystemExit(f"[parallel] {label}: ranks {ranks} reported, want {world}")
    for ln in out.splitlines():
        if "FPS end-to-end" in ln or "decoded frames" in ln or ln.startswith("[parallel]"):
            log(f"[parallel] {label}: {ln}")
    return total


def depth_check(got, want, label: str, tol: float) -> bool:
    """``got`` against ``want`` within ``tol`` of max|want|; returns
    whether the two are bit for bit equal."""
    import numpy as np

    same = bool(np.array_equal(got, want))
    rel = float(np.abs(got - want).max() / np.abs(want).max()) if got.shape == want.shape \
        else float("inf")
    ok = got.shape == want.shape and bool(np.isfinite(got).all()) and rel <= tol
    log(f"[parallel] {label}: depth {got.shape} vs single process: rel err {rel:.3e} (tol {tol}), "
        f"bit for bit {same} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"[parallel] {label} disagrees with the single-process run")
    return same


UPDATE_TOL = 0.2  # training at world size 2 against a reference run: the
# share of a parameter's elements whose change over two steps (p_2 - p_0)
# differs in sign from the reference's change, at the worst leaf.  AdamW
# moves almost every element by about lr a step whatever its gradient's
# size, so bf16 noise in the gradients flips only the elements whose
# gradient is near zero; a ZeRO-1 that drops rank 1's shard of the update
# differs in half of every leaf that it splits, one that drops the update
# in all of them.  (A norm of the difference cannot tell these apart: the
# flipped elements move by 2 lr each.)  On an H100 (700 W): data-parallel
# against one process 0.0625, ZeRO-1 against data-parallel 0.0443, the
# mutants 1.0 and 0.5165; in bf16 on the CPU 0.0616 and 0.


def update_check(got: tuple, ref: tuple, label: str, mutants: bool = False) -> None:
    """``(losses, {name: p_2 - p_0})`` of a training run against a
    reference run's: the losses within ``LOSS_TOL``, and each parameter's
    change within ``UPDATE_TOL`` of the reference's, leaf by leaf (a leaf
    that the reference left unchanged must stay unchanged).  With
    ``mutants`` the same measure is also taken of the run's changes with
    the update dropped and with rank 1's ZeRO-1 shard of every leaf that
    ``zero1_spec`` splits dropped: each must miss."""
    import torch

    from video_depth_anything_torch.train.trainer import zero1_spec

    (losses, delta), (ref_losses, ref_delta) = got, ref

    def worst(d):
        share, leaf = 0.0, None
        for k, r in ref_delta.items():
            x = float((torch.sign(d[k]) != torch.sign(r)).float().mean()) if r.numel() else 0.0
            if leaf is None or x > share:
                share, leaf = x, k
        return share, leaf

    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    share, leaf = worst(delta)
    whole = float(sum((delta[k] - r).pow(2).sum() for k, r in ref_delta.items()) ** 0.5
                  / sum(r.pow(2).sum() for r in ref_delta.values()) ** 0.5)
    moved = sum(1 for r in ref_delta.values() if bool(r.any()))
    ok = loss_rel <= LOSS_TOL and share <= UPDATE_TOL and len(losses) == len(ref_losses)
    log(f"[parallel] {label}: loss rel {loss_rel:.3e} (tol {LOSS_TOL}); parameter change over two "
        f"steps: {share:.4f} of the elements of its worst leaf {leaf} differ in sign (tol "
        f"{UPDATE_TOL}; {moved} of {len(ref_delta)} leaves changed), the change's norm rel "
        f"{whole:.3e} over all leaves {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"[parallel] {label}: the runs disagree")
    if not mutants:
        return

    def drop_shard(d):
        spec = zero1_spec((), tuple(d.shape), 2)
        if "data" not in spec:
            return d
        dim = spec.index("data")
        d = d.clone()
        d.narrow(dim, d.shape[dim] // 2, d.shape[dim] // 2).zero_()
        return d

    for name, mutant in (("update dropped", {k: torch.zeros_like(v) for k, v in delta.items()}),
                         ("rank 1's shard dropped", {k: drop_shard(v) for k, v in delta.items()})):
        m_share, m_leaf = worst(mutant)
        log(f"[parallel] {label}, mutant {name}: {m_share:.4f} at {m_leaf} "
            f"{'misses' if m_share > UPDATE_TOL else 'PASSES'}")
        if m_share <= UPDATE_TOL:
            raise SystemExit(f"[parallel] {label}: the check cannot see the {name} mutant")


def phase_parallel(smi: str) -> dict:
    """The multi-GPU layer on the one card; returns the launches of the
    ranks' main-path runs, summed.  Every run decodes with cv2
    (``VDA_NATIVE_DECODE=0``, as the JAX package's multi-host tests pin it):
    the data-parallel ranks decode their spans with cv2
    (``read_video_frame_range``, as in JAX), so the single-process runs that
    they are held to bit for bit decode with cv2 too."""
    prev = os.environ.get("VDA_NATIVE_DECODE")
    os.environ["VDA_NATIVE_DECODE"] = "0"
    try:
        return _phase_parallel(smi)
    finally:
        if prev is None:
            os.environ.pop("VDA_NATIVE_DECODE")
        else:
            os.environ["VDA_NATIVE_DECODE"] = prev


def _phase_parallel(smi: str) -> dict:
    import numpy as np
    import torch

    from video_depth_anything_torch import run
    from video_depth_anything_torch.parallel.multihost import host_window_spans

    torch.cuda.empty_cache()
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    runner = ["-m", "video_depth_anything_torch.run", "--encoder", "vits", "--random_init",
              "--save_npz"]
    with tempfile.TemporaryDirectory() as tmp:
        clip = os.path.join(tmp, "square.mp4")
        write_clip(clip, 480, 480)

        def depth_of(out_dir):
            return np.load(os.path.join(out_dir, "square_depth.npz"))["depth"]

        # the single-process runs the parallel ones are held to
        single = {}
        for key, extra in (("window", []),
                           ("stream", ["--process_single_image"]),
                           ("kv", ["--process_single_image", "--kv_cache"])):
            out = os.path.join(tmp, f"single_{key}")
            limit = [] if key == "window" else ["--max_len", str(PARALLEL_STREAM_FRAMES)]
            run.main(runner[2:] + ["--input_video", clip, "--output_dir", out] + extra + limit)
            single[key] = depth_of(out)

        torch.cuda.empty_cache()
        # The runs start in two groups, each all at once (about 55 and 45 GB
        # of the card at their peaks).  First: world size 1 over NCCL
        # (torchrun, one rank); over gloo, two ranks sharing the card: the
        # data-parallel CLI, the multi-host CLI (two processes, one a host)
        # and tensor-parallel streaming with the feature cache
        dp_dir, mh_dir = os.path.join(tmp, "dp2"), os.path.join(tmp, "mh2")
        port = free_port()
        modes = (("stream", ["--process_single_image"]),
                 ("kv", ["--process_single_image", "--kv_cache"]))

        def tp_stream(key, extra):
            return torchrun_cmd(2, runner + [
                "--input_video", clip, "--output_dir", os.path.join(tmp, f"tp_{key}"),
                "--model_parallel", "2", "--max_len", str(PARALLEL_STREAM_FRAMES)] + extra)

        nccl_out, dp_out, mh_out_0, mh_out_1, fc_out = launch(
            [torchrun_cmd(1, runner + ["--input_video", clip, "--output_dir",
                                       os.path.join(tmp, "nccl1"), "--data_parallel"]),
             torchrun_cmd(2, runner + ["--input_video", clip, "--output_dir", dp_dir,
                                       "--data_parallel"])]
            + [[sys.executable] + runner + [
                "--input_video", clip, "--output_dir", mh_dir, "--coordinator",
                f"127.0.0.1:{port}", "--num_hosts", "2", "--host_id", str(i)] for i in range(2)]
            + [tp_stream(*modes[0])],
            "run --data_parallel world 1 and 2 / --coordinator --num_hosts 2 / "
            "--process_single_image --model_parallel 2")
        mh_outs = [mh_out_0, mh_out_1]

        # 1. world size 1 over NCCL
        add(rank_report(nccl_out, "run --data_parallel vits world 1", 1, "nccl",
                        ("flash_attention", "fused_motion_module")))
        if not depth_check(depth_of(os.path.join(tmp, "nccl1")), single["window"],
                           "world 1 nccl", WINDOW_TOL):
            raise SystemExit("[parallel] world size 1 is not bit for bit the single process")

        # 2. the data-parallel and multi-host CLIs over two ranks, each rank
        # decoding its span only
        add(rank_report(dp_out, "run --data_parallel vits world 2", 2, "gloo",
                        ("flash_attention", "fused_motion_module")))
        depth_check(depth_of(dp_dir), single["window"], "run --data_parallel world 2", WINDOW_TOL)
        add(rank_report("\n".join(mh_outs), "multi-host vits 2 hosts", 2, "gloo",
                        ("flash_attention", "fused_motion_module")))
        spans = host_window_spans(76, 2)
        for i, span in enumerate(spans):
            want = f"rank {i} decoded frames [{span.frame_start}, {min(span.frame_stop, 76)}) of 76"
            for label, o in (("run --data_parallel", dp_out), ("multi-host", mh_outs[i])):
                if want not in o:
                    raise SystemExit(f"[parallel] {label} rank {i} did not decode its span only: "
                                     f"{want!r}")
            log(f"[parallel] run --data_parallel and multi-host: {want} (span {span})")
        depth_check(depth_of(mh_dir), single["window"], "multi-host world 2", WINDOW_TOL)

        # Then: vitl at full width, 518x518, one window (22 frames, padded
        # to 32) through the CLI, pipeline-parallel and tensor-parallel over
        # two ranks, against the single-process CLI on one .pth of noised
        # weights; training at world size 2, data-parallel and ZeRO-1,
        # beside the single process on the same global batch; and
        # tensor-parallel streaming with the KV cache
        vitl_clip, vitl_ckpt = os.path.join(tmp, "vitl.mp4"), os.path.join(tmp, "noised_vitl.pth")
        write_clip(vitl_clip, 518, 518, 22)
        write_noised_pth("vitl", vitl_ckpt, "cuda")
        vitl = ["--encoder", "vitl", "--checkpoint", vitl_ckpt, "--input_size", "518",
                "--save_npz", "--input_video", vitl_clip]
        run.main(vitl + ["--output_dir", os.path.join(tmp, "vitl_single")])
        torch.cuda.empty_cache()
        want = np.load(os.path.join(tmp, "vitl_single", "vitl_depth.npz"))["depth"]
        vitl_runs = (("pp", ["--pipeline_parallel", "2", "--pp_microbatches", "8"]),
                     ("tp", ["--model_parallel", "2"]))
        root, vits_ckpt = os.path.join(tmp, "po"), os.path.join(tmp, "noised_vits.pth")
        write_pointodyssey(root, scenes=1, frames=24, h=270, w=480)
        write_noised_pth("vits", vits_ckpt, "cuda")
        train = ["-m", "video_depth_anything_torch.train", "--dataset", "pointodyssey", "--root",
                 root, "--encoder", "vits", "--init_checkpoint", vits_ckpt, "--train_encoder",
                 "--input_size", "266", "--clip_len", "8", "--batch_size", "2", "--steps", "2",
                 "--log_every", "1"]
        train_runs = (("single", [sys.executable] + train, []),
                      ("data-parallel", torchrun_cmd(2, train), []),
                      ("--zero1", torchrun_cmd(2, train), ["--zero1"]))
        outs = launch(
            [torchrun_cmd(2, ["-m", "video_depth_anything_torch.run"] + vitl + [
                "--output_dir", os.path.join(tmp, f"vitl_{key}")] + extra)
             for key, extra in vitl_runs]
            + [cmd + ["--out", os.path.join(tmp, f"train_{i}")] + extra
               for i, (_, cmd, extra) in enumerate(train_runs)]
            + [tp_stream(*modes[1])],
            "run vitl --pipeline_parallel 2 / --model_parallel 2 / train (one process), train and "
            "train --zero1 (world 2) / --kv_cache --model_parallel 2", timeout=400)

        # 3. tensor-parallel streaming
        for (key, extra), out in zip(modes, (fc_out, outs[-1])):
            label = f"run {' '.join(extra)} --model_parallel 2"
            add(rank_report(out, label, 2, "gloo", ("flash_attention",)))
            depth_check(depth_of(os.path.join(tmp, f"tp_{key}")), single[key], label, STREAM_TOL)

        # 4. the vitl windows: PP bit for bit, TP within the window tolerance
        for (key, extra), out in zip(vitl_runs, outs):
            label = f"run vitl 518x518 {' '.join(extra)}"
            add(rank_report(out, label, 2, "gloo",
                            ("flash_attention", "fused_motion_module", "output_tail")))
            got = np.load(os.path.join(tmp, f"vitl_{key}", "vitl_depth.npz"))["depth"]
            same = depth_check(got, want, label, WINDOW_TOL)
            if key == "pp" and not same:
                raise SystemExit(f"[parallel] {label} is not bit for bit the single process")

        # 5. training, held leaf by leaf on what two steps changed
        init = torch.load(vits_ckpt, weights_only=True)
        trained = {}
        for i, ((name, _, _), out) in enumerate(zip(train_runs, outs[len(vitl_runs):-1])):
            if name != "single":
                add(rank_report(out, f"train {name} world 2", 2, "gloo",
                                ("flash_attention", "flash_attention_bwd")))
            out_dir = os.path.join(tmp, f"train_{i}")
            lines = [json.loads(x) for x in open(os.path.join(out_dir, "train_log.jsonl"))]
            final = torch.load(os.path.join(out_dir, "step_0000002.pth"), weights_only=True)
            trained[name] = ([x["loss"] for x in lines],
                             {k: final[k].float() - init[k].float() for k in init})
            log(f"[parallel] train {name} vits 2 clips x 8 x 266x266: losses {trained[name][0]}, "
                f"steps/s {lines[-1]['sps']} (beside the vitl runs on the card, {smi})")
        for got, ref in (("data-parallel", "single"), ("--zero1", "data-parallel")):
            update_check(trained[got], trained[ref], f"train {got} vs {ref}",
                         mutants=got == "--zero1")
    log(f"[parallel] launches over the ranks' main-path runs: {totals} ({smi}; two ranks share "
        f"the one card: no scaling result)")
    return totals


# -- phase tooling: native host libraries, demo server, profiling, examples ----

PREPROC_TOL = 2e-3  # the native preprocessing against the cv2 path, max abs
# over the normalised frames: the JAX package's own bound
# (tests/test_native_preproc.py:20-24; the same bicubic taps, summed in
# another order)
DEMO_PIXEL_TOL = 0.5  # a served depth video against run's on the same clip
# and weights, mean abs over the decoded pixels (0-255): the same pipeline on
# the same card gives the same depth, and each video is written by the same
# save_video; only a different cuBLAS choice between two processes could
# move a colour by a level
DECODE_CASES = ((12, -1, -1), (8, 10, -1), (6, -1, 400), (5, 8, 320))  # JAX's four
DEMO_UPLOADS = (("init", "vits"), ("init", "vitb"), ("init", "vitl"), ("vits.pth", "vits"))


def native_checks(tmp: str, smi: str) -> dict:
    """The native libraries built from ``native/*.cpp`` on this host:
    preprocessing within PREPROC_TOL of the cv2 path, the gather bit for
    bit, the decoder's pixels those of cv2 in JAX's four cases (on a
    848-wide clip; on an 854-wide one the binding refuses the library and
    cv2 decodes); then a 76-frame 854x480 vits window CLI run with both
    switches off and then on (one run each: the script's time limit), its frames/s and the
    host paths it printed, and the CLI on the 848-wide clip, whose decode
    must be native.  Returns whether each library built."""
    import io

    import numpy as np

    from video_depth_anything_torch import run
    from video_depth_anything_torch.io import native_build
    from video_depth_anything_torch.io.native_preproc import gather_windows_native
    from video_depth_anything_torch.io.video import last_decoder, read_video_frames, save_video
    from video_depth_anything_torch.utils.transform import preprocess_frames

    status = native_build.status()
    built = {name: native_build.load(name) is not None for name in native_build.LIBS}
    for name, line in status.items():
        log(f"[tooling] native {name}: {line}")
    env = {k: os.environ.get(k) for k in ("VDA_NATIVE_PREPROC", "VDA_NATIVE_DECODE")}

    def switch(on: bool) -> None:
        os.environ["VDA_NATIVE_PREPROC"] = os.environ["VDA_NATIVE_DECODE"] = "1" if on else "0"

    try:
        if built["preproc"]:
            frames = (np.random.RandomState(7).rand(16, 480, 854, 3) * 255).astype(np.uint8)
            switch(False)
            want = preprocess_frames(frames)
            switch(True)
            t0 = time.perf_counter()
            got = preprocess_frames(frames)
            native_s = time.perf_counter() - t0
            err = float(np.abs(got - want).max())
            idx = np.stack([np.arange(16), np.arange(16)[::-1]])
            same = bool(np.array_equal(gather_windows_native(got, idx), got[idx]))
            ok = got.shape == want.shape and err < PREPROC_TOL and same
            log(f"[tooling] native preprocessing 16x480x854 -> {got.shape[1]}x{got.shape[2]}: "
                f"max abs err vs cv2 {err:.3e} (tol {PREPROC_TOL}), {16 / native_s:.1f} "
                f"frames/s; gather bit for bit {same} {'OK' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("the native preprocessing misses the cv2 path")
        if built["decode"]:
            # 848 = 53 * 16: the decoder runs; 854 (DAVIS): it is refused
            # (io/native_video.py: wrong last columns there) and cv2 decodes
            for width, path in ((848, "native"), (854, "cv2")):
                clip = os.path.join(tmp, f"decode{width}.mp4")
                save_video(clip_frames(480, width, 40), clip, fps=24)
                for case in DECODE_CASES:
                    switch(True)
                    got, fps = read_video_frames(clip, *case)
                    ran = last_decoder()
                    switch(False)
                    want, want_fps = read_video_frames(clip, *case)
                    same = got.shape == want.shape and bool(np.array_equal(got, want))
                    ok = same and fps == want_fps and ran == path
                    log(f"[tooling] decode 480x{width} {case} with the native switch on: "
                        f"{ran}, {got.shape}, fps {fps}, pixels equal to cv2's {same} "
                        f"{'OK' if ok else 'FAIL'}")
                    if not ok:
                        raise SystemExit("the native decoder disagrees with cv2")
        clip = os.path.join(tmp, "cli76.mp4")
        write_clip(clip, 480, 854)
        depths = {}
        for i, on in enumerate((False, True)):
            switch(on)
            out_dir = os.path.join(tmp, f"cli76_{i}")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):  # the depths of the first off and on runs
                run.main(["--input_video", clip, "--output_dir", out_dir, "--random_init"]
                         + ["--save_npz"] * (i < 2))
            text = buf.getvalue()
            fps_line = next(ln for ln in text.splitlines() if "FPS end-to-end" in ln)
            paths = json.loads(text.split("host paths: ", 1)[1].splitlines()[0])
            want = {"decode": "cv2",  # 854 wide: the native decoder refuses it
                    "preprocess": "native" if on and built["preproc"] else "cv2"}
            if i < 2:
                depths[on] = np.load(os.path.join(out_dir, "cli76_depth.npz"))["depth"]
            log(f"[tooling] window CLI vits 854x480 76 frames, native {'on' if on else 'off'}: "
                f"{fps_line.strip()}; host paths {paths} ({smi})")
            if paths != want:
                raise SystemExit(f"the CLI ran host paths {paths}, want {want}")
        rel = float(np.abs(depths[True] - depths[False]).max() / np.abs(depths[False]).max())
        log(f"[tooling] window CLI depth, native on against off: rel {rel:.3e} (tol {WINDOW_TOL})")
        if not rel <= WINDOW_TOL:
            raise SystemExit("the native host path moves the CLI's depth")
        if built["decode"]:
            switch(True)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                run.main(["--input_video", os.path.join(tmp, "decode848.mp4"), "--output_dir",
                          os.path.join(tmp, "cli848"), "--random_init", "--max_len", "32"])
            paths = json.loads(buf.getvalue().split("host paths: ", 1)[1].splitlines()[0])
            log(f"[tooling] window CLI vits 848x480 32 frames, native on: host paths {paths}")
            if paths != {"decode": "native", "preprocess": "native" if built["preproc"] else "cv2"}:
                raise SystemExit(f"the CLI ran host paths {paths} on a 848-wide clip")
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return built


def upload(base: str, path: str, fields: dict) -> str:
    """POST ``path`` to the demo server's ``/process`` as its form does;
    returns the result page."""
    import urllib.request

    boundary = "----vdaboundary"
    parts = [f"--{boundary}\r\nContent-Disposition: form-data; name=\"{k}\"\r\n\r\n{v}\r\n"
             .encode() for k, v in fields.items()]
    with open(path, "rb") as f:
        parts.append(f"--{boundary}\r\nContent-Disposition: form-data; name=\"video\"; "
                     f"filename=\"{os.path.basename(path)}\"\r\nContent-Type: video/mp4\r\n\r\n"
                     .encode() + f.read() + b"\r\n")
    req = urllib.request.Request(
        base + "/process", data=b"".join(parts) + f"--{boundary}--\r\n".encode(),
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.read().decode()


def demo_server_check(tmp: str, smi: str) -> dict:
    """``python -m video_depth_anything_torch.app`` twice, at once: with the
    seeded init (uploads for vits, vitb and vitl) and with a ``.pth`` of
    noised vits weights (one upload); each request's depth video, fetched
    from ``/files/``, against ``run``'s on the same clip and weights
    (DEMO_PIXEL_TOL), and its launches, read from the server's printed line
    (Kernels A and C in every request).  Returns the launches summed over
    the requests."""
    import io
    import subprocess
    import threading
    import urllib.request

    import numpy as np

    from video_depth_anything_torch import run
    from video_depth_anything_torch.io.video import read_video_frames, save_video

    clip = os.path.join(tmp, "demo.mp4")
    save_video(clip_frames(480, 480, 32), clip, fps=24)
    ckpt = os.path.join(tmp, "vits.pth")
    write_noised_pth("vits", ckpt, "cuda")
    servers = {}
    for name, extra in (("init", []), ("vits.pth", ["--checkpoint", ckpt])):
        port = free_port()
        logf = open(os.path.join(tmp, f"server_{name}.log"), "w")
        proc = subprocess.Popen([sys.executable, "-m", "video_depth_anything_torch.app", "--port",
                                 str(port), *extra], cwd=REPO, env=rank_env(), stdout=logf,
                                stderr=subprocess.STDOUT, text=True)
        servers[name] = (proc, f"http://127.0.0.1:{port}", logf)
    results, errors = {}, []

    def client(name: str, uploads: list) -> None:
        proc, base, _ = servers[name]
        try:
            for _ in range(600):  # the server binds within seconds of its start
                try:
                    with urllib.request.urlopen(base + "/", timeout=5) as r:
                        assert "Generate depth" in r.read().decode()
                    break
                except OSError:
                    if proc.poll() is not None:
                        raise RuntimeError(f"server {name} exited {proc.returncode}")
                    time.sleep(0.2)
            for encoder in uploads:
                t0 = time.perf_counter()
                page = upload(base, clip, {"encoder": encoder, "max_len": "32",
                                           "target_fps": "-1", "max_res": "1280",
                                           "input_size": "518"})
                depth = page.split('src="/files/')[2].split('"')[0]
                with urllib.request.urlopen(f"{base}/files/{depth}", timeout=60) as r:
                    data = r.read()
                path = os.path.join(tmp, f"served_{name}_{encoder}.mp4")
                with open(path, "wb") as f:
                    f.write(data)
                results[(name, encoder)] = (path, time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001 - reported by the caller
            errors.append(f"{name}: {e!r}")

    t0 = time.time()
    try:
        clients = [threading.Thread(target=client, args=(name, [e for n, e in DEMO_UPLOADS
                                                               if n == name]))
                   for name in servers]
        for c in clients:
            c.start()
        refs = {}
        for name, encoder in DEMO_UPLOADS:  # run beside the servers, on the same clip
            out_dir = os.path.join(tmp, f"run_{name}_{encoder}")
            weights = ["--random_init"] if name == "init" else ["--checkpoint", ckpt]
            with contextlib.redirect_stdout(io.StringIO()):
                run.main(["--input_video", clip, "--output_dir", out_dir, "--encoder", encoder,
                          "--max_len", "32", *weights])
            refs[(name, encoder)] = os.path.join(out_dir, "demo_depth.mp4")
        for c in clients:
            c.join(timeout=600)
    finally:
        for proc, _, logf in servers.values():
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            logf.close()
    if errors or len(results) != len(DEMO_UPLOADS):
        for name in servers:
            log(open(os.path.join(tmp, f"server_{name}.log")).read()[-4000:])
        raise SystemExit(f"[tooling] demo server failed: {errors}")
    total = {}
    lines = {name: [ln for ln in open(os.path.join(tmp, f"server_{name}.log")).read().splitlines()
                    if ln.startswith("[app] request ")] for name in servers}
    for name, encoder in DEMO_UPLOADS:
        i = [e for n, e in DEMO_UPLOADS if n == name].index(encoder)
        line = lines[name][i]
        counts = json.loads(line.split("kernel launches ", 1)[1].split(" host paths ", 1)[0])
        got = read_video_frames(results[(name, encoder)][0])[0].astype(np.float32)
        want = read_video_frames(refs[(name, encoder)])[0].astype(np.float32)
        diff = float(np.abs(got - want).mean()) if got.shape == want.shape else float("inf")
        ok = (f" {encoder}: " in line and diff <= DEMO_PIXEL_TOL and got.shape == (32, 480, 480, 3)
              and counts["flash_attention"] > 0 and counts["fused_motion_module"] > 0)
        log(f"[tooling] demo server ({name}) {encoder}: depth video vs run's mean abs pixel diff "
            f"{diff:.4f} (tol {DEMO_PIXEL_TOL}), request {results[(name, encoder)][1]:.1f} s; "
            f"{line} {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"[tooling] demo server request {name} {encoder} failed")
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
    log(f"[tooling] demo server: {len(DEMO_UPLOADS)} requests on 2 servers in "
        f"{time.time() - t0:.1f} s ({smi})")
    return total


PROFILE_FRAMES = {"vits": 32, "vitl": 8}  # profile_model's frames in phase tooling


def phase_tooling(dev, smi: str) -> dict:
    """The tooling on the card: ``native_checks``; the demo server
    (``demo_server_check``), with ``profile_model`` for vits at 518x518x32
    and ``examples.quickstart`` started beside it (their times are then
    shared ones), then ``profile_model`` for vitl at 518x518x8 (8 frames:
    the script's time limit), ``param_counts`` held to the port's own
    module; ``examples.feature_pca``'s level features on the card against
    the CPU's (fp32, TF32 off); ``tools.stress`` alone for 2 s.  Returns
    the demo requests' launches."""
    import re
    import shutil

    import numpy as np
    import torch

    from video_depth_anything_torch.config import get_model_config
    from video_depth_anything_torch.examples import feature_pca
    from video_depth_anything_torch.models.vda import VideoDepthAnything
    from video_depth_anything_torch.utils.profiling import param_counts

    from concurrent.futures import ThreadPoolExecutor

    tmp = tempfile.mkdtemp(prefix="vda_tooling_")
    try:
        native_checks(tmp, smi)
        clip = os.path.join(tmp, "quick.mp4")
        write_clip(clip, 480, 854, 40)
        quick_out = os.path.join(tmp, "quick_depth.mp4")
        m = "video_depth_anything_torch"
        profile = [[sys.executable, "-m", f"{m}.profile_model", "--encoder", e, "--frames",
                    str(PROFILE_FRAMES[e]), "--size", "518"] for e in ("vits", "vitl")]
        quick = [sys.executable, "-m", f"{m}.examples.quickstart", clip, "--output", quick_out]
        with ThreadPoolExecutor(1) as pool:
            # vits's profile and quickstart run beside the demo servers; vitl's
            # (its plain path peaks at ~35 GB) after them
            group = pool.submit(launch, [profile[0], quick], "profile_model vits; quickstart",
                                300.0, "tooling")
            launches = demo_server_check(tmp, smi)
            outs = group.result()
        outs = [outs[0], launch([profile[1]], "profile_model vitl", tag="tooling")[0], outs[1]]
        for encoder, out in zip(("vits", "vitl"), outs):
            report = json.loads(out[out.index("{"):])
            with torch.device("meta"):
                want = param_counts(VideoDepthAnything(get_model_config(encoder)))
            got = {k: report[k] for k in want}
            ok = got == want and report["compiled"]["gflops"] > 0 and report["frames_per_s"] > 0
            log(f"[tooling] profile_model {encoder} 518x518x{PROFILE_FRAMES[encoder]}: "
                f"{json.dumps(report)} "
                f"({'beside the demo servers; ' if encoder == 'vits' else ''}{smi}) params {'OK' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"profile_model {encoder}: {got} against the module's {want}")
        log(f"[tooling] quickstart: {outs[2].strip().splitlines()[-1]}")
        if not os.path.exists(quick_out) or "(40 frames)" not in outs[2]:
            raise SystemExit("examples.quickstart wrote no depth of the clip's 40 frames")

        with no_tf32():
            frames, card = feature_pca.level_features(clip, "cuda")
        _, cpu = feature_pca.level_features(clip, "cpu")
        rel = max(float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(card, cpu))
        ok = rel <= F32_WINDOW_TOL and [a.shape for a in card] == [b.shape for b in cpu]
        log(f"[tooling] feature_pca level features on the card: "
            f"{', '.join('x'.join(map(str, a.shape)) for a in card)}, rel err vs the CPU "
            f"{rel:.3e} (tol {F32_WINDOW_TOL}) {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("feature_pca's features on the card miss the CPU's")

        out = launch([[sys.executable, "-m", f"{m}.tools.stress", "--gb", "16", "--seconds",
                       "2"]], "tools.stress", tag="tooling")[0]
        spun = next(ln for ln in out.splitlines() if ln.startswith("spun "))
        log(f"[tooling] stress: {out.splitlines()[0]}; {spun} ({smi})")
        if not re.search(r"finite True$", spun):
            raise SystemExit("tools.stress ended with non-finite products")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# -- phase fp32: the fp32 kernels and --fp32 / --fp32_island ------------------

PEAK_FP32 = 67e12  # H100 SXM fp32 FLOP/s outside the tensor cores (data sheet)
PEAK_TF32 = 495e12  # H100 SXM dense TF32 FLOP/s on the tensor cores (data sheet)
F32_TOL = 1e-4  # an fp32 kernel against its plain fp32 version (TF32 off),
# relative to max|plain| (Kernel C: max|plain - x|): both sum fp32 products
# in another order (about 1e-6 apart); one TF32 pass (10 mantissa bits)
# misses by more, which the tf32_plain mutant shows (``tf32_plain``)
F32_WINDOW_TOL = 1e-3  # an fp32 window, kernel path against plain path,
# relative to max|depth|
# The fp32 launches of one 518x518 window (the gates of tests/test_torch_fp32.py):
# Kernel A in every ViT block, Kernel B at vits m0 and m2 and vitb m2 (two
# attentions each), Kernel C at m3; no bf16 kernel and no tail.
F32_WINDOW_PLANS = {
    "vits": dict(flash_attention_f32=12, temporal_attention_f32=4, fused_motion_module_f32=1),
    "vitb": dict(flash_attention_f32=12, temporal_attention_f32=2, fused_motion_module_f32=1),
    "vitl": dict(flash_attention_f32=24, temporal_attention_f32=0, fused_motion_module_f32=1),
}
# and under --attn_impl pallas (the gates of PALLAS_WINDOW_PLANS): Kernel B's
# fp32 launches of one window by head width
F32_PALLAS_WIDTHS = {"vits": {24: 2, 48: 2, 8: 2}, "vitl": {128: 4, 32: 2}}


def bound_f32(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def tf32_round(t):
    """fp32 ``t`` rounded to TF32 (10 mantissa bits, to nearest)."""
    import torch

    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32).view(t.shape)


def tf32_plain(plain, *inputs):
    """``plain`` as one TF32 pass computes it: every input rounded to TF32
    and matrix products with ``allow_tf32`` (cuBLAS leaves the skinny
    products of Kernel B's plain version in fp32 even then, so the rounded
    inputs make its products TF32 products all the same)."""
    import torch

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return plain(*(tf32_round(t) for t in inputs))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def tf32_split_plain(q, k, v, scale, fast: bool, mutant: str):
    """Kernel A's fp32 attention with its products split as a wrong 3xTF32
    kernel would split them, in plain torch on ``(B, N, H, D)`` (run with
    TF32 off: products of TF32-valued operands are then exact fp32 FMAs):
    ``two_pass`` drops the lo·hi term of both products; ``truncating_split``
    feeds each raw operand as its hi (the tensor cores read it truncated)
    beside the lo of a rounded hi; any other value gives the kernel's three
    passes."""
    import torch

    def split(x):
        hi = tf32_round(x)
        lo = tf32_round(x - hi)
        if mutant == "truncating_split":
            hi = (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32).view(x.shape)
        return hi, lo

    def product(a, b):
        (ahi, alo), (bhi, blo) = split(a), split(b)
        if mutant == "two_pass":
            return ahi @ blo + ahi @ bhi
        return alo @ bhi + ahi @ blo + ahi @ bhi

    qs, kt, vt = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    s = product(qs * (scale * 1.4426950408889634), kt.transpose(-1, -2))
    p = torch.exp2(s if fast else s - s.amax(-1, keepdim=True))
    return (product(p, vt) / p.sum(-1, keepdim=True)).permute(0, 2, 1, 3)


def motion_split_plain(x, p: dict, cfg, heads: int, mutant: str):
    """Kernel C's fp32 motion module with its weight products split as a
    wrong 3xTF32 kernel would split them (``motion_module_plain`` with its
    ``product``; run with TF32 off: products of TF32-valued operands are
    then exact fp32 FMAs): ``two_pass`` drops the lo·hi term,
    ``truncating_split`` feeds each raw operand as its hi (the tensor cores
    read it truncated) beside the lo of a rounded hi; any other value gives
    the kernel's three passes."""
    import torch

    from video_depth_anything_torch.ops.motion_module import motion_module_plain

    def split(t):
        hi = tf32_round(t)
        lo = tf32_round(t - hi)
        if mutant == "truncating_split":
            hi = (t.contiguous().view(torch.int32) & -0x2000).view(torch.float32).view(t.shape)
        return hi, lo

    def product(a, w):
        (ahi, alo), (whi, wlo) = split(a), split(w)
        if mutant == "two_pass":
            return ahi @ wlo + ahi @ whi
        return alo @ whi + ahi @ wlo + ahi @ whi

    return motion_module_plain(x, p, cfg, heads, product=product)


def f32_inputs(shape, gen, device):
    """fp32 ``(..., 3 * C)`` as ``attention_inputs`` draws them, left in fp32
    (bf16-valued inputs would pass through TF32 exactly)."""
    import torch

    x = torch.randn(*shape[:-1], 3 * shape[-1], generator=gen, device=device)
    x[..., : 2 * shape[-1]] *= QK_STD
    return x


def attention_f32_row(label: str, bt: int, n: int, h: int, d: int, fast: bool, g, dev) -> dict:
    """The fp32 Kernel A against its plain fp32 version (``fp32_kernel_rows``)."""
    import torch
    import torch.nn.functional as F

    from video_depth_anything_torch.ops import flash_attention as fa
    from video_depth_anything_torch.utils.device import event_ms as time_ms

    qkv = f32_inputs((bt, n, h * d), g, dev)
    q, k, v = (t.view(bt, n, h, d) for t in qkv.split(h * d, dim=-1))
    scale = d**-0.5
    plain = lambda q_, k_, v_, sc: fa.flash_attention_plain(q_, k_, v_, sc, fast=fast)  # noqa: E731
    got = fa.flash_attention(q, k, v, scale, fast=fast)
    want = plain(q, k, v, scale)
    key_tile = 64 if d == 64 else 32  # the fp32 kernel's
    mutants = mutant_errors(plain, q, k, v, scale, axis=1, tile=key_tile)
    qf = flat_inputs(q)
    flat_err = rel_err(fa.flash_attention(qf, k, v, scale, fast=fast), plain(qf, k, v, scale))
    mutants["unmasked_zero_pad"] = zero_pad_error(plain, qf, k, v, scale, key_tile)
    mutants["tf32_plain"] = rel_err(tf32_plain(lambda *t: plain(*t, scale), q, k, v), want)
    for wrong in ("two_pass", "truncating_split"):
        mutants[wrong] = rel_err(tf32_split_plain(q, k, v, scale, fast, wrong), want)
    bf16_err = rel_err(fa.flash_attention(*(t.to(torch.bfloat16) for t in (q, k, v)), scale,
                                          fast=fast), want)
    ms = time_ms(lambda: fa.flash_attention(q, k, v, scale, fast=fast), iters=5, warmup=1)
    plain_ms = time_ms(lambda: plain(q, k, v, scale), iters=3, warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), iters=5,
                     warmup=1)
    flops = 4.0 * bt * h * n * n * d
    ffma_ms, _ = bound_f32(flops, 4.0 * bt * n * h * d * 4)
    b_ms = 3 * flops / PEAK_TF32 * 1e3  # 3xTF32 on the tensor cores
    return dict(kernel="flash_attention_f32", shape=f"{label} (B*T={bt}, N={n}, H={h}, D={d})",
                 max_abs_err=max_err(got, want), rel_err=max(rel_err(got, want), flat_err),
                 tol=F32_TOL, mutants=mutants, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                 bound_by="operations", library_ms=lib_ms,
                 extra=f" (peaked {rel_err(got, want):.3e}, flat {flat_err:.3e}) "
                       f"bf16_kernel_rel_err={bf16_err:.3e} bound_3xtf32_ms={b_ms:.4f} "
                       f"ms/bound_3xtf32={ms / b_ms:.2f} bound_ffma_ms={ffma_ms:.4f} "
                       f"ms/bound_ffma={ms / ffma_ms:.2f}")


def motion_f32_row(label: str, c: int, s: int, t: int, g, dev) -> dict:
    """The fp32 Kernel C against its plain fp32 version (``fp32_kernel_rows``)."""
    import torch

    from video_depth_anything_torch.config import MotionModuleConfig
    from video_depth_anything_torch.ops import motion_module as mm
    from video_depth_anything_torch.utils.device import event_ms as time_ms

    cfg = MotionModuleConfig()
    b = 1
    x = torch.randn(b, t, s, c, device=dev, generator=g)
    p = motion_params(c, seed=c, device=dev)
    w = mm.kernel_weights(p, cfg, torch.float32)
    gna, gnb = mm.gn_fold(x, w, cfg)
    got = mm.motion_module_launch(x, gna, gnb, w, cfg, 8)
    want = mm.motion_module_plain(x, p, cfg, 8)
    base = float((want - x).abs().max())
    mutants = motion_mutant_errors(x, p, cfg, 8)
    if not mm.resident(c, 8, cfg):
        mutants.update(wide_chain_mutant_errors(x, p, cfg, 8, want))
    names = tuple(p)
    mutants["tf32_plain"] = max_err(tf32_plain(
        lambda x_, *v: mm.motion_module_plain(x_, dict(zip(names, v)), cfg, 8), x,
        *p.values()), want) / base
    for wrong in ("two_pass", "truncating_split"):
        mutants[wrong] = max_err(motion_split_plain(x, p, cfg, 8, wrong), want) / base
    bf16_err = max_err(mm.fused_motion_module(x.to(torch.bfloat16), p, cfg, 8), want) / base
    ms = time_ms(lambda: mm.motion_module_launch(x, gna, gnb, w, cfg, 8), iters=3, warmup=1)
    plain_ms = time_ms(lambda: mm.motion_module_plain(x, p, cfg, 8), iters=3, warmup=1)
    flops = b * t * s * (44.0 * c * c + 8.0 * t * c)
    ffma_ms, _ = bound_f32(flops, 2 * b * t * s * c * 4 + w["w"].numel() * 4)
    b_ms = 3 * flops / PEAK_TF32 * 1e3  # 3xTF32 on the tensor cores
    wide = not mm.resident(c, 8, cfg)
    if wide:  # each 128-row GEMM tile reads every product's weights once
        l2_gb = -(-b * t * s // mm.WIDE_BM) * w["w"].numel() * 4 / 1e9
    else:
        l2_gb = b * -(-s // (mm.F32_ROWS // mm.padded_frames(t))) * w["w"].numel() * 4 / 1e9
    name = "motion_module_wide_f32" if wide else "motion_module_f32"
    return dict(kernel=name, shape=f"{label} (B={b}, T={t}, S={s}, C={c})",
                 max_abs_err=max_err(got, want), rel_err=max_err(got, want) / base,
                 tol=F32_TOL, mutants=mutants, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                 bound_by="operations", library_ms=None,
                 extra=f" bf16_kernel_rel_err={bf16_err:.3e} bound_3xtf32_ms={b_ms:.4f} "
                       f"ms/bound_3xtf32={ms / b_ms:.2f} bound_ffma_ms={ffma_ms:.4f} "
                       f"ms/bound_ffma={ms / ffma_ms:.2f} l2_weight_gb={l2_gb:.2f}")


def fp32_kernel_rows(dev) -> list:
    """Each fp32 kernel against its plain fp32 version at phase kernels'
    shapes, with the mutants of phase kernels at fp32 and the plain version
    in one TF32 pass as one more (Kernel A also two passes and a truncating
    split, ``tf32_split_plain``); beside each row the bf16 kernel's error
    on the same inputs.  Kernels A's and C's ``bound_ms`` are their 3xTF32
    products at the tensor cores' TF32 rate, printed beside the same
    products' FFMA bound (Kernel C also with the two wrong splits of
    ``motion_split_plain`` as mutants, and the weight bytes its CTAs read
    from L2 in the call)."""
    import torch
    import torch.nn.functional as F

    from video_depth_anything_torch import bench_temporal
    from video_depth_anything_torch.ops import temporal_attention as ta
    from video_depth_anything_torch.utils.device import event_ms as time_ms

    g = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for label, bt, n, h, d, fast in (("518x518", 32, 1370, 6, 64, False),
                                     ("518x924", 32, 2443, 6, 64, False),
                                     ("518x518 fast", 32, 1370, 6, 64, True),
                                     ("518x924 fast", 32, 2443, 6, 64, True),
                                     ("synthetic D=192", 32, 1370, 2, 192, False),
                                     ("synthetic D=192 ragged fast", 32, 2443, 2, 192, True),
                                     (EVAL_ATTN[0][0], 32, EVAL_ATTN[0][1], 6, 64, False)):
        rows.append(attention_f32_row(label, bt, n, h, d, fast, g, dev))

    heads = bench_temporal.HEADS
    for label, b, t, s, c in (bench_temporal.SHAPES + bench_temporal.WINDOW_SHAPES
                              + EVAL_TEMPORAL[:2]):
        q, k, v = (x.contiguous() for x in f32_inputs((b, t, s, c), g, dev).split(c, dim=-1))
        d = c // heads
        scale = d**-0.5
        plain = lambda q_, k_, v_, sc: ta.temporal_attention_plain(q_, k_, v_, heads, sc)  # noqa: E731
        got = ta.temporal_attention(q, k, v, heads, scale)
        want = plain(q, k, v, scale)
        mutants = temporal_mutant_errors(plain, q, k, v, scale, ta.tile_plan(c, heads, 4)[0])
        mutants["tf32_plain"] = rel_err(tf32_plain(lambda *t: plain(*t, scale), q, k, v), want)
        bf16_err = rel_err(ta.temporal_attention(*(x.to(torch.bfloat16) for x in (q, k, v)), heads,
                                                 scale), want)
        ms = time_ms(lambda: ta.temporal_attention(q, k, v, heads, scale), iters=10, warmup=2)
        plain_ms = time_ms(lambda: plain(q, k, v, scale), iters=3, warmup=1)
        q5, k5, v5 = (x.view(b, t, s, heads, d).permute(0, 2, 3, 1, 4) for x in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q5, k5, v5, scale=scale), iters=10,
                         warmup=2)
        b_ms, b_by = bound_f32(4.0 * b * s * c * t * t, 4.0 * b * t * s * c * 4)
        rows.append(dict(kernel="temporal_attention_f32",
                         shape=f"{label} (B={b}, T={t}, S={s}, C={c}, d={d})",
                         max_abs_err=max_err(got, want), rel_err=rel_err(got, want), tol=F32_TOL,
                         mutants=mutants, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms, extra=f" bf16_kernel_rel_err={bf16_err:.3e}"))
        del q, k, v, got, want, q5, k5, v5

    for label, c, s, t in MOTION_ROWS + EVAL_MOTION[:1] + WIDE_MOTION_ROWS:
        rows.append(motion_f32_row(label, c, s, t, g, dev))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rows


def phase_fp32(dev, smi: str):
    """The fp32 kernels against their plain versions (``fp32_kernel_rows``);
    fp32 vits, vitb and vitl 518x518 windows, kernel path against plain
    path, with their exact fp32 launch plans and wall ms (kernel, then
    plain: each timed call after an untimed one of its path), and
    vits and vitl windows under ``pallas`` with Kernel B's fp32 launches by
    head width (``F32_PALLAS_WIDTHS``); the CLI with ``--fp32`` in
    window mode and with ``--process_single_image`` (the main path of the
    fp32 kernels: counts zeroed before, read after; each fp32 kernel must
    launch, no bf16 kernel may), with ``--kv_cache`` too (Kernel C never),
    and vitl with ``--fp32_island`` (the tail
    kernel never).  TF32 off in matrix products and convolutions
    throughout.  Returns ``(rows, fp32 launches of the two --fp32 runs)``."""
    import numpy as np
    import torch

    from video_depth_anything_torch import run
    from video_depth_anything_torch.models.vda import VDAModel
    from video_depth_anything_torch.ops.dispatch import plain_reference
    from video_depth_anything_torch.ops.temporal_attention import temporal_attention

    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        rows = fp32_kernel_rows(dev)
        check_rows(rows, "fp32")
        g = torch.Generator(device=dev).manual_seed(6)
        for encoder, plan in F32_WINDOW_PLANS.items():
            model = VDAModel(encoder, device=dev, dtype=torch.float32)
            noise_weights(model.module, seed=1, device=dev)
            x = torch.randn(1, 32, 518, 518, 3, device=dev, generator=g)
            zero_counts()
            got = model.infer_window(x)
            torch.cuda.synchronize()
            counts = launch_counts()
            with plain_reference():
                want = model.infer_window(x)
            ms = {"kernel": 0.0, "plain": 0.0}
            for path in ("kernel", "plain"):  # one turn each: the script's time limit
                with plain_reference() if path == "plain" else contextlib.nullcontext():
                    model.infer_window(x)  # the first call after the other path is slower
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    model.infer_window(x)
                    torch.cuda.synchronize()
                    ms[path] += (time.perf_counter() - t0) * 1e3
            rel = float((got - want).abs().max() / want.abs().max())
            finite = bool(torch.isfinite(got).all())
            ok = (finite and rel <= F32_WINDOW_TOL and all(counts[k] == n for k, n in plan.items())
                  and all(n == 0 for k, n in counts.items() if k not in plan))
            log(f"[fp32] window {encoder} 1x32x518x518 fp32: rel err kernels vs plain {rel:.3e} "
                f"(tol {F32_WINDOW_TOL}), finite={finite}, launches {counts}; kernel path "
                f"{ms['kernel']:.2f} ms ({32e3 / ms['kernel']:.1f} frames/s), plain path "
                f"{ms['plain']:.2f} ms ({32e3 / ms['plain']:.1f} frames/s) ({smi}) "
                f"{'OK' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"fp32 window of {encoder} failed")
            del model, x, got, want
            torch.cuda.empty_cache()

        for encoder, widths in F32_PALLAS_WIDTHS.items():
            model = VDAModel(encoder, device=dev, dtype=torch.float32, attn_impl="pallas")
            noise_weights(model.module, seed=1, device=dev)
            x = torch.randn(1, 32, 518, 518, 3, device=dev, generator=g)
            zero_counts()
            got = model.infer_window(x)
            torch.cuda.synchronize()
            by_width = dict(temporal_attention.f32_width_launches)
            with plain_reference():
                want = model.infer_window(x)
            rel = float((got - want).abs().max() / want.abs().max())
            ok = bool(torch.isfinite(got).all()) and rel <= F32_WINDOW_TOL and by_width == widths
            log(f"[fp32] window {encoder} 1x32x518x518 fp32 pallas: rel err kernels vs plain "
                f"{rel:.3e} (tol {F32_WINDOW_TOL}), Kernel B fp32 launches by head width "
                f"{by_width} ({smi}) {'OK' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"fp32 pallas window of {encoder} failed")
            del model, x, got, want
            torch.cuda.empty_cache()

        totals = dict.fromkeys(F32_KERNELS, 0)
        with tempfile.TemporaryDirectory() as tmp:
            clip = os.path.join(tmp, "square.mp4")
            write_clip(clip, 480, 480)
            for encoder, flags, frames in (("vits", ["--fp32"], 76),
                                           ("vits", ["--fp32", "--process_single_image"],
                                            STREAM_FRAMES),
                                           ("vits", ["--fp32", "--process_single_image",
                                                     "--kv_cache"], 76),
                                           ("vitl", ["--fp32_island"], 76)):
                zero_counts()
                rc = run.main(["--input_video", clip, "--output_dir", tmp, "--encoder", encoder,
                               "--random_init", "--save_npz"] + flags)
                delta = main_path_launches()
                depth = np.load(os.path.join(tmp, "square_depth.npz"))["depth"]
                finite = bool(np.isfinite(depth).all())
                if "--fp32" in flags:
                    totals = {k: totals[k] + delta[k] for k in totals}
                    # the KV mode never reaches Kernel C (its warm-up bypasses the fused module)
                    needed = F32_KERNELS[:2] if "--kv_cache" in flags else F32_KERNELS
                    kernels_ok = (all(delta[k] > 0 for k in needed)
                                  and all(n == 0 for k, n in delta.items() if k not in needed))
                else:  # bf16 with the island: the tail stays plain
                    kernels_ok = (delta["output_tail"] == 0 and delta["flash_attention"] > 0
                                  and delta["fused_motion_module"] > 0)
                ok = rc == 0 and depth.shape == (frames, 480, 480) and finite and kernels_ok
                log(f"[fp32] cli {encoder} 480x480 {' '.join(flags)}: rc={rc} depth {depth.shape} "
                    f"finite={finite} launches {delta} {'OK' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"cli run {encoder} {flags} failed")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    log(f"[fp32] fp32 launches over the --fp32 CLI runs: {totals} ({smi})")
    return rows, totals


# -- phase bench: python -m video_depth_anything_torch.bench -------------------

BENCH_KEYS = {  # the JAX bench.py rows' fields, without mem_static
    "window": ["encoder", "size", "frames", "batch", "compile_s", "median_window_s",
               "frames_per_s", "ms_per_frame", "mem"],
    "streaming": ["encoder", "size", "chunk", "compile_s", "median_step_s", "frames_per_s", "mem"],
    "kv_streaming": ["encoder", "size", "chunk", "aligned", "compile_s", "median_step_s",
                     "frames_per_s", "mem"],
    "train": ["encoder", "size", "frames", "clips_per_step", "compile_s", "step_s",
              "clip_frames_per_s_per_chip", "loss", "mem"],
    "data_parallel": ["encoder", "devices", "compile_s", "frames_per_s_total",
                      "frames_per_s_per_chip", "mem", "detail"],
}


def phase_bench(smi: str) -> None:
    """``python -m video_depth_anything_torch.bench`` as a subprocess with
    VDA_BENCH_FAST=1 (the card line, then the headline line), then each row
    function once at iters=2 (warmup=1): vitl's window, the feature-cache
    chunk, the aligned KV chunk, the vits training step and ``dp_vits``'s
    data-parallel window (one rank here)."""
    import subprocess

    from video_depth_anything_torch import bench

    res = subprocess.run([sys.executable, "-m", "video_depth_anything_torch.bench"], cwd=REPO,
                         env=dict(os.environ, VDA_BENCH_FAST="1"), capture_output=True, text=True,
                         timeout=600)
    lines = res.stdout.strip().splitlines()
    try:
        head = json.loads(lines[-1])
    except (IndexError, ValueError):
        head = {}
    ok = (res.returncode == 0 and len(lines) == 2 and lines[0] == smi
          and head.get("metric") == "frames/sec/chip vits 1x32x518x518 bf16"
          and head.get("value", 0) > 0)
    log(f"[bench] VDA_BENCH_FAST=1: rc={res.returncode} {lines[-1] if lines else ''} "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"the bench failed: {res.stderr[-3000:]}")
    for kind, fn in (("window", lambda: bench.bench_window("vitl", iters=2, warmup=1)),
                     ("streaming", lambda: bench.bench_streaming("vits", iters=2, warmup=1)),
                     ("kv_streaming", lambda: bench.bench_kv_streaming("vits", iters=2, warmup=1,
                                                                       chunk=8, aligned=True)),
                     ("train", lambda: bench.bench_train("vits", iters=2)),
                     ("data_parallel", lambda: bench.bench_data_parallel("vits", iters=2,
                                                                         warmup=1))):
        row = fn()
        rate = row.get("frames_per_s", row.get("clip_frames_per_s_per_chip",
                                               row.get("frames_per_s_total", 0)))
        ok = (list(row) == BENCH_KEYS[kind] and rate > 0 and row["mem"].get("peak_mb", 0) > 0)
        log(f"[bench] {kind}: {json.dumps(row)} ({smi}) {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"the bench's {kind} row failed")


if __name__ == "__main__":
    sys.exit(main())
