"""Kernel A's schedule probes on the card: the counterpart of
``scripts/bench_spatial_variants.py``.

    python -m video_depth_anything_torch.bench_spatial_variants [variant ...]

At the script's shapes (32 windows' frames of 1370 tokens, head_dim 64;
vitl with 16 heads and 24 layers, then vits with 6 and 12) and on seeded
inputs (q, k ~ N(0, 0.5²), v ~ N(0, 1), bf16), it prints one JSON line per
row with the script's keys: ``base:fast`` and ``base:exact`` run Kernel A
(``ops/flash_attention.flash_attention``, fast and exact) on the same
arrays viewed as ``(B, N, H, D)``; then each variant (the script's default
list: ilv, nomask, chunk2, chunk4, chunk8, sbf16, sbf16:fast, ceiling)
runs its probe kernel (``ops/attention_variants.spatial_variant``), with
its largest difference from ``base:fast``.  ``ms_per_call`` comes from
CUDA events (``utils/device.event_ms``); ``ms_window`` is that times the
encoder's layer count.  The card's name and power limit come first.

A variant outside the script's domain (``chunk8`` at n = 1370) prints an
``error`` row: the only exception caught is that ``ValueError``, raised
before any launch.  A build or launch error ends the run.
"""

from __future__ import annotations

import json
import sys

N, D, BATCH = 1370, 64, 32
ENCODERS = (("vitl", 16, 24), ("vits", 6, 12))


def main(argv=None) -> int:
    import torch

    from video_depth_anything_torch.ops import attention_variants as av
    from video_depth_anything_torch.ops.flash_attention import flash_attention
    from video_depth_anything_torch.utils.device import card_line, event_ms, resolve_device

    variants = list(sys.argv[1:] if argv is None else argv) or list(av.SPATIAL_VARIANTS)
    dev = resolve_device()
    print(card_line(), flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    scale = D**-0.5
    for enc, heads, layers in ENCODERS:
        hd = heads * D
        q, k, v = ((torch.randn(BATCH, N, hd, generator=gen, device=dev) * std).to(torch.bfloat16)
                   for std in (0.5, 0.5, 1.0))
        qh, kh, vh = (t.view(BATCH, N, heads, D) for t in (q, k, v))
        ref = flash_attention(qh, kh, vh, scale, fast=True).view(BATCH, N, hd)
        for fast, name in ((True, "base:fast"), (False, "base:exact")):
            ms = event_ms(lambda: flash_attention(qh, kh, vh, scale, fast=fast))
            print(json.dumps({"enc": enc, "variant": name, "ms_per_call": round(ms, 4),
                              "ms_window": round(ms * layers, 3)}), flush=True)
        for variant in variants:
            try:
                av.parse_variant(variant, N)
            except ValueError as e:
                print(json.dumps({"enc": enc, "variant": variant, "error": str(e)[:300]}),
                      flush=True)
                continue
            out = av.spatial_variant(variant, q, k, v, scale, N, heads)
            err = float((out.float() - ref.float()).abs().max())
            ms = event_ms(lambda: av.spatial_variant(variant, q, k, v, scale, N, heads))
            print(json.dumps({"enc": enc, "variant": variant, "ms_per_call": round(ms, 4),
                              "ms_window": round(ms * layers, 3),
                              "max_abs_err_vs_base": round(err, 6)}), flush=True)
        del q, k, v, qh, kh, vh, ref
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
