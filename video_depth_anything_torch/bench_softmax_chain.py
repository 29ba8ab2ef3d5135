"""The softmax-chain probe on the card: the counterpart of
``scripts/bench_softmax_chain.py``.

    python -m video_depth_anything_torch.bench_softmax_chain

At the script's shapes (512 batch-heads, 1376 queries, 1408 keys,
head_dim 64, V 128 wide; q, k ~ N(0, 0.35²), v ~ N(0, 1), bf16, seeded) it
runs the chain kernel (``ops/attention_variants.softmax_chain``) in each of
the seven modes: ``gemms`` (no softmax), ``exp`` (hardware exp2), ``exact``
(row max, subtract, hardware exp), ``sexp`` (Schraudolph bit trick),
``pexp`` (bit trick + cubic), ``bf16s`` (bf16 scores, exp2) and ``bf16x``
(bf16 scores, row max in bf16).  Then the ``prod_fast=False/True`` rows:
the JAX script times its production wrapper there; the port runs Kernel A
(``ops/flash_attention.flash_attention``) exact and fast on the 1370 valid
rows and keys, viewed as ``(512, 1370, 1, 64)``, with scale 1.0.  One JSON
line per row, ``{"mode": ..., "ms": ...}``, times from CUDA events
(``utils/device.event_ms``), after the card's name and power limit.
"""

from __future__ import annotations

BH, NQ, NK, D, DV, N_VALID = 512, 1376, 1408, 64, 128, 1370


def main(argv=None) -> int:
    import json

    import torch

    from video_depth_anything_torch.ops import attention_variants as av
    from video_depth_anything_torch.ops.flash_attention import flash_attention
    from video_depth_anything_torch.utils.device import card_line, event_ms, resolve_device

    dev = resolve_device()
    print(card_line(), flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = ((torch.randn(*shape, generator=gen, device=dev) * std).to(torch.bfloat16)
               for shape, std in (((BH, NQ, D), 0.35), ((BH, NK, D), 0.35), ((BH, NK, DV), 1.0)))
    for mode in av.CHAIN_MODES:
        ms = event_ms(lambda: av.softmax_chain(mode, q, k, v))
        print(json.dumps({"mode": mode, "ms": round(ms, 4)}), flush=True)
    qv, kv, vv = (t[:, :N_VALID, :D].unsqueeze(2) for t in (q, k, v))
    for fast in (False, True):
        ms = event_ms(lambda: flash_attention(qv, kv, vv, 1.0, fast=fast))
        print(json.dumps({"mode": f"prod_fast={fast}", "ms": round(ms, 4)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
