"""Device memory and compute stress tool (the JAX ``tools/tpu_stress.py``;
the reference's ``train.py:19-66``, a GPU memory-allocation and matmul-spin
utility despite its name).  Holds ``--gb`` of device memory in bf16
``--size``² blocks and spins ``torch.matmul`` on them for ``--seconds``;
prints the memory held and the TFLOP/s reached.  Runs on the card unless
``--device cpu``.

    python -m video_depth_anything_torch.tools.stress --gb 4 --seconds 30
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--gb", type=float, default=1.0, help="device memory to hold")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--size", type=int, default=4096, help="matmul dimension")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from video_depth_anything_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    n = args.size
    n_chunks = max(1, int(args.gb * 2**30 / (n * n * 2)))
    # entries 1/n: a product of two such blocks is the block itself, so the
    # chained products stay finite
    buffers = [torch.full((n, n), 1.0 / n, dtype=torch.bfloat16, device=dev)
               for _ in range(n_chunks)]
    held = n_chunks * n * n * 2 / 2**30
    print(f"holding {n_chunks} x {n}^2 bf16 = {held:.2f} GiB")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    acc = buffers[0]
    sync()
    t0 = time.perf_counter()
    t_end = t0 + args.seconds
    steps = 0
    while time.perf_counter() < t_end:
        for _ in range(100 if dev.type == "cuda" else 1):
            acc = torch.matmul(acc, buffers[steps % n_chunks])
            steps += 1
        sync()
    wall = time.perf_counter() - t0
    ok = bool(torch.isfinite(acc).all())
    tflops = 2.0 * n**3 * steps / wall / 1e12
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else held
    print(f"spun {steps} matmuls of {n}^3 in {wall:.2f} s: {tflops:.2f} TFLOP/s bf16; "
          f"{held:.2f} GiB held (peak allocated {peak:.2f} GiB); finite {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
