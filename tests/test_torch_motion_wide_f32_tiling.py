"""The fp32 plan of Kernel C at C = 768 and 1024 (``csrc/motion_module_wide.cu``
on fp32 operands), emulated in torch on the CPU (``emulate_wide`` of
``tests/test_torch_motion_wide_tiling.py``): the same chain of launches as
in bf16, every product in 3xTF32 (each activation panel split into hi =
rna(a) and lo = rna(a − hi) as the kernel splits its A fragments, the
weights' hi and lo tiles as ``wide_tiles_f32`` split them on the host), no
rounding to bf16, the erf GELU, the attention's out scaled by 1 / sum after
P·V.  Held within 1e-5 (relative to max|plain − x|) of the plain fp32
module at T = 8, 12, 20 and 32 with a ragged last 128-row tile, and of the
JAX Pallas kernel in interpret mode on fp32 inputs; three wrong plans miss
by more than chip_smoke.py's fp32 tolerance; the hi/lo tiles bit for bit.
The fp32 products keep 128 × 128 tiles (``wide_bn``) on the persistent walk
of ``wide_schedule``."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_fp32 import FP32_TOL, _motion_params, rel
from tests.test_torch_motion_wide_tiling import BM, emulate_wide, unswizzle
from video_depth_anything_torch.config import MotionModuleConfig as TCfg
from video_depth_anything_torch.ops import motion_module as t_motion
from video_depth_anything_tpu.config import MotionModuleConfig as JCfg
from video_depth_anything_tpu.ops.pallas_motion import fused_motion_module
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MUTANT_TOL = chip_smoke.F32_TOL  # a wrong plan must miss by more than the card's tolerance
BN = t_motion.wide_bn(4096, torch.float32)  # fp32 tiles: 128 columns at every N


@functools.lru_cache(maxsize=None)
def _case(c: int, t: int, s: int):
    """Seeded fp32 x ``(1, T, S, C)``, raw parameters, the plain output and
    the plan's."""
    p = _motion_params(c, c + t)
    x = torch.from_numpy(np.random.default_rng(c * 3 + t).standard_normal((1, t, s, c))
                         .astype(np.float32))
    return x, p, t_motion.motion_module_plain(x, p, TCfg(), 8), emulate_wide(x, p, TCfg(), 8)


@pytest.mark.parametrize("c,t,s", [(c, t, s) for c in (768, 1024)
                                   for t, s in ((8, 21), (12, 13), (20, 9), (32, 5))])
def test_wide_f32_plan_matches_plain(c, t, s):
    """Two 128-row tiles, the last ragged; T = 12 and 20 padded to Tp = 16
    and 32 key frames."""
    x, p, want, got = _case(c, t, s)
    assert (t * s) % BM
    assert rel(got, want, x) <= FP32_TOL


@pytest.mark.parametrize("c", [768, 1024])
def test_wide_f32_plan_matches_pallas_kernel(c):
    x, p, _, got = _case(c, 32, 5)
    want = fused_motion_module(jnp.asarray(x.numpy()), {k: jnp.asarray(v.numpy()) for k, v in p.items()},
                               heads=8, cfg=JCfg(), interpret=True)
    assert rel(got, np.asarray(want, np.float32), x) <= FP32_TOL


@pytest.mark.parametrize("mutant,c,t,s", [("unmasked_keys", 1024, 20, 9),
                                          ("k_from_next_head", 768, 12, 13),
                                          ("residual_not_reread", 1024, 8, 21),
                                          ("acc_carried", 768, 12, 13),
                                          ("edge_tile_skipped", 1024, 8, 21),
                                          ("geglu_halves_swapped", 768, 20, 9),
                                          ("residual_after_store", 1024, 12, 13)])
def test_wrong_wide_f32_plans_miss(mutant, c, t, s):
    x, p, want, _ = _case(c, t, s)
    assert rel(emulate_wide(x, p, TCfg(), 8, mutant=mutant), want, x) > MUTANT_TOL


@pytest.mark.parametrize("c", [768, 1024])
def test_wide_f32_tiles_split_the_jax_weights(c):
    """Each product's hi and lo tiles, un-swizzled, are rna(w) and rna(w −
    hi) of the product's (in, out) weight at (32 kp + k, 128 nb + n), bit for
    bit; hi + lo lies within 2^-21 of w."""
    p = _motion_params(c, 5)
    flat = t_motion.weight_blocks_wide(p, torch.float32)
    assert flat.numel() == 44 * c * c and flat.dtype == torch.float32
    start = 0
    assert BN == 128
    for w in t_motion.wide_products(p, torch.float32):
        k, n = w.shape
        shape = (n // BN, k // 32, 2, BN, 32)
        tiles = unswizzle(flat[start:start + int(np.prod(shape))].reshape(shape), 4)
        start += int(np.prod(shape))
        logical = tiles.permute(1, 4, 0, 3, 2).reshape(k, n, 2)  # (in, out, hi|lo)
        hi = t_motion.tf32_rna(w.float().contiguous())
        assert torch.equal(logical[..., 0], hi)
        assert torch.equal(logical[..., 1], t_motion.tf32_rna((w.float() - hi).contiguous()))
        assert float((logical.sum(-1) - w).abs().max()) <= 2.0**-21 * float(w.abs().max())
    assert start == flat.numel()
