"""Kernel C's plain version and the port's TemporalModule against the JAX
motion module (``motion_module_reference`` and ``TemporalModule``) at the
vits widths C = 64 and C = 192, the vitb widths C = 128 and 384 and the
vitl width C = 256 (Kernel C's plain version), the module with RoPE
positions, plus the host-side pieces of the kernel (GroupNorm fold, weight
tile layout)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import jax_param_shapes, noised_params
from video_depth_anything_torch.config import MotionModuleConfig as TCfg
from video_depth_anything_torch.io.checkpoint import motion_module_state
from video_depth_anything_torch.models.layers import GroupNorm
from video_depth_anything_torch.models.temporal import TemporalModule as TModule
from video_depth_anything_torch.ops import motion_module as t_motion
from video_depth_anything_tpu.config import MotionModuleConfig as JCfg
from video_depth_anything_tpu.models.temporal import TemporalModule as JModule
from video_depth_anything_tpu.ops.pallas_motion import motion_module_reference
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# fp32 on the CPU, same operations in the same order up to the GEMM
# summation order of the two frameworks.
TOL = dict(rtol=1e-4, atol=1e-4)


def _jax_module(c, t, h, w, seed, pe="ape"):
    mod = JModule(JCfg(pos_embedding_type=pe), c, "xla")
    x5 = jnp.zeros((1, t, h, w, c), jnp.float32)
    return mod, noised_params(jax_param_shapes(mod, x5), seed)


def _raw(params, n=2):
    blk = params["block_0"]
    stack = lambda f: np.stack([f(i) for i in range(n)])  # noqa: E731
    return dict(
        gn_scale=params["norm"]["scale"], gn_bias=params["norm"]["bias"],
        w_in=params["proj_in"]["kernel"], b_in=params["proj_in"]["bias"],
        ln_scale=np.stack([blk[f"norm_{i}"]["scale"] for i in range(n)] + [blk["ff_norm"]["scale"]]),
        ln_bias=np.stack([blk[f"norm_{i}"]["bias"] for i in range(n)] + [blk["ff_norm"]["bias"]]),
        wq=stack(lambda i: blk[f"attn_{i}"]["to_q"]["kernel"]),
        wk=stack(lambda i: blk[f"attn_{i}"]["to_k"]["kernel"]),
        wv=stack(lambda i: blk[f"attn_{i}"]["to_v"]["kernel"]),
        wo=stack(lambda i: blk[f"attn_{i}"]["to_out"]["kernel"]),
        bo=stack(lambda i: blk[f"attn_{i}"]["to_out"]["bias"]),
        w1=blk["ff"]["proj"]["kernel"], b1=blk["ff"]["proj"]["bias"],
        w2=blk["ff"]["out"]["kernel"], b2=blk["ff"]["out"]["bias"],
        w_out=params["proj_out"]["kernel"], b_out=params["proj_out"]["bias"],
    )


@pytest.mark.parametrize("c,t,s", [(64, 8, 16), (192, 32, 9), (256, 8, 9),
                                   (128, 16, 12), (384, 32, 5)])  # vitb m2/m3, m0
def test_plain_matches_motion_module_reference(c, t, s):
    _, params = _jax_module(c, t, 1, s, seed=c)
    raw = _raw(params)
    x = np.random.RandomState(1).randn(2, t, s, c).astype(np.float32)
    want = np.asarray(motion_module_reference(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in raw.items()}, JCfg(), 8))
    got = t_motion.motion_module_plain(
        torch.from_numpy(x), {k: torch.from_numpy(np.asarray(v)) for k, v in raw.items()},
        TCfg(), 8)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("c,t,h,w,pe", [
    (64, 8, 3, 5, "ape"),      # unfused path (h·w < 2048)
    (192, 32, 2, 3, "ape"),    # unfused path, d = 24 attention gate
    (64, 8, 46, 46, "ape"),    # h·w ≥ 2048: the fused gate (plain version on the CPU)
    (64, 8, 3, 5, "rope"),     # RoPE: q and k rotated after the projections
    (64, 8, 46, 46, "rope"),   # the fused gate refuses RoPE: the module path
], ids=["64-8-3-5", "192-32-2-3", "64-8-46-46", "64-8-3-5-rope", "64-8-46-46-rope"])
def test_module_matches_jax_module(c, t, h, w, pe):
    jmod, params = _jax_module(c, t, h, w, seed=c + h, pe=pe)
    x = np.random.RandomState(2).randn(1, t, h, w, c).astype(np.float32)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tcfg = TCfg(pos_embedding_type=pe)
    tmod = TModule(tcfg, c)
    tmod.load_state_dict({k: torch.from_numpy(v) for k, v in
                          motion_module_state(params, tcfg).items()}, strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    assert t_motion.motion_gate(tcfg, c, c, t, h, w) is (h * w >= 2048 and pe == "ape")
    np.testing.assert_allclose(got, want, **TOL)


def test_gn_fold_equals_group_norm():
    c, g = 64, 32
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 4, 10, c).astype(np.float32))
    p = dict(gn_scale=torch.from_numpy(rng.randn(c).astype(np.float32)),
             gn_bias=torch.from_numpy(rng.randn(c).astype(np.float32)))
    a, b = t_motion.gn_fold(x, p, TCfg())
    gn = GroupNorm(g, c, eps=TCfg().group_norm_eps)
    with torch.no_grad():
        gn.weight.copy_(p["gn_scale"])
        gn.bias.copy_(p["gn_bias"])
        want = gn(x.reshape(2, 4, 10, 1, c)).reshape(x.shape)
    torch.testing.assert_close(x * a[:, :, None] + b[:, :, None], want, rtol=1e-5, atol=1e-5)


def test_weight_fragment_order():
    """``sw128_tiles`` (the wgmma B operand of Kernel C's ring, which
    replaced the mma.sync fragment order): tile (kp, nb) at row n holds
    W[k = 64kp + 8J + e, n = 64nb + n] in logical 16-byte chunk J, stored
    at chunk J ^ (n % 8), k panel major and n block inner."""
    k_dim, n_dim = 128, 192
    w_kn = torch.arange(k_dim * n_dim, dtype=torch.float32).reshape(k_dim, n_dim) % 251
    tiles = t_motion.sw128_tiles(w_kn)
    assert tiles.shape == (k_dim // 64 * n_dim // 64, 64, 64)
    for kp in range(k_dim // 64):
        for nb in range(n_dim // 64):
            tile = tiles[kp * (n_dim // 64) + nb]
            for n in range(64):
                for chunk in range(8):
                    got = tile[n, 8 * (chunk ^ (n % 8)):8 * (chunk ^ (n % 8)) + 8]
                    want = w_kn[64 * kp + 8 * chunk:64 * kp + 8 * chunk + 8, 64 * nb + n]
                    assert got.float().tolist() == want.tolist()


def test_kernel_weights_built_once_until_a_parameter_changes():
    """TemporalModule keeps Kernel C's prepared weights across calls and
    rebuilds them when a parameter is written in place."""
    tmod = TModule(TCfg(), 64)
    first = tmod.kernel_weights()
    assert tmod.kernel_weights() is first
    want = t_motion.kernel_weights(tmod.raw_params(), TCfg())
    assert first.keys() == want.keys()
    for name in want:
        torch.testing.assert_close(first[name], want[name], rtol=0, atol=0)
    with torch.no_grad():
        tmod.temporal_transformer.proj_in.weight.add_(1.0)
    rebuilt = tmod.kernel_weights()
    assert rebuilt is not first
    torch.testing.assert_close(
        rebuilt["w"], t_motion.weight_blocks(tmod.raw_params()), rtol=0, atol=0)


@pytest.mark.parametrize("c", [64, 128, 384])  # vits m3, vitb m2/m3, vitb m0
def test_smoke_check_separates_right_from_wrong(c):
    """chip_smoke.py's check of Kernel C on its inputs (bf16, 32 frames):
    the JAX reference, a right implementation with its own bf16 rounding
    points, is within the tolerance of the plain version relative to the
    module's own contribution; uniform frame attention and a module without
    APE are not."""
    import chip_smoke

    t, s = 32, 6
    p = chip_smoke.motion_params(c, seed=c, device="cpu")
    x = torch.randn(1, t, s, c, generator=torch.Generator().manual_seed(c)).to(torch.bfloat16)
    want = t_motion.motion_module_plain(x, p, TCfg(), 8)
    ref = motion_module_reference(
        jnp.asarray(x.float().numpy(), jnp.bfloat16),
        {k: jnp.asarray(v.numpy()) for k, v in p.items()}, JCfg(), 8)
    got = torch.from_numpy(np.asarray(ref, np.float32))
    base = float((want.float() - x.float()).abs().max())
    assert chip_smoke.max_err(got, want) / base <= chip_smoke.MOTION_TOL
    mutants = chip_smoke.motion_mutant_errors(x, p, TCfg(), 8)
    assert min(mutants.values()) > chip_smoke.MOTION_TOL, mutants


def test_launch_args_take_every_frame_count_the_gate_admits(monkeypatch):
    """Kernel C's launch checks pass for every 8 ≤ T ≤ 32 that
    ``motion_gate`` admits (T padded to 8, 16 or 32 rows a location) and
    refuse T past the APE table with the same message form.  On CPU
    tensors, with the stream lookup stubbed: no launch is made."""
    monkeypatch.setattr(t_motion.cuda_build, "stream_of", lambda t: None)
    c, cfg = 64, TCfg()
    g = torch.Generator().manual_seed(0)
    raw = dict(gn_scale=torch.ones(c), gn_bias=torch.zeros(c), w_in=torch.randn(c, c, generator=g),
               b_in=torch.zeros(c), ln_scale=torch.ones(3, c), ln_bias=torch.zeros(3, c),
               wq=torch.randn(2, c, c, generator=g), wk=torch.randn(2, c, c, generator=g),
               wv=torch.randn(2, c, c, generator=g), wo=torch.randn(2, c, c, generator=g),
               bo=torch.zeros(2, c), w1=torch.randn(c, 8 * c, generator=g), b1=torch.zeros(8 * c),
               w2=torch.randn(4 * c, c, generator=g), b2=torch.zeros(c),
               w_out=torch.randn(c, c, generator=g), b_out=torch.zeros(c))
    w = t_motion.kernel_weights(raw, cfg)
    for t in range(8, 33):
        assert t_motion.motion_gate(cfg, c, c, t, 74, 74)
        x = torch.zeros(1, t, 3, c, dtype=torch.bfloat16)
        gna, gnb = t_motion.gn_fold(x, w, cfg)
        out, _, args = t_motion._launch_args(x, gna, gnb, w, cfg, 8)
        assert out.shape == x.shape and args[-6] == t  # (…, B, T, S, C, scale, eps, stream)
        assert t_motion.padded_frames(t) == (8 if t <= 8 else 16 if t <= 16 else 32)
    x = torch.zeros(1, 33, 3, c, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match=r"8 <= T <= 32 within the APE table"):
        t_motion._launch_args(x, *t_motion.gn_fold(x, w, cfg), w, cfg, 8)
