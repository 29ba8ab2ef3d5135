"""The tiling of Kernel C's Hopper kernel (``csrc/motion_module.cuh``),
emulated in torch on the CPU, against the JAX Pallas motion kernel run as
the JAX package's tests run it (interpret mode) and against the port's
plain version: CTAs of R = 64·NRB location-major rows (whole locations per
64-row block, a ragged last CTA), every product fed 64×64 weight tiles in
the order of the streamed sequence (``weight_blocks``, un-swizzled here),
k panel after k panel into fp32 accumulators, the 64-wide output blocks
taken round robin by the row block's warpgroups (three at C = 192 and 384,
two at 256), T padded up to Tp = 8, 16 or 32 rows a location (rows
t ≥ T zero, their keys masked, no APE, never stored), the feed-forward in steps of
64·NSPLIT hidden columns (h product, gate product, then the second
product, which accumulates in fp32 over all steps), v written over h, the
attention out over q, and every bf16 rounding point of the kernel.  Also the layout of the tiles against the JAX
``(in, out)`` weights."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_depth_anything_torch.config import MotionModuleConfig as TCfg
from video_depth_anything_torch.ops import motion_module as t_motion
from video_depth_anything_tpu.config import MotionModuleConfig as JCfg
from video_depth_anything_tpu.ops.pallas_motion import fused_motion_module
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# Relative to max|plain - x|, the module's own contribution, as chip_smoke.py's
# MOTION_TOL: emulation, JAX kernel and plain version round to bf16 at
# different points through ~10 chained products (the JAX kernel lies
# 0.9-1.1e-2 from its own reference here).
TOL = 5e-2
ROWS = {64: 128, 128: 128, 192: 64, 256: 64, 384: 64}  # rows per CTA, as the kernel's Plan
bf = lambda v: v.to(torch.bfloat16).float()  # noqa: E731


def unswizzle(tiles):
    """``(n, rows, 64)`` tiles in the 128-byte swizzle → the plain ``(n,
    rows, 64)`` (N rows × K) they hold."""
    rows = tiles.shape[1]
    src = torch.arange(8)[None, :] ^ (torch.arange(rows) % 8)[:, None]  # logical chunk j at j ^ n%8
    t = tiles.reshape(-1, rows, 8, 8)
    out = torch.empty_like(t)
    out[:, torch.arange(rows)[:, None], src] = t
    return out.reshape(tiles.shape)


class Stream:
    """The producer's sequence of weight tiles, consumed in order."""

    def __init__(self, flat):
        self.tiles = unswizzle(flat.reshape(-1, 64, 64)).float()
        self.j = 0

    def gemm(self, a, kp_n: int, ns_n: int, own):
        """acc[:, ns] = Σ_kp a[:, kp] · tile(kp, ns)ᵀ over the next kp_n·ns_n
        tiles, for the n blocks in ``own`` (64 output columns each)."""
        acc = {ns: torch.zeros(a.shape[0], 64) for ns in own}
        for kp in range(kp_n):
            for ns in range(ns_n):
                if ns in own:
                    acc[ns] += a[:, kp * 64:(kp + 1) * 64] @ self.tiles[self.j + kp * ns_n + ns].t()
        self.j += kp_n * ns_n
        return torch.cat([acc[ns] for ns in own], dim=1)


def emulate(x, p, cfg, heads, mutant=None):
    """Kernel C's result on bf16 ``x (B, T, S, C)`` (returned as fp32).
    ``mutant="unmasked_keys"`` lets the padded frames' keys into the
    frame attention."""
    b_, t_, s_, c = x.shape
    tp = t_motion.padded_frames(t_)
    w = t_motion.kernel_weights(p, cfg)
    gna, gnb = t_motion.gn_fold(x, w, cfg)  # over the true T
    nsplit = t_motion.nsplit(c)
    rows = ROWS[c]
    locs = rows // tp
    ns_n, dh = c // 64, c // heads
    pe = w["pe"].float()
    f32 = {k: w[k].float() for k in ("b_in", "ln_scale", "ln_bias", "bo", "b1", "b2", "b_out")}
    s_pad = -(-s_ // locs) * locs
    xp = torch.zeros(b_, tp, s_pad, c)
    xp[:, :t_, :s_] = x.float()
    out = torch.zeros(b_, tp, s_pad, c)
    gna, gnb = (torch.cat([g, torch.zeros(b_, tp - t_, c)], 1) for g in (gna, gnb))
    pe = torch.cat([pe[:t_], torch.zeros(tp - t_, c)])  # no APE on a padded frame

    def full_gemm(stream_of_wg, a, kp_n, n_n):
        """Each warpgroup cs of the row block consumes its own blocks of the
        same sequence, n blocks cs, cs + nsplit, ...; all advance it by the
        same count."""
        out = torch.zeros(a.shape[0], 64 * n_n)
        for cs, st in enumerate(stream_of_wg):
            own = list(range(cs, n_n, nsplit))
            part = st.gemm(a, kp_n, n_n, own)
            for u, ns in enumerate(own):
                out[:, ns * 64:(ns + 1) * 64] = part[:, u * 64:(u + 1) * 64]
        return out

    def ln(y, i, with_pe, t_idx):
        mean = y.mean(-1, keepdim=True)
        var = torch.clamp((y * y).mean(-1, keepdim=True) - mean * mean, min=0.0)
        h = bf((y - mean) * (torch.rsqrt(var + cfg.layer_norm_eps) * f32["ln_scale"][i]) +
               f32["ln_bias"][i])
        return bf(h + pe[t_idx]) if with_pe else h

    for bi in range(b_):
        for s0 in range(0, s_, locs):  # one CTA
            for r0 in range(0, locs, 64 // tp):  # one 64-row block: whole locations
                sl = slice(s0 + r0, s0 + r0 + 64 // tp)
                nl = 64 // tp
                # rows location major: r = l * Tp + t; zeros past S and T
                xr = xp[bi, :, sl].permute(1, 0, 2).reshape(-1, c)
                t_idx = torch.arange(tp).repeat(nl)
                h = bf(xr * gna[bi][t_idx] + gnb[bi][t_idx])
                streams = [Stream(w["w"]) for _ in range(nsplit)]
                y = bf(full_gemm(streams, h, c // 64, ns_n) + f32["b_in"])
                for i in range(2):
                    h = ln(y, i, True, t_idx)
                    q = bf(full_gemm(streams, h, c // 64, ns_n))
                    k = bf(full_gemm(streams, h, c // 64, ns_n))
                    v = bf(full_gemm(streams, h, c // 64, ns_n))  # over h
                    o = torch.zeros_like(q)
                    for li in range(nl):
                        rr = slice(li * tp, (li + 1) * tp)
                        for hd in range(heads):
                            cc = slice(hd * dh, (hd + 1) * dh)
                            sc = q[rr, cc] @ k[rr, cc].t() * dh**-0.5
                            if mutant != "unmasked_keys":
                                sc[:, t_:] = -torch.inf
                            pr = bf(torch.softmax(sc, dim=-1))
                            o[rr, cc] = bf(pr @ v[rr, cc])  # over q
                    y = bf(y + full_gemm(streams, o, c // 64, ns_n) + f32["bo"][i])
                h = ln(y, 2, False, t_idx)
                ff = torch.zeros_like(y)
                for f in range(4 * c // (64 * nsplit)):
                    j0 = f * nsplit * 64  # chunk f * nsplit + cs in warpgroup cs
                    hh = bf(full_gemm(streams, h, c // 64, nsplit) + f32["b1"][j0:j0 + nsplit * 64])
                    gg = bf(full_gemm(streams, h, c // 64, nsplit) +
                            f32["b1"][4 * c + j0:4 * c + j0 + nsplit * 64])
                    ge = bf(0.5 * gg * (1 + torch.tanh(0.7978845608028654 * (gg + 0.044715 * gg**3))))
                    ff += full_gemm(streams, bf(hh * ge), nsplit, ns_n)
                y = bf(y + ff + f32["b2"])
                res = full_gemm(streams, y, c // 64, ns_n) + f32["b_out"]
                assert all(st.j == streams[0].j == w["w"].numel() // 4096 for st in streams)
                out[bi, :, sl] = bf(res + xr).reshape(nl, tp, c).permute(1, 0, 2)
    return out[:, :t_, :s_]


def _params(c, seed):
    rng = np.random.default_rng(seed)
    n = lambda *s, std=1.0: torch.from_numpy((rng.standard_normal(s) * std).astype(np.float32))  # noqa: E731
    return dict(gn_scale=1 + n(c, std=0.1), gn_bias=n(c, std=0.1), w_in=n(c, c, std=c**-0.5),
                b_in=n(c, std=0.1), ln_scale=1 + n(3, c, std=0.1), ln_bias=n(3, c, std=0.1),
                wq=n(2, c, c, std=c**-0.5), wk=n(2, c, c, std=c**-0.5), wv=n(2, c, c, std=c**-0.5),
                wo=n(2, c, c, std=c**-0.5), bo=n(2, c, std=0.1), w1=n(c, 8 * c, std=c**-0.5),
                b1=n(8 * c, std=0.1), w2=n(4 * c, c, std=(4 * c) ** -0.5), b2=n(c, std=0.1),
                w_out=n(c, c, std=c**-0.5), b_out=n(c, std=0.1))


def _x(c, t, s, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((1, t, s, c)).astype(np.float32)).to(torch.bfloat16)


def _rel(got, want, x):
    return float((got.float() - want.float()).abs().max()) / \
        float((want.float() - x.float()).abs().max())


@functools.lru_cache(maxsize=None)
def _case(c, t, s):
    """Parameters, x and the plan's output of a shape, computed once for the
    plain and the Pallas comparisons."""
    p, x = _params(c, c + t), _x(c, t, s, s)
    return p, x, emulate(x, p, TCfg(), 8)


# S leaves a ragged last CTA (locations per CTA: 128 / Tp at C = 64, 128;
# 64 / Tp at 256, 384); T = 12, 20 and 24 take Tp = 16, 32 and 32
@pytest.mark.parametrize("c,t,s", [(64, 8, 20), (64, 32, 6), (128, 8, 19), (128, 32, 5),
                                   (384, 8, 10), (384, 32, 3), (64, 12, 12), (64, 20, 5),
                                   (256, 24, 3)])
def test_tiling_matches_plain(c, t, s):
    p, x, got = _case(c, t, s)
    want = t_motion.motion_module_plain(x, p, TCfg(), 8)
    assert _rel(got, want, x) <= TOL


def test_unmasked_padded_keys_miss_plain():
    """The padded-Tp plan with the padded frames' keys let into the frame
    attention (T = 20 in 32 rows) misses the plain version."""
    p, x, _ = _case(64, 20, 5)
    want = t_motion.motion_module_plain(x, p, TCfg(), 8)
    assert _rel(emulate(x, p, TCfg(), 8, mutant="unmasked_keys"), want, x) > TOL


@pytest.mark.parametrize("c,t,s", [(64, 8, 20), (128, 32, 5), (384, 32, 3)])
def test_tiling_matches_pallas_kernel(c, t, s):
    p, x, got = _case(c, t, s)
    want = fused_motion_module(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                               {k: jnp.asarray(v.numpy()) for k, v in p.items()},
                               heads=8, cfg=JCfg(), interpret=True)
    assert _rel(got, torch.from_numpy(np.asarray(want, np.float32)), x) <= TOL


@pytest.mark.parametrize("c", [64, 256, 384])
def test_weight_tiles_address_the_jax_weights(c):
    """Tile j of ``weight_blocks`` holds, at row n, logical chunk J stored
    at chunk J ^ (n % 8), the 64 inputs × 64 outputs of the (in, out)
    weight that the kernel's j-th ring block feeds: here proj_in, block 1's
    q (its first tile), the first feed-forward step's h and gate columns,
    and proj_out."""
    p = _params(c, 7)
    tiles = t_motion.weight_blocks(p).reshape(-1, 64, 64)
    g = (c // 64) ** 2
    nsplit = t_motion.nsplit(c)

    def tile_of(w_kn, kp, ns):  # (in, out) weight → the tile's [n, k] values
        return w_kn[kp * 64:(kp + 1) * 64, ns * 64:(ns + 1) * 64].t().to(torch.bfloat16)

    def stored(j, n, k):
        return tiles[j, n, (((k // 8) ^ (n % 8)) * 8) + k % 8]

    kp_n = c // 64
    checks = [(0, p["w_in"], 0, 0), (g - 1, p["w_in"], kp_n - 1, kp_n - 1),
              (g, p["wq"][0], 0, 0), (9 * g, p["w1"][:, :64], 0, 0),
              (9 * g + kp_n * nsplit, p["w1"][:, 4 * c:4 * c + 64], 0, 0),
              (9 * g + 2 * kp_n * nsplit, p["w2"][:64], 0, 0),
              (tiles.shape[0] - 1, p["w_out"], kp_n - 1, kp_n - 1)]
    if nsplit > 1:  # the second warpgroup's chunk beside the first's, per k panel
        checks.append((9 * g + 1, p["w1"][:, 64:128], 0, 0))
    for j, w_kn, kp, ns in checks:
        want = tile_of(w_kn, kp, ns)
        for n in range(0, 64, 9):
            for k in range(0, 64, 5):
                assert stored(j, n, k) == want[n, k], (j, n, k)
    assert tiles.shape[0] == 22 * c * c // 4096
