"""The fused resize → conv op (``ops/resize_conv.py``) against the JAX
package's ``ops/pallas_resize_conv.py`` on the same seeded inputs: the
plain chain against ``xla_resize_conv`` (fp32) and against the Pallas
kernel in interpret mode (bf16), the gate against the JAX gate's decision,
``ResizeConvFn``'s gradients against ``jax.grad``, ``chip_smoke.py``'s
check of the kernel, and the Hopper kernel's tile plan
(``csrc/resize_conv.cu``, ``emulate_tile_plan``) against the Pallas kernel
in interpret mode."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from video_depth_anything_torch.ops import output_tail as ot
from video_depth_anything_torch.ops import resize_conv as rc
from video_depth_anything_tpu.ops import pallas_resize_conv as jrc
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BF16_ULP = 2.0**-8
FP32_TOL = 1e-5  # fp32, relative to max|ref|: the two convolutions sum in other orders


def _case(n, h, w, c, cout=128, seed=0):
    """The JAX test's inputs (tests/test_resize_conv.py:22-26): x ~ N(0, 1),
    k ~ N(0, 0.1²) in HWIO, b ~ N(0, 0.1²)."""
    rng = np.random.default_rng(seed + n + h + w + c)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c, cout)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((cout,)) * 0.1).astype(np.float32)
    return x, k, b


def _port(k):
    """HWIO → the port's (Cout, C, 3, 3)."""
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


def _rel(got, want):
    return float(np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)).max()
                 / np.abs(np.asarray(want, np.float32)).max())


@pytest.mark.parametrize("shape,out_hw", [((2, 8, 8, 128), (16, 16)), ((1, 6, 10, 256), (12, 20)),
                                          ((1, 5, 7, 128), (9, 13))])
def test_plain_matches_xla_resize_conv_fp32(shape, out_hw):
    x, k, b = _case(*shape)
    got = rc.resize_conv_plain(torch.from_numpy(x), _port(k), torch.from_numpy(b), *out_hw)
    want = np.asarray(jrc.xla_resize_conv(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), *out_hw))
    assert got.shape == want.shape == shape[:1] + out_hw + (128,)
    assert _rel(got.numpy(), want) <= FP32_TOL


# (1, 6, 10, 128) → 12×20 is refused by the JAX gate (the u4 > in_h case,
# test_gate_matches_jax), so the rectangular case takes C = 256.
@pytest.mark.parametrize("shape,out_hw", [((1, 8, 8, 256), (16, 16)), ((1, 6, 10, 256), (12, 20))])
def test_plain_matches_pallas_kernel_bf16(shape, out_hw):
    """bf16 against the TPU kernel in interpret mode, within the JAX
    package's bound: 2.5 bf16 ulps of max|ref| (tests/test_resize_conv.py:49)."""
    x, k, b = _case(*shape)
    want = jrc.try_fused_resize_conv(jnp.asarray(x, jnp.bfloat16), jnp.asarray(k), jnp.asarray(b),
                                     *out_hw, interpret=True)
    assert want is not None
    got = rc.resize_conv_plain(torch.from_numpy(x).to(torch.bfloat16), _port(k),
                               torch.from_numpy(b), *out_hw)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), want) <= 2.5 * BF16_ULP


def _jax_gate(shape, dtype, cout, out_hw):
    """The JAX gate's decision without running its kernel: every refusal
    of ``try_fused_resize_conv`` returns None before any launch; where the
    structural checks pass, the decision is ``_row_block``'s."""
    n, h, w, c = shape
    x = jnp.zeros(shape, dtype)
    k = jnp.zeros((3, 3, c, cout), jnp.float32)
    structural = dtype == jnp.bfloat16 and h >= 2 and w >= 2 and c % 128 == 0 and cout == 128
    if not structural or jrc._row_block(*out_hw, h, w, c, cout) is None:
        assert jrc.try_fused_resize_conv(x, k, jnp.zeros((cout,)), *out_hw, interpret=True) is None
        return False
    return True


@pytest.mark.parametrize("shape,dtype,cout,out_hw", [
    ((32, 148, 148, 256), "bfloat16", 128, (296, 296)),   # the vitl junction: admitted
    ((32, 148, 264, 256), "bfloat16", 128, (296, 528)),   # 16:9: admitted at a smaller block
    ((1, 8, 8, 256), "bfloat16", 128, (16, 16)),
    ((1, 6, 10, 256), "bfloat16", 128, (12, 20)),
    ((1, 2, 2, 128), "bfloat16", 128, (4, 4)),
    ((1, 16, 16, 256), "float32", 128, (32, 32)),         # fp32
    ((1, 16, 16, 96), "bfloat16", 128, (32, 32)),         # C not a multiple of 128
    ((1, 16, 16, 256), "bfloat16", 64, (32, 32)),         # Cout 64
    ((1, 1, 16, 256), "bfloat16", 128, (2, 32)),          # h = 1
    ((1, 16, 1, 256), "bfloat16", 128, (32, 2)),          # w = 1
    ((1, 6, 10, 128), "bfloat16", 128, (12, 20)),         # u4 = 8 > in_h = 6
    ((1, 5, 8, 256), "bfloat16", 128, (10, 16)),          # u4 = 6 > in_h = 5
])
def test_gate_matches_jax(shape, dtype, cout, out_hw):
    want = _jax_gate(shape, getattr(jnp, dtype), cout, out_hw)
    got = rc.resize_conv_gate(shape, getattr(torch, dtype), (cout, shape[3], 3, 3), *out_hw)
    assert got is want
    if want:
        plan = jrc._row_block(*out_hw, *shape[1:3], shape[3], cout)
        assert rc._row_block(*out_hw, *shape[1:3], shape[3], cout) == tuple(int(p) for p in plan)


def test_gate_refuses_other_weights():
    assert not rc.resize_conv_gate((1, 8, 8, 256), torch.bfloat16, (128, 256, 1, 1), 16, 16)
    assert not rc.resize_conv_gate((1, 8, 8, 256), torch.bfloat16, (128, 128, 3, 3), 16, 16)
    assert not rc.resize_conv_gate((8, 8, 256), torch.bfloat16, (128, 256, 3, 3), 16, 16)


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    x, k, b = _case(1, 6, 10, 256)
    args = (torch.from_numpy(x).to(torch.bfloat16), _port(k), torch.from_numpy(b), 12, 20)
    before = rc.resize_conv.launches
    got = rc.resize_conv(*args)
    assert rc.resize_conv.launches == before
    assert _rel(got.float().numpy(), rc.resize_conv_plain(*args).float().numpy()) <= BF16_ULP
    with pytest.raises(RuntimeError):  # the raw launch keeps no history
        rc.resize_conv(args[0], args[1].requires_grad_(), *args[2:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resize_conv_fn_gradients_match_jax(dtype):
    """``ResizeConvFn`` against ``jax.grad`` of ``xla_resize_conv`` with a
    value-independent cotangent, as the JAX test (tests/test_resize_conv.py:
    67-89): fp32 within 1e-4 of each gradient's max; bf16 x and w gradients
    within the JAX test's rtol = atol = 0.1.  The bf16 bias gradient is the
    sum of the bf16 cotangent over 256 pixels: XLA sums it in bf16 (3.3 %
    of its max away from the exact sum on these inputs), PyTorch in fp32,
    so it is held to 5e-2 of its max against JAX and to 1e-2 against the
    exact sum."""
    x, k, b = _case(1, 8, 8, 256, seed=7)
    gw = np.random.default_rng(7).standard_normal((1, 16, 16, 128)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def f(x, k, b):
        return jnp.sum(jrc.xla_resize_conv(x, k, b, 16, 16) * gw)

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x, jdt), jnp.asarray(k), jnp.asarray(b))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tw = _port(k).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    out = rc.ResizeConvFn.apply(tx, tw, tb, 16, 16)
    (out.float() * torch.from_numpy(gw)).sum().backward()
    got = (tx.grad, tw.grad, tb.grad)
    wants = (np.asarray(want[0], np.float32), np.asarray(want[1], np.float32).transpose(3, 2, 0, 1),
             np.asarray(want[2], np.float32))
    for i, (g, w) in enumerate(zip(got, wants)):
        assert g.shape == w.shape
        if dtype == "float32":
            assert _rel(g.numpy(), w) <= 1e-4
        elif i < 2:
            np.testing.assert_allclose(g.float().numpy(), w, rtol=0.1, atol=0.1)
        else:
            assert _rel(g.numpy(), w) <= 5e-2
            exact = np.asarray(jnp.asarray(gw, jnp.bfloat16), np.float64).reshape(-1, 128).sum(0)
            assert _rel(g.numpy(), exact) <= 1e-2


@pytest.mark.parametrize("shape,out_hw", [((2, 8, 8, 256), (16, 16)), ((1, 12, 20, 128), (24, 40))])
def test_smoke_check_separates_right_from_wrong(shape, out_hw):
    """chip_smoke.py's check of the kernel on its inputs: the JAX XLA chain,
    a right implementation with its own summation order, is within the
    tolerance of the plain version; half-pixel (align_corners False) taps
    and a conv3×3 without its off-centre taps are not."""
    x, w, b = chip_smoke.resize_conv_inputs(*shape, torch.Generator().manual_seed(3), "cpu")
    want = rc.resize_conv_plain(x, w, b, *out_hw)
    jax_out = jrc.xla_resize_conv(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                  jnp.asarray(w.numpy().transpose(2, 3, 1, 0)),
                                  jnp.asarray(b.numpy()), *out_hw)
    assert _rel(np.asarray(jax_out, np.float32), want.float().numpy()) <= chip_smoke.RESIZE_CONV_TOL
    mutants = chip_smoke.resize_conv_mutant_errors(x, w, b, *out_hw)
    assert min(mutants.values()) > chip_smoke.RESIZE_CONV_TOL, mutants


# ---- the Hopper kernel's tile plan (csrc/resize_conv.cu) ----
TILE, PATCH, CK, HW, NP = 16, 12, 64, 18, 325  # its constants: HW = TILE + 2, NP = 18² + 1


def _unswizzle(tiles):
    """``weight_tiles``' 128-byte swizzle undone: row n's chunk J back from
    chunk J ^ (n % 8)."""
    rows = tiles.shape[1]
    src = torch.arange(8)[None, :] ^ (torch.arange(rows) % 8)[:, None]
    tv = tiles.reshape(-1, rows, 8, 8)
    out = torch.empty_like(tv)
    out[:, torch.arange(rows)[:, None], src] = tv
    return out.reshape(tiles.shape)


def _read_a(buf, start: int, lbo: int, sbo: int):
    """The wgmma A operands that four k16 steps of no-swizzle K-major
    descriptors address in the tile buffer ``buf`` (rows of 16 bytes, 8
    bf16 each), step ks starting ``2 * ks * lbo`` rows after ``start``: row
    m of a step is core matrix m // 8 along M (``sbo`` rows on) and its row
    m % 8 (one 16-byte row on), K core matrix kc ``lbo`` rows on.  Returns
    the (64, 64) A of the four steps, K in step order."""
    m = torch.arange(64)[:, None]
    kc = torch.arange(8)[None, :]  # core matrix 2 * ks + kc along K
    return buf[start + (m // 8) * sbo + m % 8 + kc * lbo].reshape(64, 64)


def emulate_tile_plan(x, w, b, out_h, out_w, grid=3, mutant=None):
    """``resize_conv_hopper``'s result on bf16 ``x (N, H, W, C)``: ``grid``
    persistent CTAs walking 16×16 output tiles; per 64-channel chunk the
    builder's 18×18 halo tile (taps from the host tables ``_tile_taps``,
    relative to the tile's origin, read from the staged 12×12 source patch
    or, where the taps spread wider, from the map), zero outside the map,
    stored octet-major (octet o of halo pixel p in 16-byte row o·NP + p);
    four consumers of an 8×8 block each, every tap and k16 step read
    through its descriptor (start + tap shift (dy·HW + dx) + 2·ks·NP rows,
    LBO NP rows, SBO HW rows) against the (chunk, tap) B tile of
    ``weight_tiles``; the epilogue's rounding.  Mutants: ``tap_dx_plus_one``
    (every tap's shift one pixel too far) and ``missing_halo_row`` (the
    builders never write the halo's first row)."""
    n_, h, wd, c = x.shape
    cpu = torch.device("cpu")
    ytab = ot._tile_taps(h, out_h, TILE, cpu)
    xtab = ot._tile_taps(wd, out_w, TILE, cpu)
    patch = ot._patch_span(h, out_h, TILE) <= PATCH and ot._patch_span(wd, out_w, TILE) <= PATCH
    wt = _unswizzle(rc.weight_tiles(w)).float()  # (9·C/64, 128, 64)
    bias = b.to(torch.bfloat16).float()
    tiles_x, tiles_y = -(-out_w // TILE), -(-out_h // TILE)
    out = torch.zeros(n_, out_h, out_w, 128)
    xf = x.float()
    for cta in range(grid):
        for t in range(cta, n_ * tiles_x * tiles_y, grid):
            n, ty, tx = t // (tiles_y * tiles_x), t // tiles_x % tiles_y, t % tiles_x
            taps = []
            for tab, tt, size in ((ytab, ty, h), (xtab, tx, wd)):
                e = tab[tt]
                org = int(e[0, 0])
                lo, hi = e[1:, 0].long(), e[1:, 1].long()
                wts = e[1:, 2:].contiguous().view(torch.float32)
                taps.append((org, lo, hi, wts[:, 0], wts[:, 1], lo >= 0))
            (oy, ylo, yhi, wy0, wy1, yin), (ox, xlo, xhi, wx0, wx1, xin) = taps
            acc = torch.zeros(4, 64, 128)
            for cc in range(c // CK):
                src = xf[n, :, :, cc * CK:(cc + 1) * CK]
                if patch:  # the cp.async copy: clamped at the map's edge
                    assert int(torch.maximum(ylo, yhi).max()) < PATCH
                    assert int(torch.maximum(xlo, xhi).max()) < PATCH
                    rows = torch.clamp(oy + torch.arange(PATCH), max=h - 1)
                    cols = torch.clamp(ox + torch.arange(PATCH), max=wd - 1)
                    src, oy_, ox_ = src[rows][:, cols], 0, 0
                else:
                    oy_, ox_ = oy, ox
                y0, y1 = oy_ + ylo.clamp(min=0), oy_ + yhi.clamp(min=0)
                x0, x1 = ox_ + xlo.clamp(min=0), ox_ + xhi.clamp(min=0)
                a, bb = src[y0][:, x0], src[y0][:, x1]
                d, e = src[y1][:, x0], src[y1][:, x1]
                wx0_, wx1_ = wx0[None, :, None], wx1[None, :, None]
                val = (wy0[:, None, None] * (wx0_ * a + wx1_ * bb)
                       + wy1[:, None, None] * (wx0_ * d + wx1_ * e))
                val = _bf16(val) * (yin[:, None, None] & xin[None, :, None])
                if mutant == "missing_halo_row":
                    val[0] = 0.0
                buf = torch.zeros(8 * NP, 8)  # the tile buffer, in 16-byte rows
                for o in range(8):
                    buf[o * NP:o * NP + 18 * 18] = val.reshape(18 * 18, CK)[:, o * 8:o * 8 + 8]
                for cw in range(4):
                    base = (8 * (cw >> 1)) * HW + 8 * (cw & 1)
                    for tap in range(9):
                        shift = (tap // 3) * HW + tap % 3 + (mutant == "tap_dx_plus_one")
                        acc[cw] += _read_a(buf, base + shift, NP, HW) @ wt[9 * cc + tap].t()
            m = torch.arange(64)
            for cw in range(4):
                y = ty * TILE + 8 * (cw >> 1) + m // 8
                xx = tx * TILE + 8 * (cw & 1) + m % 8
                inside = (y < out_h) & (xx < out_w)
                out[n, y[inside], xx[inside]] = _bf16(_bf16(acc[cw]) + bias)[inside]
    return out


def _bf16(t):
    return t.to(torch.bfloat16).float()


# an upsampling (2×2 tiles, ragged), a non-2× one over four chunks, and a
# downsampling, whose taps spread over more than the patch (global reads)
PLAN_CASES = [((1, 12, 10, 128), (24, 20)), ((1, 10, 14, 256), (17, 23)),
              ((1, 20, 24, 128), (12, 14))]


@functools.lru_cache(maxsize=None)
def _pallas(case: int):
    """The Pallas kernel in interpret mode on ``PLAN_CASES[case]``'s inputs
    (each computed once: the mutants reuse the first case's)."""
    shape, out_hw = PLAN_CASES[case]
    x, k, b = _case(*shape)
    return np.asarray(jrc.fused_resize_conv(jnp.asarray(x, jnp.bfloat16), jnp.asarray(k),
                                            jnp.asarray(b), *out_hw, interpret=True), np.float32)


@pytest.mark.parametrize("case", range(len(PLAN_CASES)))
def test_tile_plan_matches_pallas_kernel(case):
    """Within the JAX test's bound of its kernel against the XLA chain,
    2.5 bf16 ulps of max|ref| (tests/test_resize_conv.py:49), of the Pallas
    kernel and of the port's plain version."""
    shape, out_hw = PLAN_CASES[case]
    x, k, b = _case(*shape)
    assert rc.resize_conv_gate(shape, torch.bfloat16, (128, shape[3], 3, 3), *out_hw)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    got = emulate_tile_plan(tx, _port(k), torch.from_numpy(b), *out_hw)
    plain = rc.resize_conv_plain(tx, _port(k), torch.from_numpy(b), *out_hw)
    for want in (_pallas(case), plain.float().numpy()):
        assert got.shape == want.shape
        assert _rel(got.numpy(), want) <= 2.5 * BF16_ULP


@pytest.mark.parametrize("mutant", ["tap_dx_plus_one", "missing_halo_row"])
def test_tile_plan_mutant_misses_pallas_kernel(mutant):
    shape, out_hw = PLAN_CASES[0]
    x, k, b = _case(*shape)
    got = emulate_tile_plan(torch.from_numpy(x).to(torch.bfloat16), _port(k), torch.from_numpy(b),
                            *out_hw, mutant=mutant)
    assert _rel(got.numpy(), _pallas(0)) > chip_smoke.RESIZE_CONV_TOL


def test_weight_tiles_address_the_jax_kernel():
    """Tile 9·cc + tap of ``weight_tiles``, at row n (output channel),
    holds the JAX HWIO kernel's k[dy, dx, 64·cc + kk, n] (tap = 3·dy + dx),
    logical 16-byte chunk kk // 8 stored at chunk (kk // 8) ^ (n % 8)."""
    c = 256
    w = torch.arange(128 * c * 9, dtype=torch.float32).reshape(128, c, 3, 3) % 251
    k = w.permute(2, 3, 1, 0)  # HWIO, as the JAX kernel takes it
    tiles = rc.weight_tiles(w)
    assert tiles.shape == (9 * c // 64, 128, 64) and tiles.is_contiguous()
    for q in range(0, tiles.shape[0], 5):
        cc, tap = q // 9, q % 9
        for n in range(0, 128, 3):
            for kk in range(0, 64, 7):
                got = tiles[q, n, ((kk // 8) ^ (n % 8)) * 8 + kk % 8]
                assert got == k[tap // 3, tap % 3, 64 * cc + kk, n].to(torch.bfloat16)
