"""The tile plan of the output tail's Hopper kernel (``csrc/output_tail.cu``),
emulated in torch on the CPU, against the JAX package's fused Pallas tail
(``fused_output_tail``, interpret mode) and the port's plain chain:
persistent CTAs walking 8×16 output tiles, each tile's resize read from a
source patch in shared memory through the host's per-tile tap tables
(``_tile_taps``: origin at the low taps of the first halo row and column,
at most 8×12 source pixels), the resized tile plus halo in its
swizzled pixel layout, the conv3×3 as 72 k16 steps in (dy, dx, c) order
against the swizzled w1 tiles, two consumer warpgroups of 64 pixels, and
the epilogue's rounding points.  Also the tile layout of w1 against the JAX
(HWIO) kernel.

At C = 32 and 64 (vits' and vitb's heads without the packed output stack)
the same plan: pixels of 2·C bytes, swizzled so that ldmatrix's eight
consecutive pixels of one chunk hit eight bank groups (by pixel % 8 within
each 128-byte half, at C = 32 by (pixel / 2) % 4 in a 64-byte row), K = 9·C
over ⌈9·C / 64⌉ w1 tiles (the last one half zero at C = 32), and 9·C / 16
k16 steps; held against the plain chain and the Pallas tail in interpret
mode, with a wrong plan that reads only the first C / 2 channels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_depth_anything_torch.ops import output_tail as t_tail
from video_depth_anything_tpu.ops import pallas_output_stack as j_tail
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TH, TW, PH, PW, C = 8, 16, 8, 12, 128  # C: vitl's width, the default of the helpers
BF16_ULP = 2.0**-8  # 2.5 ulps of max|ref|: the JAX tail test's bound (tests/test_output_stack.py:56)
bf = lambda v: v.to(torch.bfloat16).float()  # noqa: E731


def unswizzle(tiles):
    rows = tiles.shape[1]
    src = torch.arange(8)[None, :] ^ (torch.arange(rows) % 8)[:, None]
    t = tiles.reshape(-1, rows, 8, 8)
    out = torch.empty_like(t)
    out[:, torch.arange(rows)[:, None], src] = t
    return out.reshape(tiles.shape)


def tile_at(p: int, j: int, c: int = C) -> int:
    """The kernel's element offset of chunk j of resized pixel p at width c."""
    if c == 32:
        return p * c + ((j ^ ((p >> 1) & 3)) << 3)
    return p * c + (((j & 8) | ((j & 7) ^ (p & 7))) << 3)


def emulate(x, w1, b1, w2, b2, out_h, out_w, grid=3, mutant=None):
    """The kernel's result on bf16 ``x (N, H, W, C)``, with ``grid``
    persistent CTAs.  ``mutant="half_channels"``: the resize stage makes only
    the first C / 2 channels (the rest of the tile zero)."""
    n_, h, w, C = x.shape
    ytab = t_tail._tile_taps(h, out_h, TH, torch.device("cpu")).numpy()
    xtab = t_tail._tile_taps(w, out_w, TW, torch.device("cpu")).numpy()
    b_tiles = unswizzle(t_tail.conv_weight_tiles(w1)).float()  # (⌈9C/64⌉, 32, 64)
    assert b_tiles.shape[0] == -(-9 * C // 64)
    epi = bf(torch.cat([b1.reshape(-1), w2.reshape(-1), b2.reshape(-1)]))
    tiles_x, tiles_y = -(-out_w // TW), -(-out_h // TH)
    n_tiles = n_ * tiles_x * tiles_y
    out = torch.zeros(n_, out_h, out_w)
    xf = x.float()
    for cta in range(grid):
        for t in range(cta, n_tiles, grid):
            n, ty, tx = t // (tiles_y * tiles_x), t // tiles_x % tiles_y, t % tiles_x
            oy0, ox0 = ty * TH, tx * TW
            py0, px0 = ytab[ty, 0, 0], xtab[tx, 0, 0]
            rows = np.minimum(py0 + np.arange(PH), h - 1)
            cols = np.minimum(px0 + np.arange(PW), w - 1)
            patch = xf[n][rows][:, cols]  # (PH, PW, C), as the cp.async copy
            flat = torch.zeros((TH + 2) * (TW + 2) * C)  # the swizzled tile
            for p in range((TH + 2) * (TW + 2)):
                (y0, y1, wy0, wy1), (x0, x1, wx0, wx1) = (
                    (int(e[0]), int(e[1]), *e[2:].view(np.float32))
                    for e in (ytab[ty, 1 + p // (TW + 2)], xtab[tx, 1 + p % (TW + 2)]))
                if y0 < 0 or x0 < 0:  # past the map's edge: the conv's zero padding
                    continue
                assert max(y0, y1) < PH and max(x0, x1) < PW
                v = bf(wy0 * (wx0 * patch[y0, x0] + wx1 * patch[y0, x1]) +
                       wy1 * (wx0 * patch[y1, x0] + wx1 * patch[y1, x1]))
                for j in range(C // 16 if mutant == "half_channels" else C // 8):
                    flat[tile_at(p, j, C):tile_at(p, j, C) + 8] = v[j * 8:j * 8 + 8]
            for wg in range(2):  # the consumer warpgroups; warp wq: row 4wg + wq, columns 0..15
                pix = [(4 * wg + wq, i) for wq in range(4) for i in range(16)]
                acc = torch.zeros(64, 32)
                for tap in range(9):
                    for kk in range(C // 16):
                        q = tap * (C // 16) + kk
                        a = torch.stack([torch.cat([
                            flat[tile_at((r + tap // 3) * (TW + 2) + col + tap % 3, 2 * kk + half,
                                         C):][:8]
                            for half in range(2)]) for r, col in pix])
                        acc += a @ b_tiles[q // 4][:, (q % 4) * 16:(q % 4) * 16 + 16].t()
                z = torch.relu(bf(bf(acc) + epi[:32]))
                d = torch.relu(bf(bf((z * epi[32:64]).sum(-1)) + epi[64]))
                for (r, col), val in zip(pix, d):
                    if oy0 + r < out_h and ox0 + col < out_w:
                        out[n, oy0 + r, ox0 + col] = val
    return out[..., None]


def _case(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w1 = (rng.standard_normal((32, shape[-1], 3, 3)) * 0.1).astype(np.float32)
    b1 = (rng.standard_normal(32) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((1, 32, 1, 1)) * 0.3).astype(np.float32)
    b2 = (rng.standard_normal(1) * 0.1).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16), *map(torch.from_numpy, (w1, b1, w2, b2))


# ragged last tiles in both directions; the second is two frames and 2x2 tiles;
# C = 32 and 64 (vits' and vitb's heads) with two and four frames (the
# Pallas tail packs 4 and 2 frames into its lanes there)
@pytest.mark.parametrize("shape,out_hw", [((1, 8, 12, C), (14, 21)), ((2, 10, 24, C), (18, 42)),
                                          ((4, 8, 12, 32), (14, 21)), ((2, 10, 24, 64), (18, 42))])
def test_tile_plan_matches_pallas_tail_and_plain(shape, out_hw):
    x, w1, b1, w2, b2 = _case(shape, seed=sum(shape))
    got = emulate(x, w1, b1, w2, b2, *out_hw)
    plain = t_tail.output_tail_plain(x, w1, b1, w2, b2, *out_hw).float()
    k1, k2 = (jnp.asarray(t.numpy().transpose(2, 3, 1, 0)) for t in (w1, w2))
    jax_out = j_tail.fused_output_tail(jnp.asarray(x.float().numpy(), jnp.bfloat16), k1,
                                       jnp.asarray(b1.numpy()), k2, jnp.asarray(b2.numpy()),
                                       *out_hw, interpret=True)
    jax_out = torch.from_numpy(np.asarray(jax_out, np.float32))
    assert got.shape == plain.shape == jax_out.shape
    for want in (plain, jax_out):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) / scale <= 2.5 * BF16_ULP


@pytest.mark.parametrize("shape,out_hw", [((4, 8, 12, 32), (14, 21)), ((2, 10, 24, 64), (18, 42))])
def test_tail_reading_half_the_channels_misses(shape, out_hw):
    """A tail whose resize stage makes only the first C / 2 channels misses the
    plain chain by more than the tolerance, as chip_smoke's estimate of it
    does."""
    import chip_smoke

    x, w1, b1, w2, b2 = _case(shape, seed=sum(shape))
    plain = t_tail.output_tail_plain(x, w1, b1, w2, b2, *out_hw).float()
    got = emulate(x, w1, b1, w2, b2, *out_hw, mutant="half_channels")
    assert float((got - plain).abs().max()) / float(plain.abs().max()) > 2.5 * BF16_ULP
    assert chip_smoke.tail_mutant_errors(x, w1, b1, w2, b2, *out_hw)["half_channels"] > \
        chip_smoke.TAIL_TOL


@pytest.mark.parametrize("c", [32, 64, 128])
def test_tile_layout_is_conflict_free(c):
    """For any eight consecutive pixels of one 16-byte chunk (an ldmatrix
    matrix, and a batch of the resize stage's stores), the chunks fall in eight
    different 16-byte bank groups, and each pixel's chunks fill its own 2·C
    bytes."""
    for p0 in range(16):
        for j in range(c // 8):
            groups = {(tile_at(p, j, c) * 2 // 16) % 8 for p in range(p0, p0 + 8)}
            assert len(groups) == 8
    for p in range(16):
        assert sorted(tile_at(p, j, c) for j in range(c // 8)) == [p * c + 8 * j
                                                                   for j in range(c // 8)]


@pytest.mark.parametrize("c", [32, 64, 128])
def test_conv_weight_tiles_address_the_jax_kernel(c):
    """Tile q // 4 of ``conv_weight_tiles``, at row n (output channel), holds
    the JAX HWIO kernel's k1[dy, dx, c, n] for K index k = (3·dy + dx)·C + c,
    logical 16-byte chunk J stored at J ^ (n % 8); past K = 9·C (C = 32: the
    last tile's upper half) zeros."""
    C = c
    w1 = torch.arange(32 * C * 9, dtype=torch.float32).reshape(32, C, 3, 3) % 251
    k1 = w1.permute(2, 3, 1, 0)  # HWIO, as the JAX tail takes it
    tiles = t_tail.conv_weight_tiles(w1)
    assert tiles.shape == (-(-9 * C // 64), 32, 64)
    for k in range(0, 9 * C, 7):
        dy, dx, c = k // (3 * C), k // C % 3, k % C
        for n in range(32):
            kl = k % 64
            got = tiles[k // 64, n, ((kl // 8) ^ (n % 8)) * 8 + kl % 8]
            assert got == k1[dy, dx, c, n].to(torch.bfloat16)
    if 9 * C % 64:
        assert not unswizzle(tiles)[-1, :, 9 * C % 64:].any()


@pytest.mark.parametrize("in_out", [(296, 518), (528, 924), (8, 14), (37, 65)])
def test_patch_holds_every_tap(in_out):
    """Every tile's taps stay within the 8×12 patch at the vitl sizes and
    the card tests' sizes (the wrapper refuses wider spreads), and the tile
    tables hold ``_taps`` relative to each tile's origin."""
    h, o = in_out
    assert t_tail._patch_span(h, o, TH) <= PH and t_tail._patch_span(h, o, TW) <= PW
    idx, wts = (t.numpy() for t in t_tail._taps(h, o, torch.device("cpu")))
    for tile, span in ((TH, PH), (TW, PW)):
        tab = t_tail._tile_taps(h, o, tile, torch.device("cpu")).numpy()
        for t in range(tab.shape[0]):
            for r in range(tile + 2):
                px = t * tile - 1 + r
                lo, hi = tab[t, 1 + r, :2]
                if 0 <= px < o:
                    assert (lo + tab[t, 0, 0], hi + tab[t, 0, 0]) == (idx[px], idx[o + px])
                    assert 0 <= lo <= hi < span
                    assert tuple(tab[t, 1 + r, 2:].view(np.float32)) == (wts[px], wts[o + px])
                else:
                    assert lo == hi == -1
