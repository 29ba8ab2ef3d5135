"""The port's CUDA kernels against their plain versions on the card, at
small shapes with ragged edges.  Marked ``cuda``: they skip where there is
no card; on the card run ``python -m pytest -m cuda tests/test_torch_cuda_kernels.py``."""

import pytest
import torch

import chip_smoke
from video_depth_anything_torch.config import MotionModuleConfig
from video_depth_anything_torch.ops import attention_variants as av
from video_depth_anything_torch.ops import flash_attention as fa
from video_depth_anything_torch.ops import motion_module as mm
from video_depth_anything_torch.ops import output_tail as ot
from video_depth_anything_torch.ops import resize_conv as rc
from video_depth_anything_torch.ops import temporal_attention as ta

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _randn(dev, *shape, seed=0, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(*shape, device=dev, generator=g) * scale).to(torch.bfloat16)


@pytest.mark.parametrize("n", [257, 362, 1370, 2443])  # ragged last query and key tiles
def test_flash_attention_kernel(dev, n):
    """chip_smoke.py's peaked inputs and tolerance (relative to max|plain|),
    and its flat inputs, where the zero-filled pad keys of the ragged last
    128-key tile would show if the kernel counted them."""
    b, h, d = 2, 6, 64
    g = torch.Generator(device=dev).manual_seed(n)
    qkv = chip_smoke.attention_inputs((b, n, h * d), g, dev)
    q, k, v = (t.view(b, n, h, d) for t in qkv.split(h * d, dim=-1))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, d**-0.5)
    assert fa.flash_attention.launches == before + 1
    assert chip_smoke.rel_err(got, fa.flash_attention_plain(q, k, v, d**-0.5)) <= chip_smoke.ATTN_TOL
    qf = chip_smoke.flat_inputs(q)
    want = fa.flash_attention_plain(qf, k, v, d**-0.5)
    assert chip_smoke.rel_err(fa.flash_attention(qf, k, v, d**-0.5), want) <= chip_smoke.ATTN_TOL
    assert chip_smoke.zero_pad_error(fa.flash_attention_plain, qf, k, v, d**-0.5, 128) > \
        chip_smoke.ATTN_TOL


@pytest.mark.parametrize("n", [1370, 2443])  # vitl's 16 heads at 518² and 518×924
def test_flash_attention_kernel_sixteen_heads(dev, n):
    b, h, d = 2, 16, 64
    g = torch.Generator(device=dev).manual_seed(n + h)
    qkv = chip_smoke.attention_inputs((b, n, h * d), g, dev)
    q, k, v = (t.view(b, n, h, d) for t in qkv.split(h * d, dim=-1))
    got = fa.flash_attention(q, k, v, d**-0.5)
    assert chip_smoke.rel_err(got, fa.flash_attention_plain(q, k, v, d**-0.5)) <= chip_smoke.ATTN_TOL


@pytest.mark.parametrize("n,h,d,fast", [
    (257, 6, 64, True), (1370, 6, 64, True), (2443, 6, 64, True),   # the no-max variant
    (2443, 6, 64, "frame"),                                         # one streamed frame
    (300, 3, 64, False), (1370, 3, 64, True), (2443, 3, 64, False),  # odd head counts
    (257, 2, 192, False), (1370, 2, 192, False), (2443, 1, 192, True),  # D = 192
    (300, 1, 192, True), (1370, 2, 192, True), (2443, 2, 192, False), (64, 1, 192, False),
])
def test_flash_attention_variants(dev, n, h, d, fast):
    """Kernel A's fast variant (also on one streamed frame, B = 1), odd
    head counts and D = 192 (``flash_fwd_hopper192``: 64-key tiles, one
    of them ragged or whole at n = 64) against their plain
    versions, with chip_smoke.py's inputs and tolerance; each variant
    counts on its own launch counter."""
    g = torch.Generator(device=dev).manual_seed(n + h + d)
    b = 1 if fast == "frame" else 2
    fast = bool(fast)
    qkv = chip_smoke.attention_inputs((b, n, h * d), g, dev)
    q, k, v = (t.view(b, n, h, d) for t in qkv.split(h * d, dim=-1))
    before = (fa.flash_attention.launches, fa.flash_attention.fast_launches)
    got = fa.flash_attention(q, k, v, d**-0.5, fast=fast)
    assert (fa.flash_attention.launches, fa.flash_attention.fast_launches) == \
        (before[0] + (not fast), before[1] + fast)
    want = fa.flash_attention_plain(q, k, v, d**-0.5, fast=fast)
    assert chip_smoke.rel_err(got, want) <= chip_smoke.ATTN_TOL


def test_flash_attention_fast_lse_and_backward(dev):
    """The fast forward's log-sum-exp is log2 of the exact softmax
    denominator, so the backward kernel from it matches the plain
    backward."""
    b, n, h, d = 2, 362, 6, 64
    qkv = chip_smoke.attention_inputs((b, n, h * d), torch.Generator(device=dev).manual_seed(2), dev)
    q, k, v = (t.view(b, n, h, d) for t in qkv.split(h * d, dim=-1))
    o, lse = fa.flash_attention(q, k, v, d**-0.5, with_lse=True, fast=True)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d**-0.5
    want = torch.logsumexp(s, dim=-1) / torch.log(torch.tensor(2.0, device=dev))
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-4)
    go = torch.randn(b, n, h, d, generator=torch.Generator(device=dev).manual_seed(3),
                     device=dev).to(torch.bfloat16)
    got = fa.flash_attention_bwd(q, k, v, o, lse, go, d**-0.5)
    assert chip_smoke.bwd_rel_err(got, fa.flash_attention_bwd_plain(q, k, v, o, go, d**-0.5)) <= \
        chip_smoke.BWD_TOL


def test_flash_attention_other_head_dims_raise(dev):
    q = torch.zeros(1, 300, 2, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        fa.flash_attention(q, q, q, 0.1)


@pytest.mark.parametrize("n,h", [(257, 6), (362, 6), (362, 16), (1370, 6)])
def test_flash_attention_bwd_kernel(dev, n, h):
    # chip_smoke.py's inputs and tolerance; ragged last query and key tiles
    g = torch.Generator(device=dev).manual_seed(n + h)
    q, k, v, o, lse, go = chip_smoke.bwd_inputs(2, n, h, g, dev)
    before = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, o, lse, go, 0.125)
    assert fa.flash_attention_bwd.launches == before + 1
    want = fa.flash_attention_bwd_plain(q, k, v, o, go, 0.125)
    assert chip_smoke.bwd_rel_err(got, want) <= chip_smoke.BWD_TOL
    assert min(chip_smoke.bwd_mutant_errors(q, k, v, o, go, 0.125).values()) > chip_smoke.BWD_TOL


def test_flash_attention_lse(dev):
    """Kernel A's log-sum-exp: log2 of the softmax denominator of the
    scaled scores, per (b, h, row), within fp32 rounding."""
    b, n, h, d = 2, 300, 6, 64
    qkv = chip_smoke.attention_inputs((b, n, h * d), torch.Generator(device=dev).manual_seed(1), dev)
    q, k, v = (t.view(b, n, h, d) for t in qkv.split(h * d, dim=-1))
    _, lse = fa.flash_attention(q, k, v, d**-0.5, with_lse=True)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d**-0.5
    want = torch.logsumexp(s, dim=-1) / torch.log(torch.tensor(2.0, device=dev))
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("n", [362, 1370, 2443])  # 2443 > 2048: the plain backward
def test_flash_attention_fn_gradients(dev, n):
    """FlashAttentionFn through strided views of one qkv tensor: the qkv
    gradient against fp32 autograd through the plain attention on the same
    bf16 inputs, within chip_smoke.py's tolerance."""
    b, h, d = 2, 6, 64
    gen = torch.Generator(device=dev).manual_seed(n)
    qkv = chip_smoke.attention_inputs((b, n, h * d), gen, dev).requires_grad_()
    go = torch.randn(b, n, h, d, generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = (t.view(b, n, h, d) for t in qkv.split(h * d, dim=-1))
    before = fa.flash_attention_bwd.launches
    (got,) = torch.autograd.grad(fa.FlashAttentionFn.apply(q, k, v, d**-0.5), qkv, go)
    assert fa.flash_attention_bwd.launches == before + int(fa.bwd_gate((b, n, h, d)))
    ref = qkv.detach().float().requires_grad_()
    rq, rk, rv = (t.view(b, n, h, d) for t in ref.split(h * d, dim=-1))
    (want,) = torch.autograd.grad(fa.flash_attention_plain(rq, rk, rv, d**-0.5), ref, go.float())
    for part in range(3):
        sl = slice(part * h * d, (part + 1) * h * d)
        assert chip_smoke.rel_err(got[..., sl], want[..., sl]) <= chip_smoke.BWD_TOL


def test_flash_attention_from_a_fresh_thread(dev):
    """Kernel A's forward and backward launched from a thread that has done
    no CUDA work before, as autograd's backward thread may not have: the
    tensor-map encoder (cuTensorMapEncodeTiled) needs the context that the
    launchers make current first."""
    import threading

    b, n, h, d = 2, 362, 6, 64
    q, k, v, o, lse, go = chip_smoke.bwd_inputs(b, n, h, torch.Generator(device=dev).manual_seed(4),
                                                dev)
    out = {}

    def run():
        try:
            out["fwd"] = fa.flash_attention(q, k, v, d**-0.5)
            out["bwd"] = fa.flash_attention_bwd(q, k, v, o, lse, go, d**-0.5)
            torch.cuda.synchronize()
        except RuntimeError as e:
            out["error"] = e

    worker = threading.Thread(target=run)
    worker.start()
    worker.join()
    assert "error" not in out, out.get("error")
    assert chip_smoke.rel_err(out["fwd"], fa.flash_attention_plain(q, k, v, d**-0.5)) <= \
        chip_smoke.ATTN_TOL
    assert chip_smoke.bwd_rel_err(out["bwd"], fa.flash_attention_bwd_plain(q, k, v, o, go, d**-0.5)) \
        <= chip_smoke.BWD_TOL


@pytest.mark.parametrize("c,t,s", [(64, 32, 37), (192, 32, 37), (192, 8, 37),
                                   (128, 32, 37), (128, 8, 37),  # d = 16: vitb m2/m3
                                   # every width of --attn_impl pallas (d = 32, 48, 128)
                                   (256, 32, 37), (384, 32, 37), (1024, 32, 37),
                                   # T = 17 (masked keys) and a ragged S at every width,
                                   # a ragged last location tile at C = 64 and 128
                                   (64, 17, 101), (128, 17, 101), (192, 17, 101),
                                   (256, 17, 101), (384, 17, 101), (1024, 17, 101),
                                   (64, 8, 3), (1024, 8, 3)])
def test_temporal_attention_kernel(dev, c, t, s):
    g = torch.Generator(device=dev).manual_seed(c + t)
    q, k, v = (x.contiguous() for x in
               chip_smoke.attention_inputs((2, t, s, c), g, dev).split(c, dim=-1))
    before = ta.temporal_attention.launches
    got = ta.temporal_attention(q, k, v, 8, (c // 8) ** -0.5)
    assert ta.temporal_attention.launches == before + 1
    want = ta.temporal_attention_plain(q, k, v, 8, (c // 8) ** -0.5)
    assert chip_smoke.rel_err(got, want) <= chip_smoke.ATTN_TOL


@pytest.mark.parametrize("c", [64, 384])
def test_temporal_attention_split(dev, c):
    """The split entry (copies only) copies q through and is not counted;
    the kernel on ``tile_plan``'s tiles (at C = 64 four locations a tile,
    the last one ragged at S = 29) computes the attention; a width outside
    the domain raises on the card."""
    g = torch.Generator(device=dev).manual_seed(c)
    q, k, v = (x.contiguous() for x in
               chip_smoke.attention_inputs((1, 32, 29, c), g, dev).split(c, dim=-1))
    scale = (c // 8) ** -0.5
    before = ta.temporal_attention.launches
    assert torch.equal(ta.temporal_attention_split(q, k, v, 8, scale), q)
    assert ta.temporal_attention.launches == before
    want = ta.temporal_attention_plain(q, k, v, 8, scale)
    got = ta.temporal_attention(q, k, v, 8, scale)
    assert chip_smoke.rel_err(got, want) <= chip_smoke.ATTN_TOL
    with pytest.raises(NotImplementedError):  # 33 frames: past the kernels' 32-row tiles
        ta.temporal_attention(*(torch.cat([x, x[:, :1]], 1) for x in (q, k, v)), 8, scale)


@pytest.mark.parametrize("c,t,s", [(64, 32, 70), (192, 32, 33), (64, 8, 50), (192, 16, 20),
                                   (256, 32, 37), (256, 8, 21),
                                   (128, 32, 37), (128, 8, 50),    # vitb m2/m3, 4 or 16 locations
                                   (384, 32, 9), (384, 16, 5),     # vitb m0 on 16:9
                                   # every width at every T, S leaving a ragged last CTA
                                   (64, 16, 13), (128, 16, 11), (192, 8, 13), (256, 16, 7),
                                   (384, 8, 11),
                                   # T padded up to 16 or 32 rows a location
                                   (64, 12, 13), (64, 20, 9), (128, 20, 11), (192, 24, 5),
                                   (256, 24, 5), (384, 12, 7)])
def test_motion_module_kernel(dev, c, t, s):
    g = torch.Generator().manual_seed(c)
    n = lambda *sh, std: (torch.randn(*sh, generator=g) * std).to(dev)  # noqa: E731
    p = dict(gn_scale=1 + n(c, std=0.1), gn_bias=n(c, std=0.1), w_in=n(c, c, std=c**-0.5),
             b_in=n(c, std=0.1), ln_scale=1 + n(3, c, std=0.1), ln_bias=n(3, c, std=0.1),
             wq=n(2, c, c, std=c**-0.5), wk=n(2, c, c, std=c**-0.5), wv=n(2, c, c, std=c**-0.5),
             wo=n(2, c, c, std=c**-0.5), bo=n(2, c, std=0.1), w1=n(c, 8 * c, std=c**-0.5),
             b1=n(8 * c, std=0.1), w2=n(4 * c, c, std=(4 * c) ** -0.5), b2=n(c, std=0.1),
             w_out=n(c, c, std=c**-0.5), b_out=n(c, std=0.1))
    x = _randn(dev, 2, t, s, c, seed=1)
    cfg = MotionModuleConfig()
    before = mm.fused_motion_module.launches
    got = mm.fused_motion_module(x, p, cfg, 8).float()
    assert mm.fused_motion_module.launches == before + 1
    want = mm.motion_module_plain(x, p, cfg, 8).float()
    # chip_smoke.py's tolerance, relative to the module's own contribution
    module_part = float((want - x.float()).abs().max())
    assert float((got - want).abs().max()) <= chip_smoke.MOTION_TOL * module_part


@pytest.mark.parametrize("n,h,w,oh,ow", [
    (1, 8, 12, 14, 21),      # one frame, one ragged tile in each direction
    (3, 24, 40, 42, 70),     # several frames and tiles, out_w not a multiple of 32
    (2, 37, 21, 65, 37),     # odd sizes, out_h not a multiple of 8
    (2, 296, 296, 518, 518),  # vitl 518x518's map, more tiles than SMs
])
def test_output_tail_kernel(dev, n, h, w, oh, ow):
    x, w1, b1, w2, b2 = chip_smoke.tail_inputs(n, h, w, torch.Generator(device=dev).manual_seed(n),
                                               dev)
    before = ot.output_tail.launches
    got = ot.output_tail(x, w1, b1, w2, b2, oh, ow)
    assert ot.output_tail.launches == before + 1
    assert got.shape == (n, oh, ow, 1)
    assert chip_smoke.rel_err(got, ot.output_tail_plain(x, w1, b1, w2, b2, oh, ow)) <= \
        chip_smoke.TAIL_TOL


# ragged query and key tiles; at n = 320 the last 64-key tile is all padding
@pytest.mark.parametrize("n,h", [(320, 2), (100, 2), (200, 6), (1370, 2), (300, 6), (1370, 6)])
@pytest.mark.parametrize("variant", ["ilv", "nomask", "chunk1", "chunk2", "chunk4", "sbf16",
                                     "sbf16:fast", "ceiling"])
def test_spatial_probe_kernels(dev, variant, n, h):
    """Each spatial probe kernel against its plain version on the probe
    script's inputs, with chip_smoke.py's tolerance and mutants; variants
    outside the JAX domain raise before any launch."""
    q, k, v = chip_smoke.probe_inputs(2, n, h, torch.Generator(device=dev).manual_seed(n + h), dev)
    counters = (av.ilv_attention, av.chunk_attention, av.sbf16_attention)
    before = sum(f.launches for f in counters)
    try:
        av.parse_variant(variant, n)
    except ValueError:
        with pytest.raises(ValueError):
            av.spatial_variant(variant, q, k, v, 0.125, n, h)
        assert sum(f.launches for f in counters) == before
        return
    got = av.spatial_variant(variant, q, k, v, 0.125, n, h)
    assert sum(f.launches for f in counters) == before + 1
    want = av.spatial_variant_plain(variant, q, k, v, 0.125, n, h)
    assert chip_smoke.rel_err(got, want) <= chip_smoke.ATTN_TOL
    assert min(chip_smoke.probe_mutant_errors(variant, q, k, v, 0.125, h).values()) > \
        chip_smoke.ATTN_TOL


# (100, 256): one query block; (300, 384): three blocks, the last
# partial; (200, 320): an odd count of key tiles; (64, 64):
# one key tile; (1376, 1408): the script's shape, 11 blocks
@pytest.mark.parametrize("nq,nk", [(100, 256), (300, 384), (200, 320), (64, 64), (1376, 1408)])
@pytest.mark.parametrize("mode", av.CHAIN_MODES)
def test_softmax_chain_kernel(dev, mode, nq, nk):
    q, k, v = chip_smoke.chain_inputs(4, torch.Generator(device=dev).manual_seed(nq), dev, nq, nk)
    before = av.softmax_chain.launches
    got = av.softmax_chain(mode, q, k, v)
    assert av.softmax_chain.launches == before + 1
    assert chip_smoke.rel_err(got, av.softmax_chain_plain(mode, q, k, v)) <= chip_smoke.CHAIN_TOL
    if nk > 64:  # the mutants drop the last key tile
        assert min(chip_smoke.chain_mutant_errors(mode, q, k, v).values()) > chip_smoke.CHAIN_TOL


def test_softmax_chain_kernel_reads_v_first_columns(dev):
    """V wider than 64 (the map's row stride is Dv), also given as a
    strided view: the kernel reads V's first 64 columns."""
    q, k, v = chip_smoke.chain_inputs(2, torch.Generator(device=dev).manual_seed(3), dev, 200, 256)
    wide = torch.cat([v, v], dim=-1)  # Dv = 256
    for vv in (wide, wide[..., 64:192]):
        got = av.softmax_chain("exp", q, k, vv)
        want = av.softmax_chain_plain("exp", q, k, vv)
        assert chip_smoke.rel_err(got, want) <= chip_smoke.CHAIN_TOL


@pytest.mark.parametrize("n,h,w,c,oh,ow", [
    (1, 8, 12, 128, 15, 23),      # one frame, ragged tiles in both directions
    (2, 6, 10, 256, 12, 20),      # two channel chunks
    (3, 21, 37, 384, 42, 70),     # three chunks, several tiles
    (2, 40, 36, 128, 19, 23),     # downsampling: taps read from global memory
    (1, 19, 21, 256, 19, 21),     # the same size: taps wider than the patch
    (1, 19, 21, 256, 21, 23),     # near the same size
    (1, 5, 7, 128, 64, 90),       # a large upsampling, one source pixel a tile
    (140, 8, 8, 128, 16, 16),     # more tiles than SMs: each CTA walks several
])
def test_resize_conv_kernel(dev, n, h, w, c, oh, ow):
    x, wc, bc = chip_smoke.resize_conv_inputs(n, h, w, c, torch.Generator(device=dev).manual_seed(c),
                                              dev)
    before = rc.resize_conv.launches
    got = rc.resize_conv(x, wc, bc, oh, ow)
    assert rc.resize_conv.launches == before + 1
    assert got.shape == (n, oh, ow, 128)
    want = rc.resize_conv_plain(x, wc, bc, oh, ow)
    assert chip_smoke.rel_err(got, want) <= chip_smoke.RESIZE_CONV_TOL
    assert min(chip_smoke.resize_conv_mutant_errors(x, wc, bc, oh, ow).values()) > \
        chip_smoke.RESIZE_CONV_TOL


def test_resize_conv_fn_gradients(dev):
    """ResizeConvFn: the kernel forward and the plain chain's gradients,
    against autograd through resize_conv_plain."""
    g = torch.Generator(device=dev).manual_seed(9)
    x, wc, bc = (t.requires_grad_() for t in chip_smoke.resize_conv_inputs(2, 8, 8, 256, g, dev))
    cot = torch.randn(2, 16, 16, 128, generator=g, device=dev).to(torch.bfloat16)
    before = rc.resize_conv.launches
    out = rc.ResizeConvFn.apply(x, wc, bc, 16, 16)
    got = (out, *torch.autograd.grad(out, (x, wc, bc), cot))
    assert rc.resize_conv.launches == before + 1
    ref = rc.resize_conv_plain(x, wc, bc, 16, 16)
    want = (ref, *torch.autograd.grad(ref, (x, wc, bc), cot))
    with torch.no_grad():
        assert chip_smoke.rel_err(got[0], want[0]) <= chip_smoke.RESIZE_CONV_TOL
        for a, b in zip(got[1:], want[1:]):
            assert chip_smoke.rel_err(a, b) <= chip_smoke.RESIZE_CONV_GRAD_TOL


@pytest.mark.parametrize("c", mm.SPLIT_C)
def test_motion_module_split(dev, c):
    """The split's stops run and the stages sum to the whole kernel."""
    p = chip_smoke.motion_params(c, seed=c, device=dev)
    cfg = MotionModuleConfig()
    w = mm.kernel_weights(p, cfg)
    x = _randn(dev, 1, 32, 300, c, seed=2)
    gna, gnb = mm.gn_fold(x, w, cfg)
    before = mm.fused_motion_module.launches
    split = mm.motion_module_split(x, gna, gnb, w, cfg, 8, iters=3)
    assert mm.fused_motion_module.launches == before
    assert set(split) == set(mm.SPLIT_STAGES) | {"whole"}
    assert abs(sum(split[k] for k in mm.SPLIT_STAGES) - split["whole"]) < 1e-3


def test_output_tail_split_and_refusal(dev):
    x, w1, b1, w2, b2 = chip_smoke.tail_inputs(2, 37, 21, torch.Generator(device=dev).manual_seed(0),
                                               dev)
    split = ot.output_tail_split(x, w1, b1, w2, b2, 65, 37, iters=3)
    assert set(split) == set(ot.SPLIT_STAGES) | {"whole"} and split["whole"] > 0
    with pytest.raises(NotImplementedError, match="source pixels"):
        ot.output_tail(x, w1, b1, w2, b2, 20, 12)  # a downscale: taps spread over the patch


# -- the fp32 kernels (csrc/*_f32.cu), held to chip_smoke.py's fp32 tolerance -----------


@pytest.fixture
def no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.parametrize("n,h,d,fast", [
    (257, 6, 64, False), (362, 6, 64, True), (1370, 3, 64, False), (2443, 2, 64, True),
    (64, 1, 192, False), (300, 2, 192, True), (1370, 1, 192, False), (2443, 2, 192, False),
])
def test_flash_attention_f32_kernel(dev, no_tf32, n, h, d, fast):
    """fp32 operands: the fp32 kernel (3xTF32), ragged last key tiles (64
    keys at D = 64, 32 at D = 192), odd heads, D = 192, flat inputs too;
    its own launch count; no log-sum-exp."""
    g = torch.Generator(device=dev).manual_seed(n + h + d)
    qkv = chip_smoke.f32_inputs((2, n, h * d), g, dev)
    q, k, v = (t.view(2, n, h, d) for t in qkv.split(h * d, dim=-1))
    before = (fa.flash_attention.launches, fa.flash_attention.fast_launches,
              fa.flash_attention.f32_launches)
    got = fa.flash_attention(q, k, v, d**-0.5, fast=fast)
    assert (fa.flash_attention.launches, fa.flash_attention.fast_launches,
            fa.flash_attention.f32_launches) == (before[0], before[1], before[2] + 1)
    assert got.dtype == torch.float32
    want = fa.flash_attention_plain(q, k, v, d**-0.5, fast=fast)
    assert chip_smoke.rel_err(got, want) <= chip_smoke.F32_TOL
    qf = chip_smoke.flat_inputs(q)
    assert chip_smoke.rel_err(fa.flash_attention(qf, k, v, d**-0.5, fast=fast),
                              fa.flash_attention_plain(qf, k, v, d**-0.5, fast=fast)) <= \
        chip_smoke.F32_TOL
    with pytest.raises(ValueError, match="log-sum-exp"):
        fa.flash_attention(q, k, v, d**-0.5, with_lse=True)


def test_flash_attention_fn_in_fp32(dev, no_tf32):
    """FlashAttentionFn in fp32: the fp32 kernel forward, the plain backward."""
    b, n, h, d = 1, 300, 2, 64
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (t.view(b, n, h, d).detach().requires_grad_()
               for t in chip_smoke.f32_inputs((b, n, h * d), g, dev).split(h * d, dim=-1))
    before = fa.flash_attention.f32_launches
    out = fa.FlashAttentionFn.apply(q, k, v, d**-0.5, False)
    assert fa.flash_attention.f32_launches == before + 1
    go = torch.randn(b, n, h, d, device=dev, generator=g)
    got = torch.autograd.grad(out, (q, k, v), go)
    ref = fa.flash_attention_plain(q, k, v, d**-0.5)
    want = torch.autograd.grad(ref, (q, k, v), go)
    for a, w in zip(got, want):
        assert chip_smoke.rel_err(a, w) <= chip_smoke.F32_TOL


@pytest.mark.parametrize("c,t,s", [(64, 32, 37), (128, 8, 37), (192, 32, 37), (256, 32, 37),
                                   (384, 32, 37), (1024, 32, 37), (64, 17, 101), (384, 17, 101),
                                   (1024, 8, 3), (64, 1, 5)])
def test_temporal_attention_f32_kernel(dev, no_tf32, c, t, s):
    """fp32 operands at every head width, T = 17 and 1, a ragged last
    location tile (two locations a tile at C = 64 in fp32)."""
    g = torch.Generator(device=dev).manual_seed(c + t)
    q, k, v = (x.contiguous() for x in chip_smoke.f32_inputs((2, t, s, c), g, dev).split(c, dim=-1))
    before = (ta.temporal_attention.launches, ta.temporal_attention.f32_launches)
    got = ta.temporal_attention(q, k, v, 8, (c // 8) ** -0.5)
    assert (ta.temporal_attention.launches, ta.temporal_attention.f32_launches) == \
        (before[0], before[1] + 1)
    want = ta.temporal_attention_plain(q, k, v, 8, (c // 8) ** -0.5)
    assert chip_smoke.rel_err(got, want) <= chip_smoke.F32_TOL


@pytest.mark.parametrize("c,t,s", [(64, 32, 70), (64, 8, 50), (128, 16, 11), (192, 32, 33),
                                   (192, 8, 13), (256, 16, 7), (384, 32, 9), (384, 8, 11),
                                   # T padded up to 16 or 32 rows a location
                                   (64, 12, 13), (128, 20, 11), (192, 12, 7), (256, 24, 5),
                                   (384, 20, 3)])
def test_motion_module_f32_kernel(dev, no_tf32, c, t, s):
    """fp32 operands at every width and T, S leaving a ragged last CTA,
    against the plain module (erf GELU), relative to max|plain - x|; the
    fp32 weights' dtype must match x's."""
    p = chip_smoke.motion_params(c, seed=c, device=dev)
    x = torch.randn(2, t, s, c, device=dev, generator=torch.Generator(device=dev).manual_seed(s))
    cfg = MotionModuleConfig()
    before = (mm.fused_motion_module.launches, mm.fused_motion_module.f32_launches)
    got = mm.fused_motion_module(x, p, cfg, 8)
    assert (mm.fused_motion_module.launches, mm.fused_motion_module.f32_launches) == \
        (before[0], before[1] + 1)
    want = mm.motion_module_plain(x, p, cfg, 8)
    assert float((got - want).abs().max()) <= chip_smoke.F32_TOL * float((want - x).abs().max())
    w = mm.kernel_weights(p, cfg)  # the bf16 layout
    gna, gnb = mm.gn_fold(x, w, cfg)
    with pytest.raises(ValueError, match="kernel_weights"):
        mm.motion_module_launch(x, gna, gnb, w, cfg, 8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,t,s", [(768, 32, 9), (768, 8, 21), (768, 12, 13), (1024, 32, 5),
                                   (1024, 16, 11), (1024, 20, 9), (1024, 32, 41)])
def test_motion_module_wide_kernel(dev, no_tf32, dtype, c, t, s):
    """Kernel C's wide chain (C = 768 and 1024, the widths VDA_FUSED_MOTION=1
    reaches) in bf16 and fp32: B·T·S leaving a ragged last 128-row GEMM
    tile, T padded up to 16 or 32 key frames, against the plain module
    relative to max|plain - x| (MOTION_TOL in bf16, F32_TOL in fp32); one
    launch on its own counter, none on the resident kernel's."""
    p = chip_smoke.motion_params(c, seed=c, device=dev)
    x = torch.randn(2, t, s, c, device=dev, generator=torch.Generator(device=dev).manual_seed(s))
    x = x.to(dtype)
    cfg = MotionModuleConfig()
    f = mm.fused_motion_module
    before = (f.launches, f.f32_launches, f.wide_launches, f.wide_f32_launches)
    got = f(x, p, cfg, 8).float()
    f32 = dtype == torch.float32
    assert (f.launches, f.f32_launches, f.wide_launches, f.wide_f32_launches) == \
        (before[0], before[1], before[2] + (not f32), before[3] + f32)
    want = mm.motion_module_plain(x, p, cfg, 8).float()
    tol = chip_smoke.F32_TOL if f32 else chip_smoke.MOTION_TOL
    assert float((got - want).abs().max()) <= tol * float((want - x.float()).abs().max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("heads,c,t,s", [(8, 40, 32, 29), (4, 12, 17, 33), (16, 48, 8, 9),
                                         (4, 384, 32, 13), (1, 512, 32, 5), (16, 2048, 24, 3),
                                         (8, 512, 32, 7), (2, 6, 32, 70), (1, 5, 32, 9),
                                         (1, 320, 17, 7), (2, 512, 32, 11), (16, 16, 32, 41),
                                         (1, 448, 17, 6), (1, 160, 32, 300)])
def test_temporal_attention_any_kernel(dev, no_tf32, dtype, heads, c, t, s):
    """Kernel B off its instantiated widths (the run-time-d kernels): packed
    small heads, odd d, d = 96, 512 and 64, ragged location tiles, in fp32
    the cp.async loader (C = 5 and 6) and rows of two and three boxes, a
    slot a tensor (d = 160 - 512 at one head, class 4 at d = 448, 512),
    against the plain version (ATTN_TOL in bf16, F32_TOL in fp32); one
    launch on its own counter."""
    g = torch.Generator(device=dev).manual_seed(c + t)
    q, k, v = (x.contiguous().to(dtype) for x in
               chip_smoke.attention_inputs((2, t, s, c), g, dev).split(c, dim=-1))
    scale = (c // heads) ** -0.5
    f = ta.temporal_attention
    f32 = dtype == torch.float32
    before = (f.launches, f.f32_launches, f.any_launches, f.any_f32_launches)
    got = f(q, k, v, heads, scale)
    assert (f.launches, f.f32_launches, f.any_launches, f.any_f32_launches) == \
        (before[0], before[1], before[2] + (not f32), before[3] + f32)
    want = ta.temporal_attention_plain(q, k, v, heads, scale)
    assert chip_smoke.rel_err(got, want) <= (chip_smoke.F32_TOL if f32 else chip_smoke.ATTN_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("heads,c,t,s", [(8, 40, 32, 29), (1, 5, 32, 9), (1, 512, 32, 5)])
def test_temporal_attention_any_split(dev, dtype, heads, c, t, s):
    """The run-time-d kernels' split (copies in and out alone) returns q
    unchanged and counts no launch."""
    g = torch.Generator(device=dev).manual_seed(c)
    q, k, v = (torch.randn(1, t, s, c, device=dev, generator=g).to(dtype) for _ in range(3))
    f = ta.temporal_attention
    before = (f.any_launches, f.any_f32_launches)
    assert torch.equal(ta.temporal_attention_split(q, k, v, heads, (c // heads) ** -0.5), q)
    assert (f.any_launches, f.any_f32_launches) == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("heads,blocks,ff,c,t,s", [
    (4, 1, 4, 64, 32, 37), (16, 3, 2, 96, 12, 13), (8, 2, 4, 40, 20, 9), (8, 2, 4, 512, 8, 21),
    (8, 1, 4, 1152, 16, 11), (4, 2, 4, 320, 32, 5), (8, 2, 2, 8, 32, 9)])
def test_motion_module_domain_kernel(dev, no_tf32, dtype, heads, blocks, ff, c, t, s):
    """Kernel C off the resident kernels' domain (the wide chain with run-time
    heads, attention blocks and hidden width, ragged panels and column
    blocks) against the plain module, relative to max|plain - x|."""
    import math

    cfg = MotionModuleConfig(num_heads=heads, num_attention_blocks=blocks, ff_mult=ff,
                             norm_num_groups=math.gcd(32, c))
    p = chip_smoke.domain_motion_params(c, blocks, ff, c + blocks, dev)
    x = torch.randn(1, t, s, c, device=dev, generator=torch.Generator(device=dev).manual_seed(s))
    x = x.to(dtype)
    f = mm.fused_motion_module
    f32 = dtype == torch.float32
    before = (f.wide_launches, f.wide_f32_launches)
    got = f(x, p, cfg, heads).float()
    assert (f.wide_launches, f.wide_f32_launches) == (before[0] + (not f32), before[1] + f32)
    want = mm.motion_module_plain(x, p, cfg, heads).float()
    tol = chip_smoke.F32_TOL if f32 else chip_smoke.MOTION_TOL
    assert float((got - want).abs().max()) <= tol * float((want - x.float()).abs().max())


@pytest.mark.parametrize("c", [32, 64])
@pytest.mark.parametrize("n,h,w,oh,ow", [(4, 10, 24, 18, 42), (2, 37, 21, 65, 37),
                                         (8, 40, 40, 70, 70)])
def test_output_tail_narrow_kernel(dev, c, n, h, w, oh, ow):
    """The tail at vits' and vitb's head widths, ragged tiles both ways,
    within TAIL_TOL of the plain chain; counted by width."""
    g = torch.Generator(device=dev).manual_seed(c + n)
    r = lambda *s, std: torch.randn(*s, generator=g, device=dev) * std  # noqa: E731
    x = r(n, h, w, c, std=1.0).to(torch.bfloat16)
    w1, b1, w2, b2 = r(32, c, 3, 3, std=0.1), r(32, std=0.1), r(1, 32, 1, 1, std=0.3), r(1, std=0.1)
    before = ot.output_tail.width_launches.get(c, 0)
    got = ot.output_tail(x, w1, b1, w2, b2, oh, ow)
    assert ot.output_tail.width_launches[c] == before + 1
    want = ot.output_tail_plain(x, w1, b1, w2, b2, oh, ow)
    assert chip_smoke.rel_err(got, want) <= chip_smoke.TAIL_TOL


def test_fp32_window_through_the_fp32_kernels(dev, no_tf32):
    """A small fp32 window on the card (vits, 4 encoder blocks, 322x322, T =
    8: Kernel A at 529 tokens, Kernel C at m3) against the plain path."""
    import dataclasses

    from video_depth_anything_torch.config import get_model_config
    from video_depth_anything_torch.models.vda import VDAModel
    from video_depth_anything_torch.ops.dispatch import plain_reference

    cfg = get_model_config("vits")
    cfg = dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit, depth=4),
                              intermediate_layer_idx=(0, 1, 2, 3))
    model = VDAModel(cfg=cfg, device=dev, dtype=torch.float32)
    model.init_params(seed=0)
    chip_smoke.noise_weights(model.module, seed=1)
    x = torch.randn(1, 8, 322, 322, 3, device=dev, generator=torch.Generator(device=dev).manual_seed(3))
    before = (fa.flash_attention.f32_launches, mm.fused_motion_module.f32_launches)
    got = model.infer_window(x)
    assert fa.flash_attention.f32_launches == before[0] + 4
    assert mm.fused_motion_module.f32_launches == before[1] + 1
    with plain_reference():
        want = model.infer_window(x)
    assert chip_smoke.rel_err(got, want) <= chip_smoke.F32_WINDOW_TOL


def _wide_counts():
    f = fa.flash_attention
    return (f.launches, f.fast_launches, f.f32_launches, f.wide_launches, f.wide_f32_launches)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,h,d,fast", [
    (300, 1, 320, False), (1370, 2, 320, True), (2443, 3, 320, False), (257, 4, 448, True),
    (64, 1, 576, False), (130, 5, 704, True), (300, 2, 1984, False), (65, 3, 1984, True),
])
def test_flash_attention_wide_kernel(dev, no_tf32, dtype, n, h, d, fast):
    """D >= 320 (``csrc/flash_attention_wide.cu``): peaked and flat inputs
    against the plain version (ATTN_TOL in bf16, F32_TOL in fp32), ragged
    and whole key tiles, one to five heads, one 320-column slice and the
    overlapping last one, Q resident and streamed; only the wide counter of
    the dtype moves; the wrong plans of chip_smoke.wide_mutant_errors miss."""
    f32 = dtype == torch.float32
    g = torch.Generator(device=dev).manual_seed(n + h + d)
    qkv = (chip_smoke.f32_inputs if f32 else chip_smoke.attention_inputs)((2, n, h * d), g, dev)
    q, k, v = (t.view(2, n, h, d) for t in qkv.split(h * d, dim=-1))
    tol = chip_smoke.F32_TOL if f32 else chip_smoke.ATTN_TOL
    before = _wide_counts()
    got = fa.flash_attention(q, k, v, d**-0.5, fast=fast)
    assert _wide_counts() == (*before[:3], before[3] + (not f32), before[4] + f32)
    assert got.dtype == dtype
    plain = lambda *x: fa.flash_attention_plain(*x, fast=fast)  # noqa: E731
    assert chip_smoke.rel_err(got, plain(q, k, v, d**-0.5)) <= tol
    qf = chip_smoke.flat_inputs(q)
    assert chip_smoke.rel_err(fa.flash_attention(qf, k, v, d**-0.5, fast=fast),
                              plain(qf, k, v, d**-0.5)) <= tol
    mutants = chip_smoke.wide_mutant_errors(plain, q, k, v, qf, d**-0.5, f32=f32)
    if n % (32 if f32 else 64) == 0:  # no pad keys to count (32-key tiles in fp32)
        mutants.pop("unmasked_zero_pad")
    assert min(mutants.values()) > tol
    with pytest.raises(ValueError, match="log-sum-exp"):
        fa.flash_attention(q, k, v, d**-0.5, with_lse=True)


def test_flash_attention_wide_refuses_what_it_cannot_read(dev):
    """D = 320 views that no 16-byte copy can read raise before a launch."""
    b, n, h, d = 1, 300, 2, 320
    x = torch.zeros(b, n, h * d + 4, device=dev, dtype=torch.bfloat16)
    q = x[..., 4:4 + h * d].unflatten(-1, (h, d))  # an 8-byte offset
    with pytest.raises(ValueError, match="aligned base"):
        fa.flash_attention(q, q, q, d**-0.5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_fn_at_d320(dev, no_tf32, dtype):
    """FlashAttentionFn at D = 320 through strided views of one qkv tensor:
    the wide kernel forward (no log-sum-exp kept), the plain backward (no
    backward kernel launch), against autograd through the plain attention
    in fp32 on the same inputs."""
    b, n, h, d = 2, 362, 4, 320
    gen = torch.Generator(device=dev).manual_seed(d)
    f32 = dtype == torch.float32
    qkv = (chip_smoke.f32_inputs if f32 else chip_smoke.attention_inputs)((b, n, h * d), gen, dev)
    qkv = qkv.requires_grad_()
    go = torch.randn(b, n, h, d, generator=gen, device=dev).to(dtype)
    q, k, v = (t.view(b, n, h, d) for t in qkv.split(h * d, dim=-1))
    before = (_wide_counts(), fa.flash_attention_bwd.launches)
    (got,) = torch.autograd.grad(fa.FlashAttentionFn.apply(q, k, v, d**-0.5), qkv, go)
    after = (_wide_counts(), fa.flash_attention_bwd.launches)
    assert after[1] == before[1] and after[0][3 + f32] == before[0][3 + f32] + 1
    ref = qkv.detach().float().requires_grad_()
    rq, rk, rv = (t.view(b, n, h, d) for t in ref.split(h * d, dim=-1))
    (want,) = torch.autograd.grad(fa.flash_attention_plain(rq, rk, rv, d**-0.5), ref, go.float())
    tol = chip_smoke.F32_TOL if f32 else chip_smoke.BWD_TOL
    for part in range(3):
        sl = slice(part * h * d, (part + 1) * h * d)
        assert chip_smoke.rel_err(got[..., sl], want[..., sl]) <= tol
