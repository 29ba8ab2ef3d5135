"""The probe kernels' plain versions (``ops/attention_variants.py``) against
the TPU kernels of ``scripts/bench_spatial_variants.py`` and
``scripts/bench_softmax_chain.py`` in Pallas interpret mode, on the same
seeded inputs; ``exp2_poly`` against ``_exp2_poly``; the domain errors;
``chip_smoke.py``'s check of the kernels."""

import functools
import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import chip_smoke
from video_depth_anything_torch.ops import attention_variants as av
from tests.torch_port_helpers import chain_kern
from video_depth_anything_tpu.ops.pallas_attention import _exp2_poly
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parent.parent
BF16_ULP = 2.0**-8
# bf16 outputs: kernel (interpret) and plain version round at the same
# points and differ in fp32 summation order, so within 2 bf16 ulps of
# max|output|.
TOL = 2 * BF16_ULP


@pytest.fixture(scope="module")
def bsv():
    """``scripts/bench_spatial_variants.py`` with ``pl.pallas_call`` in
    interpret mode: its ``pl`` swapped for a namespace, nothing edited."""
    spec = importlib.util.spec_from_file_location(
        "bench_spatial_variants", ROOT / "scripts" / "bench_spatial_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True), BlockSpec=pl.BlockSpec)
    return mod


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=TOL)


def test_exp2_poly_matches_jax():
    """Over [−250, 130]: the −200 input clamp, the exponent clamps to 0 and
    254, and the polynomial in between (fp32; FMA contraction may move the
    last bit)."""
    x = np.concatenate([np.linspace(-250, 130, 20011, dtype=np.float32),
                        np.float32([-200, -127.5, -127, -126.25, 0, 0.5, 127, 127.75, 128])])
    got = av.exp2_poly(torch.from_numpy(x)).numpy()
    want = np.asarray(_exp2_poly(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (got[x < -127] == 0).all() and np.isfinite(got).all()


def _spatial_inputs(n, heads=2, d=64, b=1, seed=0):
    """The script's inputs (bench_spatial_variants.py:250-252): q, k at std
    0.5, v at 1, bf16."""
    rng = np.random.RandomState(seed + n)
    return [(rng.randn(b, n, heads * d) * s).astype(np.float32) for s in (0.5, 0.5, 1.0)]


@pytest.mark.parametrize("n", [64, 40])
@pytest.mark.parametrize("variant", ["ilv", "nomask", "chunk2", "chunk4", "chunk8", "sbf16",
                                     "sbf16:fast", "ceiling"])
def test_spatial_variant_plain_matches_run_variant(bsv, variant, n):
    q, k, v = _spatial_inputs(n)
    kw = dict(scale=64**-0.5, n_valid=n, num_heads=2)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    try:
        want = bsv.run_variant(variant, jq, jk, jv, **kw)
    except (AssertionError, ValueError):
        # outside the domain: chunk4 and chunk8 at n = 40 (48 rows)
        with pytest.raises(ValueError):
            av.spatial_variant_plain(variant, tq, tk, tv, **kw)
        with pytest.raises(ValueError):
            av.spatial_variant(variant, tq, tk, tv, **kw)
        assert n == 40 and variant in ("chunk4", "chunk8")
        return
    got = av.spatial_variant_plain(variant, tq, tk, tv, **kw)
    _close(got.float().numpy(), want)
    # the wrapper takes the plain version on CPU tensors (the CPU's fp32
    # GEMMs may sum in another order from one call to the next)
    _close(av.spatial_variant(variant, tq, tk, tv, **kw).float().numpy(), got.float().numpy())


def test_domain_errors_match_the_script():
    q = torch.zeros(1, 1370, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        av.parse_variant("chunk8", 1370)      # 1376 / 8 = 172 rows
    assert av.parse_variant("chunk2", 1370) == ("chunk", 2)
    assert av.parse_variant("chunk4", 1370) == ("chunk", 4)
    for bad in ("chunk", "chunkx", "chunk0", "flash"):
        with pytest.raises(ValueError):
            av.parse_variant(bad, 1370)
    with pytest.raises(ValueError):
        av.spatial_variant("ilv", q, q, q, 0.125, 1000, 2)   # n_valid is q's token count
    with pytest.raises(ValueError):
        av.spatial_variant("ilv", q[..., :192], q[..., :192], q[..., :192], 0.125, 1370, 3)


def _chain_inputs(bh=2, nq=32, nk=64, d=64, dv=128, seed=0):
    """The script's inputs at a small size (bench_softmax_chain.py:48-51)."""
    rng = np.random.RandomState(seed)
    return (rng.randn(bh, nq, d) * 0.35, rng.randn(bh, nk, d) * 0.35, rng.randn(bh, nk, dv))


@pytest.mark.parametrize("mode", av.CHAIN_MODES)
def test_softmax_chain_plain_matches_kern(mode):
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in _chain_inputs())
    bh, nq, d = q.shape
    nk, dv = v.shape[1:]
    want = pl.pallas_call(
        chain_kern(mode, d), grid=(bh,),
        in_specs=[pl.BlockSpec((1, nq, d), lambda b: (b, 0, 0)),
                  pl.BlockSpec((1, nk, d), lambda b: (b, 0, 0)),
                  pl.BlockSpec((1, nk, dv), lambda b: (b, 0, 0))],
        out_specs=pl.BlockSpec((1, nq, d), lambda b: (b, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((bh, nq, d), q.dtype), interpret=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16) for a in (q, k, v))
    got = av.softmax_chain_plain(mode, tq, tk, tv)
    _close(got.float().numpy(), want)
    _close(av.softmax_chain(mode, tq, tk, tv).float().numpy(), got.float().numpy())


def test_wrappers_count_no_launch_on_cpu():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _spatial_inputs(40))
    before = [f.launches for f in (av.ilv_attention, av.chunk_attention, av.sbf16_attention,
                                   av.softmax_chain)]
    for variant in ("ilv", "chunk2", "ceiling"):
        av.spatial_variant(variant, q, k, v, 0.125, 40, 2)
    av.softmax_chain("exp", *(t.view(2, 40, 64) for t in (q, k)), v.view(2, 40, 64))
    assert before == [f.launches for f in (av.ilv_attention, av.chunk_attention,
                                           av.sbf16_attention, av.softmax_chain)]


@pytest.mark.parametrize("variant", ["ilv", "nomask", "chunk2", "sbf16", "sbf16:fast",
                                     "ceiling"])
def test_smoke_check_separates_right_from_wrong_spatial(bsv, variant):
    """chip_smoke.py's check of a spatial probe kernel on its peaked inputs:
    the TPU kernel (interpret) is within the tolerance of the plain version;
    uniform attention, a dropped last key tile and, for the no-mask
    variants, a missing pad correction are not."""
    b, n, h = 1, 200, 2
    q, k, v = chip_smoke.probe_inputs(b, n, h, torch.Generator().manual_seed(5), "cpu")
    kw = dict(scale=64**-0.5, n_valid=n, num_heads=h)
    want = av.spatial_variant_plain(variant, q, k, v, **kw)
    jax_out = bsv.run_variant(variant, *(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                                         for t in (q, k, v)), **kw)
    assert chip_smoke.rel_err(torch.from_numpy(np.asarray(jax_out, np.float32)), want) <= \
        chip_smoke.ATTN_TOL
    mutants = chip_smoke.probe_mutant_errors(variant, q, k, v, 64**-0.5, h)
    assert min(mutants.values()) > chip_smoke.ATTN_TOL, mutants


@pytest.mark.parametrize("mode", av.CHAIN_MODES)
def test_smoke_check_separates_right_from_wrong_chain(mode):
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _chain_inputs(nq=48, nk=256))
    mutants = chip_smoke.chain_mutant_errors(mode, q, k, v)
    assert min(mutants.values()) > chip_smoke.CHAIN_TOL, mutants
