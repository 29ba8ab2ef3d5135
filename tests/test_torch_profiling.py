"""The port's ``utils/profiling.py`` and ``profile_model`` on the CPU:
``param_counts`` against JAX's for every encoder (the port's module on the
``meta`` device, JAX's tree through ``jax.eval_shape``: nothing of vitg's
1.3 B parameters is allocated), ``compiled_cost``'s FLOPs against an
analytic count of a small window's products and convolutions and its bytes
against a product's, ``time_fn``, ``trace``'s Chrome trace, and the keys
``profile_model --device cpu`` prints against the JAX CLI's."""

import contextlib
import dataclasses
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import jax_param_shapes
from tests.torch_port_helpers import one_torch_thread  # noqa: F401
from video_depth_anything_torch.config import get_model_config
from video_depth_anything_torch.models import layers
from video_depth_anything_torch.models.vda import VideoDepthAnything
from video_depth_anything_torch.utils import profiling

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("encoder", ["vits", "vitb", "vitl", "vitg"])
def test_param_counts_match_jax(encoder):
    from video_depth_anything_tpu.models.vda import VDAModel as JaxVDA
    from video_depth_anything_tpu.utils.profiling import param_counts as jax_param_counts

    with torch.device("meta"):
        module = VideoDepthAnything(get_model_config(encoder))
    jm = JaxVDA(encoder)
    shapes = jax_param_shapes(jm.module, jnp.zeros((1, 2, 28, 28, 3), jnp.float32))
    got, want = profiling.param_counts(module), jax_param_counts(shapes)
    assert got == pytest.approx(want, rel=0, abs=1e-9)
    dead = sum(p.numel() for n, p in module.named_parameters()
               if n.startswith(profiling.DEAD_AT_INFERENCE))
    assert sum(p.numel() for p in module.parameters()) == round(want["total_Mparams"] * 1e6) + dead
    if encoder == "vitg":
        assert 1.2e3 < got["total_Mparams"] < 1.4e3


def _analytic_flops(module, cfg, b, t, h, w):
    """2 FLOPs a multiply-add over the window's products and convolutions:
    every Linear, Conv2d and ConvTranspose2d module at the shapes it is
    called with, the patch embedding (a GEMM over patches), the output
    tail's functional conv3x3 and 1×1, the spatial and temporal attention
    products, and the bicubic resize of the positional grid (two GEMMs)."""
    total = [0]

    def hook(mod, inp, out):
        x = inp[0]
        if isinstance(mod, torch.nn.Linear):
            total[0] += 2 * x.numel() * mod.out_features
        elif isinstance(mod, layers.Conv1x1):
            total[0] += 2 * x.numel() * mod.out_channels
        elif isinstance(mod, torch.nn.ConvTranspose2d):
            total[0] += 2 * x.numel() * mod.out_channels * mod.kernel_size[0] ** 2
        else:
            total[0] += 2 * out.numel() * mod.in_channels * mod.kernel_size[0] ** 2

    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    with torch.inference_mode():
        module(torch.zeros(b, t, h, w, 3))
    for hd in handles:
        hd.remove()
    vit, n, f = cfg.vit, (h // 14) * (w // 14) + 1, cfg.features
    ph, pw, grid = h // 14, w // 14, vit.pos_grid
    flops = total[0]
    flops += 2 * b * t * ph * pw * 3 * 14 * 14 * vit.embed_dim  # patch embedding
    flops += 2 * b * t * h * w * 32 * (f // 2) * 9 + 2 * b * t * h * w * 32  # the tail
    flops += vit.depth * 4 * b * t * n * n * vit.embed_dim  # q·k and p·v per block
    oc = cfg.out_channels
    for mh, mw, c in ((ph, pw, oc[2]), ((ph + 1) // 2, (pw + 1) // 2, oc[3]), (ph, pw, f),
                      (2 * ph, 2 * pw, f)):
        flops += 2 * 4 * b * mh * mw * t * t * c  # two attentions a motion module
    flops += 2 * ph * grid * grid * vit.embed_dim + 2 * pw * grid * ph * vit.embed_dim
    return flops


def test_flop_count_matches_analytic():
    cfg = get_model_config("vits")
    cfg = dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit, depth=2),
                              intermediate_layer_idx=(0, 1, 1, 1))
    module = VideoDepthAnything(cfg).eval()
    b, t, h, w = 1, 3, 28, 42
    got = profiling.compiled_cost(module, torch.zeros(b, t, h, w, 3))
    assert got["gflops"] * 1e9 == pytest.approx(_analytic_flops(module, cfg, b, t, h, w), rel=1e-12)
    assert got["peak_mb"] is None and got["gbytes_accessed"] > 0


def test_bytes_count_inputs_and_outputs_views_none():
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    got = profiling.compiled_cost(lambda x, y: (x.t().t() @ y).reshape(-1), a, b)
    assert got["gflops"] * 1e9 == 2 * 8 * 16 * 4
    assert got["gbytes_accessed"] * 1e9 == (8 * 16 + 16 * 4 + 8 * 4) * 4


def test_time_fn_and_trace(tmp_path):
    calls = []
    r = profiling.time_fn(lambda: calls.append(1), iters=3, warmup=1)
    assert len(calls) == 4 and r["iters"] == 3 and 0 <= r["min_s"] <= r["median_s"]
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(4) @ torch.ones(4)
    assert json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    with profiling.trace(None) as prof:
        assert prof is None


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) else None for k, v in d.items()}


def test_profile_model_prints_jax_keys(tmp_path, monkeypatch):
    """``profile_model --device cpu`` at 2×28²: JAX's keys, the counts of the
    port's own module, a trace; JAX's CLI run at the same size (its timings
    on the CPU; its ``compiled_cost`` keys stubbed)."""
    import profile_model as jax_cli

    from video_depth_anything_torch import profile_model

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert profile_model.main(["--device", "cpu", "--frames", "2", "--size", "28",
                                   "--trace_dir", str(tmp_path)]) == 0
    got = json.loads(out.getvalue())
    # JAX's cost analysis compiles the window once more: its keys are stubbed
    monkeypatch.setattr("video_depth_anything_tpu.utils.profiling.compiled_cost",
                        lambda fn, *a: {"gflops": 0.0, "gbytes_accessed": 0.0, "peak_mb": 0.0})
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jax_cli.main(["--frames", "2", "--size", "28"]) == 0
    want = json.loads(out.getvalue())
    assert _keys(got) == _keys(want)
    for k in ("encoder_Mparams", "head_Mparams", "total_Mparams"):
        assert got[k] == pytest.approx(want[k], abs=1e-9)
    assert got["compiled"]["gflops"] > 0 and got["frames_per_s"] > 0
    assert (tmp_path / "trace.json").exists()
    assert np.isfinite(got["timings"]["head_derived_s"])
