"""Shared helpers of the ``test_torch_*`` files: matching small configs of
both packages, seeded noised JAX parameters, their conversion into the
PyTorch port, and the softmax-chain probe's Pallas kernel."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_depth_anything_torch import config as tcfg
from video_depth_anything_torch.io.checkpoint import from_jax_params
from video_depth_anything_torch.models.vda import VDAModel as TorchVDA
from video_depth_anything_tpu import config as jcfg
from video_depth_anything_tpu.models.vda import VDAModel as JaxVDA


def configs(encoder: str = "vits", depth: int = 4):
    """(jax_cfg, torch_cfg) at full widths with the encoder cut to ``depth``
    blocks, tapping blocks spread over that depth."""
    taps = tuple(int(round(i * (depth - 1) / 3)) for i in range(4))
    out = []
    for mod in (jcfg, tcfg):
        cfg = mod.get_model_config(encoder)
        cfg = dataclasses.replace(
            cfg, vit=dataclasses.replace(cfg.vit, depth=depth), intermediate_layer_idx=taps)
        out.append(cfg)
    return tuple(out)


def noised_params(params, seed: int):
    """Replace every leaf with seeded numpy noise: kernels ~ N(0, 1/fan_in),
    norm scales and LayerScale ~ 1 + N(0, 0.1²), everything else
    ~ N(0, 0.1²).  Without this, the zero-initialised proj_out would make
    every motion module the identity.  Leaves are cut from one 2²⁰-value
    pool at random offsets, so that the widest encoders stay cheap."""
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal(1 << 20, dtype=np.float32)

    def walk(tree, name=""):
        if isinstance(tree, dict) or hasattr(tree, "items"):
            return {k: walk(v, k) for k, v in tree.items()}
        shape = tuple(tree.shape)
        noise = np.resize(np.roll(pool, int(rng.integers(pool.size))), shape)
        if "kernel" in name:
            out = noise / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale" or name.endswith("gamma"):
            out = 1.0 + 0.1 * noise
        else:
            out = 0.1 * noise
        return out.astype(np.float32)

    return walk(params)


def jax_param_shapes(module, *example):
    """The param tree of a flax module as shapes, without compiling init."""
    return jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *example))["params"]


def model_pair(encoder: str = "vits", depth: int = 4, seed: int = 0):
    """A JAX ``VDAModel`` with noised fp32 params and the port's fp32 CPU
    ``VDAModel`` holding the same weights (strict load)."""
    jc, tc = configs(encoder, depth)
    jm = JaxVDA(cfg=jc, dtype=jnp.float32)
    dummy = jnp.zeros((1, 2, 28, 28, 3), jnp.float32)
    jm.params = noised_params(jax_param_shapes(jm.module, dummy), seed)
    tm = TorchVDA(cfg=tc, device="cpu", dtype=torch.float32)
    tm.load_state_dict(from_jax_params(jm.params, jc), strict=True)
    return jm, tm


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op thread for the module's tests.  The streaming pipelines
    run many tiny CPU ops; with several test workers on the machine,
    torch's default of one thread per core oversubscribes the cores and
    makes each op tens of times slower."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def chain_kern(mode, d):
    """The Pallas kernel ``kern`` of ``scripts/bench_softmax_chain.py:55-94``
    for ``mode`` and output width ``d``, transcribed: ``make_kernel`` is a
    closure inside the script's ``main``."""

    def kern(q_ref, k_ref, v_ref, o_ref):
        s = jax.lax.dot_general(
            q_ref[0], k_ref[0], (((1,), (1,)), ((), ())),
            preferred_element_type=(jnp.bfloat16 if mode in ("bf16s", "bf16x") else jnp.float32))
        if mode == "gemms":
            p = s
        elif mode == "exp":
            p = jnp.exp2(s)
        elif mode == "exact":
            m = jnp.max(s, axis=1, keepdims=True)
            p = jnp.exp(s - m)
        elif mode == "sexp":
            i = jnp.asarray(s * (1 << 23) + (127.0 * (1 << 23)), jnp.int32)
            p = jax.lax.bitcast_convert_type(i, jnp.float32)
        elif mode == "pexp":
            xi = jnp.floor(s)
            xf = s - xi
            i = (jnp.asarray(xi, jnp.int32) + 127) << 23
            scale = jax.lax.bitcast_convert_type(i, jnp.float32)
            pf = 1.0 + xf * (0.6951937 + xf * (0.2288332 + xf * 0.0779731))
            p = scale * pf
        elif mode == "bf16s":
            p = jnp.exp2(s)
        else:  # bf16x
            m = jnp.max(s, axis=1, keepdims=True)
            p = jnp.exp2(s - m)
        acc = jax.lax.dot_general(p.astype(v_ref.dtype), v_ref[0], (((1,), (0,)), ((), ())),
                                  preferred_element_type=jnp.float32)
        o_ref[0] = acc[:, :d].astype(o_ref.dtype)

    return kern
