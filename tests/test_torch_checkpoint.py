"""Weights carried across: noised JAX params → ``from_jax_params`` →
``load_state_dict(strict=True)`` for every encoder, and the ``.pth`` path."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import configs, jax_param_shapes, noised_params
from video_depth_anything_torch.io.checkpoint import from_jax_params, load_pth
from video_depth_anything_torch.models.vda import VDAModel
from video_depth_anything_tpu.io.checkpoint import convert_torch_state_dict
from video_depth_anything_tpu.models.vda import VideoDepthAnything as JaxModule
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@functools.lru_cache(maxsize=None)
def _converted(encoder, depth=2):
    jc, tc = configs(encoder, depth)
    params = noised_params(
        jax_param_shapes(JaxModule(jc), jnp.zeros((1, 2, 28, 28, 3), jnp.float32)), seed=1)
    return jc, tc, params, from_jax_params(params, jc)


@pytest.mark.parametrize("encoder", ["vits", "vitb", "vitl", "vitg"])
def test_strict_load_every_encoder(encoder):
    jc, tc, params, state = _converted(encoder)
    model = VDAModel(cfg=tc, device="cpu", dtype=torch.float32)
    model.load_state_dict(state, strict=True)
    if encoder == "vits":  # the JAX importer reads the same dict back to the same tree
        back = convert_torch_state_dict(state, jc)
        np.testing.assert_array_equal(back["head"]["motion_3"]["proj_out"]["kernel"],
                                      params["head"]["motion_3"]["proj_out"]["kernel"])
    np.testing.assert_array_equal(
        model.module.state_dict()["pretrained.blocks.1.attn.qkv.weight"].numpy(),
        np.asarray(params["pretrained"]["block_1"]["attn"]["qkv"]["kernel"]).T)


def test_strict_load_rejects_missing_and_extra_keys():
    _, tc, _, state = _converted("vits")
    state = dict(state)
    model = VDAModel(cfg=tc, device="cpu", dtype=torch.float32)
    with pytest.raises(RuntimeError):
        model.load_state_dict({**state, "bogus.key": np.zeros(3, np.float32)})
    state.pop("head.scratch.output_conv1.bias")
    with pytest.raises(RuntimeError):
        model.load_state_dict(state)


def test_pth_round_trip(tmp_path):
    _, tc, _, state = _converted("vits")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in state.items()}},
               tmp_path / "ckpt.pth")
    model = VDAModel(cfg=tc, device="cpu", dtype=torch.float32)
    model.load_state_dict(load_pth(str(tmp_path / "ckpt.pth")), strict=True)
    torch.testing.assert_close(model.module.state_dict()["pretrained.pos_embed"],
                               torch.from_numpy(state["pretrained.pos_embed"]))
