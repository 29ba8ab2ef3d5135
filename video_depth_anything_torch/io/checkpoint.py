"""Weights into the port.

* ``from_jax_params(params, cfg)``: the JAX package's param tree (nested
  dicts of arrays) → the reference torch state dict (numpy), a copy of
  ``video_depth_anything_tpu/io/checkpoint.py:export_torch_state_dict``
  that needs no JAX.  The deterministic APE buffers are re-synthesized and
  ``mask_token`` is zero-filled, as there.
* ``load_pth(path)``: a released ``.pth`` state dict as tensors, for
  ``VDAModel.load_state_dict(..., strict=True)``; ``load_init_checkpoint``
  is the training CLI's ``--init_checkpoint``, which refuses the JAX
  package's orbax directories.
* ``save_pth(path, state_dict)``: a reference-keyed ``.pth`` (the training
  CLI's step checkpoints), which ``load_pth`` and the JAX package's
  ``load_torch_checkpoint`` both read.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from video_depth_anything_torch.config import ModelConfig, MotionModuleConfig
from video_depth_anything_torch.ops.motion_module import sinusoidal_position_table


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _linear(w) -> np.ndarray:
    return np.ascontiguousarray(_np(w).T)


def _conv_back(w) -> np.ndarray:  # HWIO -> OIHW
    return np.ascontiguousarray(_np(w).transpose(3, 2, 0, 1))


def from_jax_params(params, cfg: ModelConfig) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    p, d = cfg.vit.patch_size, cfg.vit.embed_dim
    pre = params["pretrained"]
    out["pretrained.patch_embed.proj.weight"] = np.ascontiguousarray(
        _np(pre["patch_kernel"]).reshape(p, p, 3, d).transpose(3, 2, 0, 1))
    out["pretrained.patch_embed.proj.bias"] = _np(pre["patch_bias"])
    out["pretrained.cls_token"] = _np(pre["cls_token"])
    out["pretrained.pos_embed"] = _np(pre["pos_embed"])
    out["pretrained.mask_token"] = np.zeros((1, d), np.float32)
    out["pretrained.norm.weight"] = _np(pre["norm"]["scale"])
    out["pretrained.norm.bias"] = _np(pre["norm"]["bias"])
    mlp_names = ("w12", "w3") if cfg.vit.ffn_layer == "swiglufused" else ("fc1", "fc2")
    for i in range(cfg.vit.depth):
        b = pre[f"block_{i}"]
        t = f"pretrained.blocks.{i}"
        for n in ("norm1", "norm2"):
            out[f"{t}.{n}.weight"] = _np(b[n]["scale"])
            out[f"{t}.{n}.bias"] = _np(b[n]["bias"])
        out[f"{t}.ls1.gamma"] = _np(b["ls1_gamma"])
        out[f"{t}.ls2.gamma"] = _np(b["ls2_gamma"])
        for n in ("qkv", "proj"):
            out[f"{t}.attn.{n}.weight"] = _linear(b["attn"][n]["kernel"])
            out[f"{t}.attn.{n}.bias"] = _np(b["attn"][n]["bias"])
        for n in mlp_names:
            out[f"{t}.mlp.{n}.weight"] = _linear(b["mlp"][n]["kernel"])
            out[f"{t}.mlp.{n}.bias"] = _np(b["mlp"][n]["bias"])

    head = params["head"]
    for i in range(4):
        out[f"head.projects.{i}.weight"] = _linear(head[f"project_{i}"]["kernel"])[:, :, None, None]
        out[f"head.projects.{i}.bias"] = _np(head[f"project_{i}"]["bias"])
    for i in (0, 1):  # (in, k, k, out) -> (in, out, k, k)
        out[f"head.resize_layers.{i}.weight"] = np.ascontiguousarray(
            _np(head[f"resize_{i}"]["kernel"]).transpose(0, 3, 1, 2))
        out[f"head.resize_layers.{i}.bias"] = _np(head[f"resize_{i}"]["bias"])
    out["head.resize_layers.3.weight"] = _conv_back(head["resize_3"]["kernel"])
    out["head.resize_layers.3.bias"] = _np(head["resize_3"]["bias"])
    for i in range(1, 5):
        out[f"head.scratch.layer{i}_rn.weight"] = _conv_back(head[f"layer{i}_rn"]["kernel"])
    for i in range(1, 5):
        r = head[f"refinenet{i}"]
        t = f"head.scratch.refinenet{i}"
        out[f"{t}.out_conv.weight"] = _conv_back(r["out_conv"]["kernel"])
        out[f"{t}.out_conv.bias"] = _np(r["out_conv"]["bias"])
        for rcu_t, rcu_j in (("resConfUnit1", "rcu1"), ("resConfUnit2", "rcu2")):
            # refinenet4 never takes a skip input, so the JAX tree has no
            # rcu1 there; the reference keys exist and are zero-filled
            # (dead at inference), like mask_token
            src = r.get(rcu_j) or {c: {k: np.zeros_like(_np(v)) for k, v in r["rcu2"][c].items()}
                                   for c in ("conv1", "conv2")}
            for c in ("conv1", "conv2"):
                out[f"{t}.{rcu_t}.{c}.weight"] = _conv_back(src[c]["kernel"])
                out[f"{t}.{rcu_t}.{c}.bias"] = _np(src[c]["bias"])
    for ours, theirs in (("output_conv1", "output_conv1"), ("output_conv2.0", "output_conv2_0"),
                         ("output_conv2.2", "output_conv2_2")):
        out[f"head.scratch.{ours}.weight"] = _conv_back(head[theirs]["kernel"])
        out[f"head.scratch.{ours}.bias"] = _np(head[theirs]["bias"])

    for j in range(4):
        for k, val in motion_module_state(head[f"motion_{j}"], cfg.motion).items():
            out[f"head.motion_modules.{j}.{k}"] = val
    return out


def motion_module_state(mm, mcfg: MotionModuleConfig) -> Dict[str, np.ndarray]:
    """One JAX ``TemporalModule`` param tree → the reference keys under
    ``temporal_transformer.``."""
    out: Dict[str, np.ndarray] = {}
    t = "temporal_transformer"
    out[f"{t}.norm.weight"] = _np(mm["norm"]["scale"])
    out[f"{t}.norm.bias"] = _np(mm["norm"]["bias"])
    for n in ("proj_in", "proj_out"):
        out[f"{t}.{n}.weight"] = _linear(mm[n]["kernel"])
        out[f"{t}.{n}.bias"] = _np(mm[n]["bias"])
    dim = np.asarray(mm["proj_in"]["kernel"]).shape[1]
    pe = sinusoidal_position_table(mcfg.temporal_max_len, dim)[None]
    for k in range(mcfg.num_transformer_blocks):
        blk = mm[f"block_{k}"]
        bt = f"{t}.transformer_blocks.{k}"
        out[f"{bt}.ff_norm.weight"] = _np(blk["ff_norm"]["scale"])
        out[f"{bt}.ff_norm.bias"] = _np(blk["ff_norm"]["bias"])
        out[f"{bt}.ff.net.0.proj.weight"] = _linear(blk["ff"]["proj"]["kernel"])
        out[f"{bt}.ff.net.0.proj.bias"] = _np(blk["ff"]["proj"]["bias"])
        out[f"{bt}.ff.net.2.weight"] = _linear(blk["ff"]["out"]["kernel"])
        out[f"{bt}.ff.net.2.bias"] = _np(blk["ff"]["out"]["bias"])
        for a in range(mcfg.num_attention_blocks):
            at = f"{bt}.attention_blocks.{a}"
            att = blk[f"attn_{a}"]
            out[f"{bt}.norms.{a}.weight"] = _np(blk[f"norm_{a}"]["scale"])
            out[f"{bt}.norms.{a}.bias"] = _np(blk[f"norm_{a}"]["bias"])
            for n in ("to_q", "to_k", "to_v"):
                out[f"{at}.{n}.weight"] = _linear(att[n]["kernel"])
            out[f"{at}.to_out.0.weight"] = _linear(att["to_out"]["kernel"])
            out[f"{at}.to_out.0.bias"] = _np(att["to_out"]["bias"])
            out[f"{at}.pos_encoder.pe"] = pe
    return out


def load_pth(path: str):
    """A ``.pth`` checkpoint's state dict (``state_dict`` entry unwrapped)."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.float() for k, v in sd.items()}


def load_init_checkpoint(path: str):
    """``load_pth`` for a ``.pth`` file; an orbax directory (the JAX
    package's native checkpoints) raises."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of the JAX package); convert it to a "
            "reference-keyed .pth first: torch.save of export_torch_state_dict(load_native(path), "
            "cfg), both in the JAX package's video_depth_anything_tpu.io.checkpoint")
    return load_pth(path)


def save_pth(path: str, state_dict) -> None:
    """Save a reference-keyed state dict as a ``.pth`` of CPU tensors."""
    import torch

    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)
