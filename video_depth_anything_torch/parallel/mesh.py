"""The rank grid and Megatron tensor parallelism (the JAX package's
``parallel/mesh.py``).

The world is laid out as ``data × model``: consecutive ranks form a
``model`` group, as ``create_mesh``'s ``reshape(data, model)`` lays out the
JAX mesh.  A ``model`` group runs one window with the encoder split over its
ranks; the ``data`` groups (ranks of one model index) take the windows'
spans, the gradient sums and ZeRO-1's shards.

``TP_RULES`` are the JAX rules over the port's state-dict names, each with
the dimension it shards of the torch ``(out, in)`` weight (JAX's
``PS(None, 'model')`` on an ``(in, out)`` kernel is dim 0 here):
``attn.qkv`` and ``mlp.fc1`` column-parallel, ``attn.proj`` and
``mlp.fc2`` row-parallel, with one all-reduce after each row-parallel
product and its bias added once, after the reduce.  ``shard_module``
swaps each matched ``Linear`` for its shard in place.  Heads split by
whole heads, unevenly where the rank count does not divide them (vits' 6
heads on 4 ranks: 2, 2, 1, 1), and each rank takes its heads' rows from
each of q, k and v of the fused qkv weight; hidden features split in
contiguous blocks.

The motion modules' feed-forwards stay whole on every rank: JAX's last
three ``TP_RULES`` entries (``JAX_MOTION_FF_RULES``) have no port rule.
Kernel C (``ops/motion_module.py``) reads a whole module's weights, its
feed-forward included, in one launch, and its gate depends on each call's
shape (h·w ≥ 2048), so no placement made once knows which modules take it;
on the TPU GSPMD cannot split a Pallas call either and runs it on gathered
weights.  The result is the same numerically.  SwiGLU (``w12``/``w3``,
vitg) matches no rule, in JAX either, and stays replicated.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from video_depth_anything_torch.parallel import comm

TP_RULES: Sequence[Tuple[str, int]] = (
    (r"pretrained\.blocks\.\d+\.attn\.qkv\.weight", 0),
    (r"pretrained\.blocks\.\d+\.attn\.qkv\.bias", 0),
    (r"pretrained\.blocks\.\d+\.attn\.proj\.weight", 1),
    (r"pretrained\.blocks\.\d+\.mlp\.fc1\.weight", 0),
    (r"pretrained\.blocks\.\d+\.mlp\.fc1\.bias", 0),
    (r"pretrained\.blocks\.\d+\.mlp\.fc2\.weight", 1),
)
# The JAX TP_RULES entries that the port leaves whole (module docstring).
JAX_MOTION_FF_RULES = (
    r"head/motion_\d+/block_\d+/ff/proj/kernel",
    r"head/motion_\d+/block_\d+/ff/proj/bias",
    r"head/motion_\d+/block_\d+/ff/out/kernel",
)


def rule_dim(name: str, rules: Sequence[Tuple[str, int]] = TP_RULES) -> Optional[int]:
    """The dimension the first matching rule shards, ``None`` when no rule
    matches (replicated)."""
    for pat, dim in rules:
        if re.search(pat, name):
            return dim
    return None


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in the ``data × model`` grid and its two groups."""

    data: int
    model: int
    data_index: int
    model_index: int
    model_group: comm.Group  # the ranks of this data index (consecutive)
    data_group: comm.Group  # the ranks of this model index


_GRIDS: Dict[tuple, tuple] = {}


def create_grid(data: Optional[int] = None, model: int = 1) -> Grid:
    """The grid over the started world; ``data`` defaults to
    ``world_size // model``.  Every rank must call it; a second call for
    the same layout of the same world returns the first grid (its groups
    are made once)."""
    w = comm.world()
    if data is None:
        data = w.size // model
    if data * model != w.size:
        raise ValueError(f"grid {data}x{model} != {w.size} ranks")
    seen = _GRIDS.get((data, model))
    if seen is not None and seen[0] is w:
        return seen[1]
    ranks = np.arange(w.size).reshape(data, model)
    model_groups = [comm.new_group(ranks[d]) for d in range(data)]
    data_groups = [comm.new_group(ranks[:, m]) for m in range(model)]
    d, m = divmod(w.rank, model)
    grid = Grid(data, model, d, m, model_groups[d], data_groups[m])
    _GRIDS[(data, model)] = (w, grid)
    return grid


# -- shards ----------------------------------------------------------------------


def head_split(num_heads: int, n: int, i: int) -> np.ndarray:
    """Rank ``i``'s heads of ``num_heads`` over ``n`` ranks: whole heads,
    the first ranks one more where ``n`` does not divide them."""
    if n > num_heads:
        raise ValueError(f"{num_heads} heads cannot split over {n} ranks")
    return np.array_split(np.arange(num_heads), n)[i]


def block_split(size: int, n: int, i: int) -> np.ndarray:
    """Rank ``i``'s contiguous block of ``size`` features over ``n`` ranks."""
    return np.array_split(np.arange(size), n)[i]


def head_cols(heads: np.ndarray, head_dim: int) -> np.ndarray:
    """The features of ``heads`` in a ``dim``-wide attention output."""
    return (heads[:, None] * head_dim + np.arange(head_dim)).reshape(-1)


def qkv_rows(heads: np.ndarray, head_dim: int, dim: int) -> np.ndarray:
    """The rows of the fused ``(3·dim, dim)`` qkv weight that ``heads`` own:
    their rows of q, then of k, then of v (``[q; k; v]`` order kept)."""
    cols = head_cols(heads, head_dim)
    return np.concatenate([p * dim + cols for p in range(3)])


class ParallelLinear(nn.Module):
    """A ``Linear`` shard: ``dim`` 0 (column-parallel: this rank's output
    features) or 1 (row-parallel: its input features, the products summed
    over ``group`` and the whole bias added once after the sum).
    ``indices[j]`` are rank j's features of the ``full`` ones and
    ``index`` this rank's.  Its state-dict names are a ``Linear``'s."""

    def __init__(self, linear: nn.Linear, dim: int, indices, group: comm.Group):
        super().__init__()
        self.dim, self.group = dim, group
        self.full = linear.weight.shape[dim]
        self.indices = [torch.as_tensor(ix, dtype=torch.long) for ix in indices]
        self.index = self.indices[group.index]
        idx = self.index.to(linear.weight.device)
        with torch.no_grad():
            self.weight = nn.Parameter(linear.weight.index_select(dim, idx).clone())
            bias = linear.bias
            self.bias = nn.Parameter(bias.index_select(0, idx).clone() if dim == 0 else
                                     bias.detach().clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dim == 0:
            x = comm.copy_to_group(x, self.group)
            return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))
        y = comm.reduce_from_group(F.linear(x, self.weight.to(x.dtype)), self.group)
        return y + self.bias.to(y.dtype)


def shard_module(module: nn.Module, grid: Grid) -> nn.Module:
    """Apply ``TP_RULES`` to a ``VideoDepthAnything`` in place over
    ``grid.model_group``: each encoder block's qkv / proj / fc1 / fc2
    become ``ParallelLinear`` shards on their rule's dimension and its
    attention's local head count is set.  Idempotent for one grid; a
    no-op for a model group of one."""
    if grid.model == 1:
        return module
    done = getattr(module, "_tp_grid", None)
    if done is not None:
        if done is not grid:
            raise ValueError("the module is already sharded over another grid")
        return module
    n, i, group = grid.model, grid.model_index, grid.model_group

    def split(parent, name: str, prefix: str, indices) -> None:
        dim = rule_dim(f"{prefix}.{name}.weight")
        setattr(parent, name, ParallelLinear(getattr(parent, name), dim, indices, group))

    for b, blk in enumerate(module.pretrained.blocks):
        prefix, attn = f"pretrained.blocks.{b}", blk.attn
        dim, hd = attn.qkv.weight.shape[1], attn.head_dim
        heads = [head_split(attn.num_heads, n, j) for j in range(n)]
        split(attn, "qkv", f"{prefix}.attn", [qkv_rows(h, hd, dim) for h in heads])
        split(attn, "proj", f"{prefix}.attn", [head_cols(h, hd) for h in heads])
        attn.num_heads = len(heads[i])
        if hasattr(blk.mlp, "fc1"):
            hidden = [block_split(blk.mlp.fc1.weight.shape[0], n, j) for j in range(n)]
            split(blk.mlp, "fc1", f"{prefix}.mlp", hidden)
            split(blk.mlp, "fc2", f"{prefix}.mlp", hidden)
    module._tp_grid = grid
    return module


def shards(module: nn.Module) -> Dict[str, ParallelLinear]:
    """State-dict name → the ``ParallelLinear`` holding it, for every
    sharded tensor of ``module`` (the row-parallel biases are whole)."""
    out = {}
    for prefix, sub in module.named_modules():
        if isinstance(sub, ParallelLinear):
            out[f"{prefix}.weight"] = sub
            if sub.dim == 0:
                out[f"{prefix}.bias"] = sub
    return out


def full_tensor(shard: ParallelLinear, local: torch.Tensor) -> torch.Tensor:
    """The whole tensor of which ``local`` is this rank's shard (a weight,
    a bias of a column-parallel shard, or their optimizer moments), gathered
    over the model group.  Every rank of the group must call it."""
    dim = shard.dim if local.dim() > 1 else 0
    moved = local.movedim(dim, 0).contiguous()
    pieces = comm.all_gather_padded(moved, shard.group)
    full = torch.empty((shard.full,) + tuple(moved.shape[1:]), dtype=local.dtype,
                       device=local.device)
    for ix, piece in zip(shard.indices, pieces):
        full[ix.to(full.device)] = piece
    return full.movedim(0, dim)


def local_tensor(shard: ParallelLinear, full: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a whole tensor (``full_tensor``'s inverse)."""
    dim = shard.dim if full.dim() > 1 else 0
    return full.index_select(dim, shard.index.to(full.device)).contiguous()


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` with every shard gathered whole (the
    reference-keyed layout that ``load_state_dict`` of an unsharded module
    takes).  Every rank of the model group must call it."""
    sh = shards(module)
    return {k: full_tensor(sh[k], v) if k in sh else v for k, v in module.state_dict().items()}


def local_state_dict(module: nn.Module, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A whole state dict cut to the shards ``module`` holds."""
    sh = shards(module)
    return {k: local_tensor(sh[k], torch.as_tensor(v)) if k in sh else v
            for k, v in state.items()}
