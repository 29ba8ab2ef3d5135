"""NHWC layers whose parameters keep the reference torch names and layouts.

Activations stay channels-last, as in the JAX package; the layers keep
fp32 parameters and compute in the activation's dtype (parameters cast at
use), as the JAX ``DTypeDense``/``Conv2d`` do.  Norms take fp32 statistics
and apply the affine in fp32 before casting back.  The JAX package's 2×2
space-to-depth output stack is a TPU layout trick with the same result as
the plain layout used here.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def _cast(p, dtype):
    return None if p is None else p.to(dtype)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class Conv2d(nn.Conv2d):
    """Conv over ``(N, H, W, C)``; weight OIHW as in the reference."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), _cast(self.bias, x.dtype),
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class Conv1x1(nn.Conv2d):
    """1×1 conv over ``(..., C)`` as one GEMM (the JAX package's Dense)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight[:, :, 0, 0].to(x.dtype), _cast(self.bias, x.dtype))


class ConvTranspose2d(nn.ConvTranspose2d):
    """Kernel == stride, padding 0 transposed conv over ``(N, H, W, C)``;
    weight ``(in, out, k, k)`` as in the reference."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype),
                               _cast(self.bias, x.dtype), self.stride)
        return y.permute(0, 2, 3, 1)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with fp32 statistics (mean and E[x²] − mean²) and affine."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """GroupNorm over the channel axis of ``(..., H, W, C)``: statistics per
    leading index over (H·W × group channels), in fp32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c, g = x.shape[-1], self.num_groups
        lead = x.shape[:-3]
        xf = x.float().reshape(lead + (-1, g, c // g))
        var, mean = torch.var_mean(xf, dim=(-3, -1), keepdim=True, unbiased=False)
        xf = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return (xf * self.weight + self.bias).to(x.dtype)
