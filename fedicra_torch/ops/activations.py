"""Softmax, log-softmax and sigmoid, in bf16 written as JAX computes them.

In fp32 these are ``torch.softmax``, ``torch.log_softmax`` and
``torch.sigmoid``. In bf16 (under AMP) every step rounds to bf16 as JAX's
does on the CPU, forward and backward, where torch's fused kernels would
round once:

- softmax: y = exp(x - max) / sum(exp(x - max)); its gradient is JAX's
  custom JVP transposed, y * (g + sum(y * -g));
- log-softmax: (x - max) - log(sum(exp(x - max))), max without gradient;
  autograd of these ops is the transpose JAX takes;
- sigmoid: 1 / (1 + exp(-x)), XLA's expansion of ``logistic``; its
  gradient g * (y * (1 - y)).
"""

from __future__ import annotations

import torch


class _Softmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        u = torch.exp(x - x.amax(dim, keepdim=True))
        y = u / u.sum(dim, keepdim=True)
        ctx.save_for_backward(y)
        ctx.dim = dim
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return y * (g + (y * -g).sum(ctx.dim, keepdim=True)), None


class _Sigmoid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * (1 - y))


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    if x.dtype != torch.bfloat16:
        return torch.softmax(x, dim=dim)
    return _Softmax.apply(x, dim)


def log_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    if x.dtype != torch.bfloat16:
        return torch.log_softmax(x, dim=dim)
    shifted = x - x.amax(dim, keepdim=True).detach()
    return shifted - torch.log(torch.exp(shifted).sum(dim, keepdim=True))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.bfloat16:
        return torch.sigmoid(x)
    return _Sigmoid.apply(x)
