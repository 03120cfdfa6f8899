"""Fused RMSNorm, forward and backward (port of
``megatron_llm_tpu/ops/pallas/rmsnorm.py``).

:func:`fused_rms_norm` normalises over the last axis of any leading shape
and runs a ``torch.autograd.Function`` that saves ``(x, w)`` and
recomputes ``r`` in the backward, as the JAX ``custom_vjp`` does.  On CUDA
tensors it launches the hand-written kernels (``ops/kernels/csrc/
rmsnorm.cu``: K7 forward, K8 backward) or raises; on CPU tensors it runs
the plain versions below, which write the Pallas bodies' fp32 arithmetic
in PyTorch:

    r  = rsqrt(mean(x^2) + eps)
    y  = x * r * w
    dx = r * (g*w) - x * r^3 * mean(x * g*w)
    dw = sum over rows of g * x * r

y and dx are in x's type, dw in w's; x and w may differ in type (bf16
activations with an fp32 weight).  The JAX function's ``block_rows`` and
``interpret`` are the TPU's tiling and its CPU mode and have no
counterpart here.

The model does not call this module: its norms are the eager
``ops/norms.py``, as the JAX model's are plain jnp.
"""

from __future__ import annotations

import torch

from megatron_llm_tpu_torch.ops import kernels


def _rsqrt_mean_sq(xf: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)


def rms_norm_fwd_plain(x: torch.Tensor, w: torch.Tensor,
                       eps: float = 1e-6) -> torch.Tensor:
    """Plain version of K7: ``y`` in x's type, fp32 math."""
    xf = x.float()
    r = _rsqrt_mean_sq(xf, eps)
    return (xf * r * w.float()).to(x.dtype)


def rms_norm_bwd_plain(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                       eps: float = 1e-6):
    """Plain version of K8: ``(dx in x's type, dw in w's type)``, fp32 math,
    dw summed over every leading position."""
    xf, gf = x.float(), g.float()
    r = _rsqrt_mean_sq(xf, eps)
    gw = gf * w.float()
    mean_xgw = (xf * gw).mean(dim=-1, keepdim=True)
    dx = r * gw - xf * r ** 3 * mean_xgw
    dw = (gf * xf * r).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as contiguous ``[rows, h]``."""
    return t.reshape(-1, t.shape[-1]).contiguous()


def rms_norm_fwd(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """K7 on CUDA tensors, its plain version on CPU tensors.  A contiguous
    ``[rows, h]`` x goes to the kernel as it is: no view is made on the
    way (host time a launch)."""
    if x.is_cuda:
        if x.dim() == 2 and x.is_contiguous() and w.is_contiguous():
            return kernels.rms_norm_fwd_kernel(x, w, eps)
        return kernels.rms_norm_fwd_kernel(_rows(x), w.contiguous(),
                                           eps).reshape(x.shape)
    return rms_norm_fwd_plain(x, w, eps)


def rms_norm_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                 eps: float):
    """``(dx, dw)``: K8 on CUDA tensors, its plain version on CPU tensors."""
    if x.device.type == "cuda":
        dx, dw = kernels.rms_norm_bwd_kernel(_rows(x), w.contiguous(),
                                             _rows(g), eps)
        return dx.reshape(x.shape), dw
    return rms_norm_bwd_plain(x, w, g, eps)


class FusedRMSNormFunction(torch.autograd.Function):
    """K7 forward; K8 backward from the saved ``(x, w)``."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rms_norm_fwd(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, w, g, ctx.eps)
        return dx, dw, None


def fused_rms_norm(x: torch.Tensor, w: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis of ``x`` (any leading shape) with weight
    ``w [h]``; returns x's shape and type."""
    if w.dim() != 1 or w.shape[0] != x.shape[-1]:
        raise ValueError(f"w must be [{x.shape[-1]}], got {tuple(w.shape)}")
    return FusedRMSNormFunction.apply(x, w, float(eps))
