"""RMSNorm: the hand-written CUDA kernel (``csrc/rms_norm.cu``) for tensors
on the card, its plain PyTorch twin for tensors on the CPU. fp32 math, output
in x's dtype, w cast to fp32 inside. Differentiable: the backward is autograd
through the plain twin on the saved x and w, as the JAX package's custom VJP
differentiates its plain version (it has no backward kernel either)."""

from __future__ import annotations

import torch

from tony_tpu_torch import kernels

# Kernel launches made by _rms_norm_cuda (read by chip_smoke.py to show the
# serving path went through the kernel).
launches = 0


def _rms_norm_plain(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def _rms_norm_cuda(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch the kernel on x [rows, d], w [d] (float32 or bfloat16 each,
    contiguous, 16-byte aligned, d a multiple of 16 bytes' worth of x)."""
    global launches
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"rms_norm kernel needs x and w on one CUDA device, "
                         f"got {x.device} and {w.device}")
    if x.dim() != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"rms_norm kernel takes x [rows, d] and w [d], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    x_code, w_code = kernels.dtype_code(x), kernels.dtype_code(w)
    rows, d = x.shape
    vec = 16 // x.element_size()
    if d % vec or not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"rms_norm kernel needs contiguous x, w and d a "
                         f"multiple of {vec}, got d={d}")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("rms_norm kernel needs 16-byte aligned x and w")
    y = torch.empty_like(x)
    if rows == 0:
        return y
    err = kernels.function("rms_norm")(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, d, float(eps),
        x_code, w_code, torch.cuda.current_stream(x.device).cuda_stream,
    )
    kernels.check_launch("rms_norm", err)
    launches += 1
    return y


class _RmsNormFunction(torch.autograd.Function):
    """y = rms_norm(x [rows, d], w [d]): B4 on the card, the plain twin on
    the CPU; the gradients of x and w come out in their own dtypes (an fp32
    master w under a bf16 x gets an fp32 gradient)."""

    @staticmethod
    def forward(ctx, x, w, eps):
        if x.device.type == "cuda":
            y = _rms_norm_cuda(x.contiguous(), w.contiguous(), eps)
        else:
            y = _rms_norm_plain(x, w, eps)
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with torch.enable_grad():
            x = x.detach().requires_grad_()
            w = w.detach().requires_grad_()
            y = _rms_norm_plain(x, w, ctx.eps)
            gx, gw = torch.autograd.grad(y, (x, w), g)
        return gx, gw, None


def rms_norm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis. x: [..., d], w: [d]."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"rms_norm runs on cuda or cpu, got {x.device}")
    shape = x.shape
    out = _RmsNormFunction.apply(x.reshape(-1, shape[-1]), w, eps)
    return out.reshape(shape)
