"""Fused matmul + batch-norm statistics: the plain PyTorch version and a
hand-written Hopper kernel.

Port of ``tf_operator_tpu/ops/fused_linear_stats.py``. ResNet's
bottleneck (``models/resnet.py::_bottleneck_fused``) runs its 1x1
convolutions through it as ``[b*h*w, cin] @ [cin, cout]`` matrices, so the
batch-norm statistics of each output come from the product's epilogue
instead of another pass over it.

- ``fused_linear_stats(x, w, prologue=None)``: the public entry, JAX's
  signature and returns. ``y = (relu(x*a + b) if prologue else x) @ w``
  in x's dtype, and per column the sum and the sum of squares (f32) of the
  f32 product, before rounding. Differentiable through a
  ``torch.autograd.Function`` whose backward is ``_fused_bwd``'s: the
  statistics' cotangents fold into ``dy_eff = dy + dsum + 2*y*dssq``, then
  plain products, as JAX computes them outside any Pallas kernel. On the
  card, with bf16 x, those products take bf16 operands with f32
  accumulation (what the TPU's default-precision f32 matmul does); f32 x
  and the CPU keep them in f32.
- ``_reference``: the plain version (the same math as JAX's ``_reference``).
- ``fused_linear_stats_kernel``: K8 (``csrc/fused_linear_stats.cu``, for
  the TPU's ``_kernel``), and a second kernel that sums its blocks'
  partial rows of statistics.

Dispatch is by the tensors' device, never by a fallback: CPU tensors go to
the plain version; CUDA tensors go to the kernel or the call raises.
``fused_linear_stats_launches`` counts the kernel's launches. The JAX
package's block sizes and ``interpret`` have no counterpart.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

# Kernel limits (keep in step with csrc/fused_linear_stats.cu): 128-row
# output tiles (at most two partial rows of statistics each); 16-byte rows
# of x, w and y.
FLS_TILE_M = 128
FLS_DTYPES = (torch.bfloat16, torch.float32)

fused_linear_stats_launches = 0  # launches of the CUDA kernel in this process

_fns: dict = {}


def _reference(x, w, a, b, relu_in: bool):
    """Plain version: the product in f32 (x relu(x*a + b)-transformed in f32
    with the prologue), y cast to x's dtype, and the column sum and sum of
    squares of the f32 product."""
    xin = x.float()
    if relu_in:
        xin = torch.relu(xin * a.float() + b.float())
    y32 = xin @ w.float()
    return y32.to(x.dtype), y32.sum(dim=0), (y32 * y32).sum(dim=0)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------


def check_kernel_args(x, w, a, b) -> Tuple[int, int, int]:
    """Raise on anything K8 does not take; returns (M, K, N). x [M, K] and
    w [K, N] contiguous, 16-byte aligned, bf16 or f32 of one dtype, K and N
    multiples of 8; a and b (both or neither) contiguous, 16-byte aligned
    f32 [K]; all on one CUDA device."""
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"fused_linear_stats kernel: x [M, K] and w [K, N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    M, K = x.shape
    if w.shape[0] != K:
        raise ValueError(f"contraction mismatch: x k={K} vs w {tuple(w.shape)}")
    N = w.shape[1]
    if x.dtype not in FLS_DTYPES:
        raise TypeError(f"fused_linear_stats kernel: x must be bfloat16 or float32, got {x.dtype}")
    if w.dtype != x.dtype:
        raise TypeError(f"fused_linear_stats kernel: x is {x.dtype}, w is {w.dtype}")
    if K % 8 or N % 8:
        raise ValueError(f"fused_linear_stats kernel: K {K} and N {N} must be multiples of 8 "
                         "(16-byte rows)")
    named = [(x, "x"), (w, "w")]
    if (a is None) != (b is None):
        raise ValueError("fused_linear_stats kernel: the prologue needs both a and b")
    if a is not None:
        for t, what in ((a, "a"), (b, "b")):
            if t.dtype != torch.float32 or tuple(t.shape) != (K,):
                raise ValueError(f"fused_linear_stats kernel: {what} must be float32 [{K}], got "
                                 f"{t.dtype} {tuple(t.shape)}")
            named.append((t, what))
    for t, what in named:
        if not t.is_contiguous():
            raise ValueError(f"fused_linear_stats kernel: {what} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"fused_linear_stats kernel: {what} must be 16-byte aligned")
    if len({t.device for t, _ in named}) != 1:
        raise ValueError("fused_linear_stats kernel: tensors on several devices")
    if x.device.type != "cuda":
        raise ValueError(f"fused_linear_stats kernel needs CUDA tensors, got {x.device}")
    return M, K, N


# C entry -> argument types: every pointer and the stream as c_void_p (an
# undeclared argument passes as a 32-bit int and cuts the pointer).
_P, _I = ctypes.c_void_p, ctypes.c_int
FLS_ENTRY = "fused_linear_stats"
FLS_ARGTYPES = [_P] * 7 + [_I] * 5 + [_P]  # x w a b y part stats; M K N relu bf16; stream


def bind_fls_entry(lib: ctypes.CDLL):
    """The typed C entry of a loaded fused_linear_stats library."""
    fn = getattr(lib, FLS_ENTRY)
    fn.argtypes = FLS_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _fls_fn():
    fn = _fns.get(FLS_ENTRY)
    if fn is None:
        from tf_operator_tpu_torch.ops import _build

        fn = _fns[FLS_ENTRY] = bind_fls_entry(_build.load("fused_linear_stats"))
    return fn


def fused_linear_stats_kernel(x, w, a=None, b=None):
    """Launch K8 on CUDA tensors (raises on anything else): (y [M, N] in x's
    dtype, sum [N] f32, ssq [N] f32), the prologue relu(x*a + b) applied
    when a and b are given. Same contract as _reference."""
    global fused_linear_stats_launches
    M, K, N = check_kernel_args(x, w, a, b)
    y = torch.empty(M, N, dtype=x.dtype, device=x.device)
    if M == 0:
        zeros = torch.zeros(N, dtype=torch.float32, device=x.device)
        return y, zeros, zeros.clone()
    part = torch.empty(2, 2 * -(-M // FLS_TILE_M), N, dtype=torch.float32, device=x.device)
    stats = torch.empty(2, N, dtype=torch.float32, device=x.device)
    relu = a is not None
    with torch.cuda.device(x.device):
        err = _fls_fn()(x.data_ptr(), w.data_ptr(), a.data_ptr() if relu else None,
                        b.data_ptr() if relu else None, y.data_ptr(), part.data_ptr(),
                        stats.data_ptr(), M, K, N, int(relu), int(x.dtype == torch.bfloat16),
                        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_linear_stats kernel launch failed: cudaError_t {err}")
    fused_linear_stats_launches += 1
    return y, stats[0], stats[1]


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------


def _fwd(x, w, a, b):
    if x.device.type == "cpu":
        return _reference(x, w, a, b, a is not None)
    return fused_linear_stats_kernel(x, w, a, b)


def _dot(p, q, dtype):
    """p @ q with an f32 result: bf16 operands on the card when x is bf16
    (f32 accumulation), f32 otherwise."""
    if p.is_cuda and dtype == torch.bfloat16:
        return torch.mm(p.to(dtype), q.to(dtype), out_dtype=torch.float32)
    return p.float() @ q.float()


class _FusedLinearStats(torch.autograd.Function):
    """(y, sum, ssq) = fused_linear_stats(x, w, (a, b)); a, b None without
    the prologue. Backward: _fused_bwd's."""

    @staticmethod
    def forward(ctx, x, w, a, b):
        y, s, q = _fwd(x, w, a, b)
        ctx.save_for_backward(x, w, a, b, y)
        return y, s, q

    @staticmethod
    def backward(ctx, dy, dsum, dssq):
        x, w, a, b, y = ctx.saved_tensors
        # sum and ssq are row reductions of y: d sum/dy = 1, d ssq/dy = 2y
        dy_eff = dy.to(torch.float32, copy=True).add_(dsum).addcmul_(y.float(), dssq, value=2.0)
        xin, pre = x.float(), None
        if a is not None:
            pre = xin * a.float() + b.float()
            xin = torch.relu(pre)
        dx = dw = da = db = None
        if ctx.needs_input_grad[1]:
            dw = _dot(xin.t(), dy_eff, x.dtype).to(w.dtype)
        if any(ctx.needs_input_grad[i] for i in (0, 2, 3)):
            dxin = _dot(dy_eff, w.t(), x.dtype)
            if pre is None:
                dx = dxin.to(x.dtype)
            else:
                dpre = dxin * (pre > 0)
                dx = (dpre * a.float()).to(x.dtype)
                da = (dpre * x.float()).sum(dim=0).to(a.dtype)
                db = dpre.sum(dim=0).to(b.dtype)
        return dx, dw, da, db


def fused_linear_stats(
    x: torch.Tensor,
    w: torch.Tensor,
    prologue: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """y = (relu(x*a + b) if prologue else x) @ w, plus the per-column sum
    and sum of squares of the f32 product.

    x [M, K]; w [K, N]; prologue: optional (a [K], b [K]), the previous
    layer's folded BN affine, applied with ReLU while loading x. Returns
    (y [M, N] in x's dtype, sum [N] f32, ssq [N] f32). Differentiable in x,
    w, a and b.

    CPU tensors run the plain version; CUDA tensors run the kernel or
    raise — there is no fallback."""
    if x.ndim != 2 or w.ndim != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"fused_linear_stats: x [M, K] and w [K, N], got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    a, b = (None, None) if prologue is None else prologue
    return _FusedLinearStats.apply(x, w, a, b)
