"""Grouped (block-diagonal) matmul for the MoE experts: plain PyTorch
versions and hand-written Hopper kernels.

Port of ``tf_operator_tpu/ops/grouped_matmul.py``. Rows arrive grouped by
expert and padded to a multiple of ``block_rows`` per expert; a
``block_expert`` map names each row block's expert, or -1 for a sentinel
block whose output rows are zeros and cost no product.

- ``gmm(x, w, block_expert, *, row_scale=None, block_rows=256)``: the
  public entry, differentiable through two ``torch.autograd.Function``s
  that mirror the JAX custom VJPs: dx is the forward kernel against the
  transposed expert weights, dw the accumulation kernel, and for the
  scaled form one unscaled transposed product ``t`` gives both
  ``dx = s * t`` and ``ds[r] = x[r] . t[r]``. dw is cast to ``w``'s dtype.
- Four kernels (``csrc/grouped_matmul.cu``), each with its plain version
  here: ``gmm_fwd`` for ``_gmm_fwd_kernel`` (K5; also the dx products),
  ``gmm_fwd_scaled`` for ``_gmm_fwd_scaled_kernel`` (K6, the f32 row-scale
  epilogue that carries the MoE combine's gate weights), ``gmm_dw`` for
  ``_dw_kernel`` (K7a) and ``gmm_dw_scaled`` for ``_dw_scaled_kernel``
  (K7b). The dx use reads ``w[e]`` in place as ``w[e]^T`` (no transposed
  copy of the weights, where the JAX rule swaps the axes first). The dw
  kernels stream x and dy through TMA into ``wgmma``; their C entries
  encode the tensor maps from the pointers and shapes given here.
- ``_expert_block_lists``: the dw walk's per-expert block lists, as torch
  ops on the tensors' device (no host sync).

Dispatch is by the tensors' device, never by a fallback: CPU tensors go
to the plain versions; CUDA tensors go to the kernels or the call raises.
``gmm_fwd_launches``, ``gmm_fwd_scaled_launches``, ``gmm_dw_launches`` and
``gmm_dw_scaled_launches`` count the kernels' launches. The JAX package's
``block_cols`` (a VMEM budget) and ``interpret`` have no counterpart.
"""

from __future__ import annotations

import ctypes

import torch

# Kernel limits (keep in step with csrc/grouped_matmul.cu): 128-row output
# tiles that must not straddle a routing block, and 16-byte loads of both
# operands' rows.
GMM_TILE_ROWS = 128
# The dw kernels' output tile: rows (x's columns) x columns (dy's); the
# most experts their item plan holds.
GMM_DW_TILE = (128, 256)
GMM_DW_MAX_EXPERTS = 1024
GMM_DTYPES = (torch.bfloat16, torch.float32)

# Launches of each CUDA kernel in this process.
gmm_fwd_launches = 0
gmm_fwd_scaled_launches = 0
gmm_dw_launches = 0
gmm_dw_scaled_launches = 0

_fns: dict = {}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def gmm_fwd_reference(x, w, block_expert, row_scale=None, *, block_rows: int,
                      trans_w: bool = False):
    """Plain version of K5 (``row_scale`` None) and K6: y [R, N] in x's dtype
    with y[r] = x[r] @ w[e] (``trans_w``: x[r] @ w[e]^T) for e the expert of
    row r's block, times row_scale[r], all in f32; sentinel blocks are
    zeros. w is [E, K, N] ([E, N, K] with ``trans_w``)."""
    R, K = x.shape
    nb = R // block_rows
    be = block_expert.long()
    wt = w.transpose(1, 2) if trans_w else w
    y = torch.bmm(x.float().reshape(nb, block_rows, K), wt[be.clamp(min=0)].float())
    y = torch.where((be >= 0)[:, None, None], y, 0.0)
    if row_scale is not None:
        y = y * row_scale.float().reshape(nb, block_rows, 1)
    return y.reshape(R, -1).to(x.dtype)


def gmm_dw_reference(x, dy, block_expert, n_experts: int, row_scale=None, *,
                     block_rows: int):
    """Plain version of K7a (``row_scale`` None) and K7b: dw [E, K, N] f32,
    dw[e] = sum over the blocks of e of (s * x_b)^T dy_b, s * x in f32;
    sentinel blocks belong to no expert, and an expert without blocks gets
    exact zeros."""
    R, K = x.shape
    N = dy.shape[1]
    nb = R // block_rows
    xs = x.float()
    if row_scale is not None:
        xs = xs * row_scale.float()[:, None]
    per_block = torch.bmm(xs.reshape(nb, block_rows, K).transpose(1, 2),
                          dy.float().reshape(nb, block_rows, N))  # [nb, K, N]
    be = block_expert.long()
    dw = torch.zeros(n_experts + 1, K, N, dtype=torch.float32, device=x.device)
    dw.index_add_(0, torch.where(be >= 0, be, n_experts), per_block)  # sentinels: spare slot
    return dw[:n_experts]


def _expert_block_lists(block_expert, n_experts: int, nb: int):
    """Per-expert block lists from a block -> expert map, as the JAX
    package's: (nblocks [E] int32, the real count of each expert's blocks;
    blist [E * nb] int32, blist[e * nb + l] the l-th block of expert e, the
    entries past its count repeating its last block). Sentinel (-1) blocks
    belong to no expert. Torch ops on block_expert's device, no host sync
    (the counts come from searchsorted, not bincount, which reads its max)."""
    dev = block_expert.device
    bucket = block_expert.remainder(n_experts + 1)  # sentinels (-1) into a spare bucket
    keys, order = torch.sort(bucket, stable=True)
    # where each bucket starts in the sorted order: blocks of expert e are
    # order[starts[e]:ends[e]]
    edges = torch.searchsorted(keys, torch.arange(n_experts + 1, device=dev, dtype=keys.dtype))
    starts, ends = edges[:-1], edges[1:]
    cnt = ends - starts
    last = torch.maximum(starts, ends - 1)  # the walk's last entry repeats
    idx = torch.minimum(starts[:, None] + torch.arange(nb, device=dev), last[:, None])
    idx = idx.clamp(max=nb - 1)
    return cnt.to(torch.int32), order[idx].reshape(-1).to(torch.int32)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


def _check_common(name, a, b, block_expert, row_scale, block_rows) -> None:
    """Raise on what kernel ``name`` does not take in its operands: a
    [R, K] and b, both contiguous, 16-byte aligned, bf16 or f32 of one
    dtype; block_expert a contiguous int32 [R // block_rows]; row_scale a
    contiguous f32 [R]; all on one device."""
    if a.ndim != 2:
        raise ValueError(f"{name} kernel: x must be [R, k], got {tuple(a.shape)}")
    R = a.shape[0]
    if a.dtype not in GMM_DTYPES:
        raise TypeError(f"{name} kernel: x must be bfloat16 or float32, got {a.dtype}")
    if b.dtype != a.dtype:
        raise TypeError(f"{name} kernel: operands are {a.dtype} and {b.dtype}")
    for t, what in ((a, "x"), (b, "the second operand")):
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel: {what} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} kernel: {what} must be 16-byte aligned")
    if block_rows <= 0 or block_rows % GMM_TILE_ROWS:
        raise ValueError(
            f"{name} kernel: block_rows {block_rows} must be a multiple of {GMM_TILE_ROWS}")
    if R % block_rows:
        raise ValueError(f"rows {R} not divisible by block_rows {block_rows}")
    if block_expert.dtype != torch.int32:
        raise TypeError(f"{name} kernel: block_expert must be int32, got {block_expert.dtype}")
    if tuple(block_expert.shape) != (R // block_rows,) or not block_expert.is_contiguous():
        raise ValueError(
            f"{name} kernel: block_expert must be a contiguous [{R // block_rows}], got "
            f"{tuple(block_expert.shape)}")
    named = [a, b, block_expert]
    if row_scale is not None:
        if row_scale.dtype != torch.float32:
            raise TypeError(f"{name} kernel: row_scale must be float32, got {row_scale.dtype}")
        if tuple(row_scale.shape) != (R,) or not row_scale.is_contiguous():
            raise ValueError(f"{name} kernel: row_scale must be a contiguous [{R}]")
        named.append(row_scale)
    if len({t.device for t in named}) != 1:
        raise ValueError(f"{name} kernel: tensors on several devices")


def check_fwd_args(x, w, block_expert, row_scale, block_rows, trans_w) -> tuple:
    """Raise on anything the forward kernels do not take; returns (R, K, N).
    Expert ids in block_expert are not checked (that would wait for the
    device): they must lie in [-1, E), as _moe_single_gmm's map does."""
    name = "gmm_fwd_scaled" if row_scale is not None else "gmm_fwd"
    if w.ndim != 3:
        raise ValueError(f"{name} kernel: w must be [E, k, n], got {tuple(w.shape)}")
    _check_common(name, x, w, block_expert, row_scale, block_rows)
    if row_scale is not None and trans_w:
        raise ValueError("gmm_fwd_scaled kernel: no transposed-weight form")
    R, K = x.shape
    N = w.shape[1] if trans_w else w.shape[2]
    if (w.shape[2] if trans_w else w.shape[1]) != K:
        raise ValueError(f"contraction mismatch: x k={K} vs w {tuple(w.shape)}")
    if K % 8 or N % 8:
        raise ValueError(f"{name} kernel: k {K} and n {N} must be multiples of 8")
    if x.device.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors, got {x.device}")
    return R, K, N


def check_dw_args(x, dy, block_expert, row_scale, block_rows) -> tuple:
    """Raise on anything the dw kernels do not take; returns (R, K, N)."""
    name = "gmm_dw_scaled" if row_scale is not None else "gmm_dw"
    if dy.ndim != 2 or dy.shape[0] != x.shape[0]:
        raise ValueError(f"{name} kernel: dy must be [R, n] beside x {tuple(x.shape)}, "
                         f"got {tuple(dy.shape)}")
    _check_common(name, x, dy, block_expert, row_scale, block_rows)
    R, K = x.shape
    N = dy.shape[1]
    if K % 8 or N % 8:
        raise ValueError(f"{name} kernel: k {K} and n {N} must be multiples of 8")
    if row_scale is not None and row_scale.data_ptr() % 16:
        raise ValueError(f"{name} kernel: row_scale must be 16-byte aligned")
    if x.device.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors, got {x.device}")
    return R, K, N


# C entry -> its argument types: every pointer and the stream as c_void_p
# (an undeclared argument passes as a 32-bit int and cuts the pointer).
_P, _I = ctypes.c_void_p, ctypes.c_int
GMM_ENTRIES = {
    "gmm_fwd": [_P] * 4 + [_I] * 6 + [_P],          # x w be y; R K N B trans bf16; stream
    "gmm_fwd_scaled": [_P] * 5 + [_I] * 5 + [_P],   # x w be s y; R K N B bf16
    "gmm_dw": [_P] * 5 + [_I] * 7 + [_P],           # x dy nblocks blist dw; R K N E nb B bf16
    "gmm_dw_scaled": [_P] * 6 + [_I] * 7 + [_P],    # x dy s nblocks blist dw; ...
}


def bind_gmm_entry(lib: ctypes.CDLL, name: str):
    """C entry ``name`` of a loaded grouped-matmul library, typed."""
    fn = getattr(lib, name)
    fn.argtypes = GMM_ENTRIES[name]
    fn.restype = ctypes.c_int
    return fn


def _gmm_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        from tf_operator_tpu_torch.ops import _build

        fn = _fns[name] = bind_gmm_entry(_build.load("grouped_matmul"), name)
    return fn


def _call(name, x, *args) -> None:
    with torch.cuda.device(x.device):
        err = _gmm_fn(name)(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err < 0:
        raise RuntimeError(f"{name} kernel: encoding a TMA tensor map failed: CUresult {-err}")
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def gmm_fwd_kernel(x, w, block_expert, row_scale=None, *, block_rows: int,
                   trans_w: bool = False):
    """Launch K5 (``row_scale`` None; ``trans_w`` for the dx product) or K6
    on CUDA tensors (raises on anything else). Same contract as
    gmm_fwd_reference."""
    global gmm_fwd_launches, gmm_fwd_scaled_launches
    R, K, N = check_fwd_args(x, w, block_expert, row_scale, block_rows, trans_w)
    y = torch.empty(R, N, dtype=x.dtype, device=x.device)
    if R == 0:
        return y
    bf16 = int(x.dtype == torch.bfloat16)
    if row_scale is None:
        _call("gmm_fwd", x, x.data_ptr(), w.data_ptr(), block_expert.data_ptr(), y.data_ptr(),
              R, K, N, block_rows, int(bool(trans_w)), bf16)
        gmm_fwd_launches += 1
    else:
        _call("gmm_fwd_scaled", x, x.data_ptr(), w.data_ptr(), block_expert.data_ptr(),
              row_scale.data_ptr(), y.data_ptr(), R, K, N, block_rows, bf16)
        gmm_fwd_scaled_launches += 1
    return y


def gmm_dw_kernel(x, dy, block_expert, n_experts: int, row_scale=None, *,
                  block_rows: int):
    """Launch K7a (``row_scale`` None) or K7b on CUDA tensors (raises on
    anything else): dw [E, K, N] f32. The block lists come from
    _expert_block_lists on the device. Same contract as gmm_dw_reference."""
    global gmm_dw_launches, gmm_dw_scaled_launches
    R, K, N = check_dw_args(x, dy, block_expert, row_scale, block_rows)
    if not 0 < n_experts <= GMM_DW_MAX_EXPERTS:
        raise ValueError(f"gmm_dw kernel: n_experts {n_experts} must be in "
                         f"[1, {GMM_DW_MAX_EXPERTS}]")
    dw = torch.empty(n_experts, K, N, dtype=torch.float32, device=x.device)
    if R == 0:
        return dw.zero_()
    nb = R // block_rows
    nblocks, blist = _expert_block_lists(block_expert, n_experts, nb)
    bf16 = int(x.dtype == torch.bfloat16)
    if row_scale is None:
        _call("gmm_dw", x, x.data_ptr(), dy.data_ptr(), nblocks.data_ptr(), blist.data_ptr(),
              dw.data_ptr(), R, K, N, n_experts, nb, block_rows, bf16)
        gmm_dw_launches += 1
    else:
        _call("gmm_dw_scaled", x, x.data_ptr(), dy.data_ptr(), row_scale.data_ptr(),
              nblocks.data_ptr(), blist.data_ptr(), dw.data_ptr(), R, K, N, n_experts, nb,
              block_rows, bf16)
        gmm_dw_scaled_launches += 1
    return dw


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------


def _fwd(x, w, block_expert, row_scale, block_rows, trans_w):
    if x.device.type == "cpu":
        return gmm_fwd_reference(x, w, block_expert, row_scale, block_rows=block_rows,
                                 trans_w=trans_w)
    return gmm_fwd_kernel(x, w, block_expert, row_scale, block_rows=block_rows,
                          trans_w=trans_w)


def _dw(x, dy, block_expert, n_experts, row_scale, block_rows):
    if x.device.type == "cpu":
        return gmm_dw_reference(x, dy, block_expert, n_experts, row_scale,
                                block_rows=block_rows)
    return gmm_dw_kernel(x, dy, block_expert, n_experts, row_scale, block_rows=block_rows)


class _GMM(torch.autograd.Function):
    """y = gmm(x, w): forward K5; backward dx = K5 against w^T, dw = K7a."""

    @staticmethod
    def forward(ctx, x, w, block_expert, block_rows):
        ctx.save_for_backward(x, w, block_expert)
        ctx.block_rows = block_rows
        return _fwd(x, w, block_expert, None, block_rows, False)

    @staticmethod
    def backward(ctx, dy):
        x, w, be = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _fwd(dy, w, be, None, ctx.block_rows, True).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _dw(x, dy, be, w.shape[0], None, ctx.block_rows).to(w.dtype)
        return dx, dw, None, None


class _GMMScaled(torch.autograd.Function):
    """y = gmm(x, w) * s: forward K6; backward one unscaled transposed
    product t = dy @ w^T (K5) gives dx = s * t and ds = rowsum(x * t)
    (x.(dy w^T) = (x w).dy, so no unscaled copy of y is saved), dw = K7b."""

    @staticmethod
    def forward(ctx, x, w, row_scale, block_expert, block_rows):
        ctx.save_for_backward(x, w, row_scale, block_expert)
        ctx.block_rows = block_rows
        return _fwd(x, w, block_expert, row_scale, block_rows, False)

    @staticmethod
    def backward(ctx, dy):
        x, w, s, be = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = ds = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[2]:
            t = _fwd(dy, w, be, None, ctx.block_rows, True).float()
            if ctx.needs_input_grad[0]:
                dx = (s.float()[:, None] * t).to(x.dtype)
            if ctx.needs_input_grad[2]:
                ds = (x.float() * t).sum(dim=-1).to(s.dtype)
        if ctx.needs_input_grad[1]:
            dw = _dw(x, dy, be, w.shape[0], s, ctx.block_rows).to(w.dtype)
        return dx, dw, ds, None, None


def gmm(x, w, block_expert, *, row_scale=None, block_rows: int = 256):
    """y[r] = x[r] @ w[block_expert[r // block_rows]]  (* row_scale[r]).

    x [R, k] with R % block_rows == 0, rows grouped so that every row block
    belongs to one expert; w [E, k, n]; block_expert [R // block_rows]
    int32, entries in [-1, E): -1 is a sentinel block, whose output rows
    are zeros and cost no product. ``row_scale``: optional [R] f32 applied
    to the f32 output rows before rounding (the fused MoE combine).
    Returns [R, n] in x's dtype. Differentiable in x, w and row_scale.

    CPU tensors run the plain versions; CUDA tensors run the kernels or
    raise — there is no fallback."""
    if x.ndim != 2 or w.ndim != 3:
        raise ValueError(f"gmm: x [R, k] (got {tuple(x.shape)}), w [E, k, n] "
                         f"(got {tuple(w.shape)})")
    R, k = x.shape
    if w.shape[1] != k:
        raise ValueError(f"contraction mismatch: x k={k} vs w k={w.shape[1]}")
    if R % block_rows:
        raise ValueError(f"rows {R} not divisible by block_rows {block_rows}")
    if tuple(block_expert.shape) != (R // block_rows,):
        raise ValueError(f"block_expert must be [{R // block_rows}], got "
                         f"{tuple(block_expert.shape)}")
    if row_scale is None:
        return _GMM.apply(x, w, block_expert, block_rows)
    return _GMMScaled.apply(x, w, row_scale, block_expert, block_rows)
