"""Paged decode attention: the plain PyTorch version and the Hopper kernel.

Port of the paged decode path of ``tf_operator_tpu/ops/flash_attention.py``
(``paged_decode_reference`` and ``flash_attention_decode``, whose TPU
kernel is ``_decode_kernel``). One query token per sequence attends over
that sequence's K/V, held in fixed-size pages of a pool (the
serve/kvcache.py layout) and named by a page table.

Dispatch is by the tensors' device, never by a fallback: CPU tensors go
to ``paged_decode_reference``; CUDA tensors go to the hand-written kernel
(``csrc/paged_decode.cu``) or the call raises. ``decode_launches`` counts
the kernel's launches.

Rows with ``seq_len == 0`` (inactive slots, padded prefill rows) come out
exactly zero on both paths, as from the TPU kernel. The JAX package's
reference returns a uniform-softmax artifact there instead; callers never
read those rows either way.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30  # large-negative, not -inf: exp() of a masked score is 0, never nan

# Kernel limits (keep in step with csrc/paged_decode.cu).
KERNEL_THREADS = 128
KERNEL_MAX_GD = KERNEL_THREADS * 8   # g * d: per-thread f32 accumulators
KERNEL_MAX_PAGE = 32                 # one warp lane per page position
KERNEL_MAX_SMEM = 48 * 1024          # static launch limit, no opt-in attribute

decode_launches = 0  # launches of the CUDA kernel in this process

_fn = None


def paged_decode_reference(q, k_pages, v_pages, page_table, seq_lens):
    """Plain paged decode attention, same contract as the kernel.

    q [s, h, d] (one query token per sequence), k_pages/v_pages
    [n_pages, page_size, h_kv, d], page_table [s, p] int (page ids in
    sequence order; entries past the live prefix may be any valid id),
    seq_lens [s] int = valid K/V positions INCLUDING the current one.
    Gathers pages to [s, p·page_size, h_kv, d], masks positions >= seq_len
    with NEG_INF, f32 softmax; rows with seq_len == 0 return zeros."""
    s_n, h, d = q.shape
    _, page_size, h_kv, _ = k_pages.shape
    p = page_table.shape[1]
    g = h // h_kv
    table = page_table.long()
    k = k_pages[table].reshape(s_n, p * page_size, h_kv, d).float()
    v = v_pages[table].reshape(s_n, p * page_size, h_kv, d).float()
    q5 = q.reshape(s_n, h_kv, g, d).float() * d**-0.5
    s = torch.einsum("shgd,sthd->shgt", q5, k)  # [s, h_kv, g, t]
    kpos = torch.arange(p * page_size, device=q.device)
    live = kpos < seq_lens.long()[:, None, None, None]
    s = torch.where(live, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    pr = torch.where(live, torch.exp(s - m), 0.0)
    l = pr.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    out = torch.einsum("shgt,sthd->shgd", pr / l, v)
    return out.reshape(s_n, h, d).to(q.dtype)


def _check_kernel_args(q, k_pages, v_pages, page_table, seq_lens) -> None:
    """Raise on anything the CUDA kernel does not take."""
    s_n, h, d = q.shape
    _, page_size, h_kv, _ = k_pages.shape
    g = h // h_kv
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != torch.float32:
            raise TypeError(f"paged_decode kernel: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"paged_decode kernel: {name} must be contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_decode kernel: K/V pools must be 16-byte aligned")
    for name, t in (("page_table", page_table), ("seq_lens", seq_lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"paged_decode kernel: {name} must be int32, got {t.dtype}")
    if page_table.ndim != 2 or page_table.shape[0] != s_n:
        raise ValueError(f"page_table must be [{s_n}, p], got {tuple(page_table.shape)}")
    if page_table.shape[1] > 1 and page_table.stride(1) != 1:
        raise ValueError("page_table rows must be contiguous (any row stride)")
    if tuple(seq_lens.shape) != (s_n,) or not seq_lens.is_contiguous():
        raise ValueError(f"seq_lens must be a contiguous [{s_n}], got {tuple(seq_lens.shape)}")
    devs = {t.device for t in (q, k_pages, v_pages, page_table, seq_lens)}
    if len(devs) != 1:
        raise ValueError(f"paged_decode: tensors on several devices {devs}")
    if d % 4:
        raise ValueError(f"paged_decode kernel: head_dim {d} must be a multiple of 4")
    if not 1 <= page_size <= KERNEL_MAX_PAGE:
        raise ValueError(f"paged_decode kernel: page_size {page_size} not in [1, {KERNEL_MAX_PAGE}]")
    if g * d > KERNEL_MAX_GD:
        raise ValueError(f"paged_decode kernel: group {g} x head_dim {d} > {KERNEL_MAX_GD}")
    smem = 4 * (g * d + 2 * page_size * d + g * page_size + 3 * g)
    if smem > KERNEL_MAX_SMEM:
        raise ValueError(f"paged_decode kernel: needs {smem} bytes of shared memory > {KERNEL_MAX_SMEM}")


def _kernel_fn():
    global _fn
    if _fn is None:
        from tf_operator_tpu_torch.ops import _build

        fn = _build.load("paged_decode").paged_decode_f32
        # Every pointer and the stream as c_void_p: an undeclared argument
        # passes as a 32-bit int and cuts the pointer.
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v
            ctypes.c_void_p, ctypes.c_longlong,                 # table, row stride
            ctypes.c_void_p, ctypes.c_void_p,                   # seq_lens, out
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # s, h, h_kv, d
            ctypes.c_int, ctypes.c_int,                         # page_size, max_pages
            ctypes.c_float, ctypes.c_void_p,                    # scale, stream
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def paged_decode_kernel(q, k_pages, v_pages, page_table, seq_lens):
    """Launch the Hopper kernel on CUDA tensors (raises on anything else).

    Types, shapes, strides and sizes are checked here; the page ids of
    each live prefix are not (that would wait for the device): they must
    lie in [0, n_pages), as the engine's allocator guarantees."""
    global decode_launches
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode kernel needs CUDA tensors, got {q.device}")
    _check_kernel_args(q, k_pages, v_pages, page_table, seq_lens)
    s_n, h, d = q.shape
    _, page_size, h_kv, _ = k_pages.shape
    out = torch.empty_like(q)
    if s_n == 0:
        return out
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), page_table.stride(0), seq_lens.data_ptr(),
            out.data_ptr(), s_n, h, h_kv, d, page_size, page_table.shape[1],
            d**-0.5, torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"paged_decode kernel launch failed: cudaError_t {err}")
    decode_launches += 1
    return out


def flash_attention_decode(q, k_pages, v_pages, page_table, seq_lens):
    """Paged decode attention: one query token per sequence against a
    paged K/V cache.

    q [s, h, d]; k_pages/v_pages [n_pages, page_size, h_kv, d];
    page_table [s, max_pages] int32; seq_lens [s] int32 (valid K/V
    length per sequence, INCLUDING the just-written current position).
    Returns [s, h, d] in q's dtype. GQA-native: the g = h / h_kv query
    heads of a group share each K/V page read.

    CPU tensors run the plain version; CUDA tensors run the kernel or
    raise — there is no fallback."""
    if q.ndim != 3 or k_pages.ndim != 4:
        raise ValueError(
            f"decode shapes: q [s,h,d] (got {tuple(q.shape)}), pages "
            f"[n,page,h_kv,d] (got {tuple(k_pages.shape)})"
        )
    if k_pages.shape != v_pages.shape:
        raise ValueError(
            f"k/v pool mismatch: {tuple(k_pages.shape)} vs {tuple(v_pages.shape)}"
        )
    h, h_kv = q.shape[1], k_pages.shape[2]
    if h % h_kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    if q.device.type == "cpu":
        return paged_decode_reference(q, k_pages, v_pages, page_table, seq_lens)
    return paged_decode_kernel(q, k_pages, v_pages, page_table, seq_lens)
