"""Attention for the port: flash attention for training, paged decode for
serving. Each has a plain PyTorch version and a hand-written Hopper kernel.

Port of ``tf_operator_tpu/ops/flash_attention.py``:

- ``reference_attention``/``reference_attention_lse``: dense GQA-native
  attention with an f32 softmax (the ``attn: dense`` path and the oracle).
- ``flash_attention``/``flash_attention_lse``: one ``torch.autograd.Function``
  whose forward is the flash forward kernel (``csrc/flash_fwd.cu``, for
  the TPU's ``_fwd_kernel``) and whose backward is the dQ and dK/dV
  kernels (``csrc/flash_bwd.cu``, for ``_bwd_dq_kernel`` and
  ``_bwd_dkv_kernel``), with the lse cotangent folded into ``delta`` as
  ``_bwd`` does. Public layout ``[b, t, h, d]``; lse ``[b, t, h]`` f32.
  The TPU's measured block-size gates (``_use_kernel``, ``_pick_block``)
  are not carried over: the CUDA kernels take any ``t`` and mask the
  ragged edge themselves.
- ``flash_attention_decode``: paged decode (``paged_decode_reference`` and
  ``csrc/paged_decode.cu``, for the TPU's ``_decode_kernel``). One query
  token per sequence attends over that sequence's K/V, held in fixed-size
  pages of a pool (the serve/kvcache.py layout) and named by a page table.
  The kernel splits each walk over the live pages across blocks and merges
  the partials; ``paged_decode_split_reference`` is that arithmetic in
  plain PyTorch, for the tests.

Dispatch is by the tensors' device, never by a fallback: CPU tensors go
to the plain versions; CUDA tensors go to the kernels or the call raises.
``flash_fwd_launches``, ``flash_bwd_dq_launches``, ``flash_bwd_dkv_launches``
and ``decode_launches`` count the kernels' launches.

Paged decode rows with ``seq_len == 0`` (inactive slots, padded prefill
rows) come out exactly zero on both paths, as from the TPU kernel. The
JAX package's reference returns a uniform-softmax artifact there
instead; callers never read those rows either way.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30  # large-negative, not -inf: exp() of a masked score is 0, never nan

# Kernel limits (keep in step with csrc/paged_decode.cu): one float4 of d a
# lane, 8 positions of a page a warp, g query rows in registers.
KERNEL_MAX_D = 128
KERNEL_MAX_PAGE = 32
KERNEL_MAX_GROUP = 8
KERNEL_MAX_SPLITS = 65535  # the grid's z extent
# Blocks a decode launch aims at, per SM of the card: all resident at once
# (paged_decode.cu takes up to 3 an SM at 64 KB of ring each). Of 1, 2, 4
# and 8 an SM, 2 was the fastest on an H100 at the serve shape and at a
# long context together (PERF.md).
_DECODE_BLOCKS_PER_SM = 2

decode_launches = 0  # launches of the CUDA kernel in this process

_fn = None
_sm_counts: dict[int, int] = {}  # CUDA device index -> its SM count


def decode_target_blocks(device: torch.device) -> int:
    """Blocks a decode launch on this CUDA device aims at: 2 an SM."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _DECODE_BLOCKS_PER_SM * _sm_counts[index]


def decode_splits(s: int, h_kv: int, max_pages: int, target_blocks: int) -> int:
    """Splits of each (sequence, kv head) walk of the paged-decode kernel:
    about ``target_blocks`` blocks in all, from the shapes alone (seq_lens
    live on the card, and reading them would sync the host once per
    layer), at most one per table slot. The kernel gives split j the j-th
    run of ceil(n_live / splits) live pages."""
    return max(1, min(max_pages, -(-target_blocks // max(1, s * h_kv))))


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


def paged_decode_split_reference(q, k_pages, v_pages, page_table, seq_lens, splits: int):
    """Plain paged decode computed as the kernel splits it, for tests: each
    row's n_live = ceil(seq_len / page) live pages cut into runs of
    ceil(n_live / splits) pages, each run's (max, sum, unnormalised output)
    over its unmasked positions, and the runs merged in order with the
    log-sum-exp rescale. Same contract as paged_decode_reference."""
    s_n, h, d = q.shape
    _, page_size, h_kv, _ = k_pages.shape
    g = h // h_kv
    out = torch.zeros(s_n, h_kv, g, d, dtype=torch.float32)
    qs = q.reshape(s_n, h_kv, g, d).float() * d**-0.5
    for i in range(s_n):
        n_live = min(-(-int(seq_lens[i]) // page_size), page_table.shape[1])
        if n_live <= 0:
            continue
        run = -(-n_live // splits)
        parts = []
        for p0 in range(0, n_live, run):
            pages = page_table[i, p0: min(p0 + run, n_live)].long()
            k = k_pages[pages].reshape(-1, h_kv, d).float()
            v = v_pages[pages].reshape(-1, h_kv, d).float()
            live = p0 * page_size + torch.arange(k.shape[0]) < int(seq_lens[i])
            sc = torch.where(live, torch.einsum("hgd,thd->hgt", qs[i], k), NEG_INF)
            m = sc.amax(dim=-1, keepdim=True)  # finite: a run's first position is live
            pr = torch.where(live, torch.exp(sc - m), 0.0)
            parts.append((m, pr.sum(dim=-1, keepdim=True), torch.einsum("hgt,thd->hgd", pr, v)))
        mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        o = torch.zeros(h_kv, g, d)
        lsum = torch.zeros(h_kv, g, 1)
        for m, l, acc in parts:
            c = torch.exp(m - mx)
            o = o + acc * c
            lsum = lsum + l * c
        out[i] = o / lsum
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
    if q.data_ptr() % 16 or k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_decode kernel: q and the K/V pools must be 16-byte aligned")
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
    if d % 4 or d > KERNEL_MAX_D:
        raise ValueError(f"paged_decode kernel: head_dim {d} must be a multiple of 4 "
                         f"and at most {KERNEL_MAX_D}")
    if not 1 <= page_size <= KERNEL_MAX_PAGE:
        raise ValueError(f"paged_decode kernel: page_size {page_size} not in [1, {KERNEL_MAX_PAGE}]")
    if g > KERNEL_MAX_GROUP:
        raise ValueError(f"paged_decode kernel: group {g} (heads {h} / kv heads {h_kv}) "
                         f"> {KERNEL_MAX_GROUP}")


# C entry -> argument types: every pointer and the stream as c_void_p (an
# undeclared argument passes as a 32-bit int and cuts the pointer).
DECODE_ENTRY = "paged_decode_f32"
DECODE_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v
    ctypes.c_void_p, ctypes.c_longlong,                 # table, row stride
    ctypes.c_void_p, ctypes.c_void_p,                   # seq_lens, out
    ctypes.c_void_p, ctypes.c_void_p,                   # part_o, part_ml (scratch)
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # s, h, h_kv, d
    ctypes.c_int, ctypes.c_int, ctypes.c_int,           # page_size, max_pages, splits
    ctypes.c_float, ctypes.c_void_p,                    # scale, stream
]


def bind_decode_entry(lib: ctypes.CDLL):
    """The typed C entry of a loaded paged_decode library."""
    fn = getattr(lib, DECODE_ENTRY)
    fn.argtypes = DECODE_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _kernel_fn():
    global _fn
    if _fn is None:
        from tf_operator_tpu_torch.ops import _build

        _fn = bind_decode_entry(_build.load("paged_decode"))
    return _fn


def paged_decode_kernel(q, k_pages, v_pages, page_table, seq_lens, splits: int | None = None):
    """Launch the Hopper kernel on CUDA tensors (raises on anything else).

    Types, shapes, strides and sizes are checked here; the page ids of
    each live prefix are not (that would wait for the device): they must
    lie in [0, n_pages), as the engine's allocator guarantees. ``splits``
    is the number of blocks each (sequence, kv head) walk is cut into;
    None takes decode_splits for this card. The kernel's per-split
    partials go to scratch allocated here."""
    global decode_launches
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode kernel needs CUDA tensors, got {q.device}")
    _check_kernel_args(q, k_pages, v_pages, page_table, seq_lens)
    s_n, h, d = q.shape
    _, page_size, h_kv, _ = k_pages.shape
    out = torch.empty_like(q)
    if s_n == 0:
        return out
    if splits is None:
        splits = decode_splits(s_n, h_kv, page_table.shape[1], decode_target_blocks(q.device))
    if not 1 <= splits <= KERNEL_MAX_SPLITS:
        raise ValueError(f"paged_decode kernel: splits {splits} not in [1, {KERNEL_MAX_SPLITS}]")
    part_o = torch.empty(s_n, h, splits, d, dtype=torch.float32, device=q.device)
    part_ml = torch.empty(s_n, h, splits, 2, dtype=torch.float32, device=q.device)
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), page_table.stride(0), seq_lens.data_ptr(),
            out.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(), s_n, h, h_kv, d,
            page_size, page_table.shape[1], splits, d**-0.5,
            torch.cuda.current_stream(q.device).cuda_stream,
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


# ---------------------------------------------------------------------------
# flash attention (training): plain versions
# ---------------------------------------------------------------------------

# Launches of each CUDA kernel in this process.
flash_fwd_launches = 0
flash_bwd_dq_launches = 0
flash_bwd_dkv_launches = 0
# (query heads, KV heads) of the forward kernel's last launch
flash_fwd_heads = None

# Kernel limits (keep in step with csrc/flash_fwd.cu and csrc/flash_bwd.cu):
# tiles of FLASH_TILE rows (queries or keys), TMA boxes of 64 columns (d
# padded to 64 or 128), head dims that are multiples of 16 and at most
# FLASH_MAX_D (the sums live in registers), and at most FLASH_MAX_SMEM bytes
# of dynamic shared memory (the H100's per-block opt-in limit). bf16 and
# f32 run the same kernels; f32 operands become two bf16 planes (hi and lo).
FLASH_TILE = 64
FLASH_MAX_D = 128
FLASH_MAX_SMEM = 232448
FLASH_PLANES = {torch.bfloat16: 1, torch.float32: 2}

_flash_fns: dict = {}


def _scores(q, k, causal):
    """Scaled, masked f32 scores [b, h_kv, g, t, t] of q [b, t, h, d] against
    k [b, t, h_kv, d]: the grouped einsum, no repeated K. Masked entries hold
    NEG_INF, so exp(s - lse) is exactly 0 there."""
    b, t, h, d = q.shape
    h_kv = k.shape[2]
    q5 = q.float().reshape(b, t, h_kv, h // h_kv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q5, k.float()) * d**-0.5
    if causal:
        tk = k.shape[1]
        mask = torch.ones(t, tk, dtype=torch.bool, device=q.device).tril(tk - t)
        s = torch.where(mask, s, NEG_INF)
    return s


def reference_attention_lse(q, k, v, causal: bool = False):
    """Dense (o, lse): o [b, t, h, d] in q's dtype, lse [b, t, h] f32, the
    row logsumexp of the scaled, masked scores. GQA-native: k/v may carry
    h_kv < h heads (h % h_kv == 0) and are never repeated. As the JAX
    package's: scores and softmax in f32 (bf16 inputs are exact in f32,
    so the products are those of an f32-accumulating matmul), the
    probabilities cast to q's dtype before the product with v."""
    b, t, h, d = q.shape
    s = _scores(q, k, causal)
    lse = torch.logsumexp(s, dim=-1)  # [b, h_kv, g, t]
    p = torch.exp(s - lse[..., None]).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v).reshape(b, t, h, d)
    return out, lse.reshape(b, h, t).transpose(1, 2)


def reference_attention(q, k, v, causal: bool = False):
    """Dense attention: reference_attention_lse with the lse dropped."""
    return reference_attention_lse(q, k, v, causal)[0]


def flash_fwd_reference(q, k, v, causal: bool):
    """Plain version of the forward kernel: (o, lse) with o in q's dtype and
    lse [b, t, h] f32, all arithmetic in f32."""
    o, lse = reference_attention_lse(q.float(), k.float(), v.float(), causal)
    return o.to(q.dtype), lse


def _dscores(q, k, v, do, lse_bht, delta_bht, causal):
    """(p, ds), both [b, h_kv, g, t, t] f32: P rebuilt from the lse as the
    backward kernels do, and ds = p * (dO.v^T - delta)."""
    b, t, h, d = q.shape
    h_kv = k.shape[2]
    lse5 = lse_bht.float().reshape(b, h_kv, h // h_kv, t)
    p = torch.exp(_scores(q, k, causal) - lse5[..., None])
    do5 = do.float().reshape(b, t, h_kv, h // h_kv, d)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do5, v.float())
    delta5 = delta_bht.float().reshape(b, h_kv, h // h_kv, t)
    return p, p * (dp - delta5[..., None])


def flash_bwd_dq_reference(q, k, v, do, lse_bht, delta_bht, causal: bool):
    """Plain version of the dQ kernel; lse and delta in its [b, h, t] layout."""
    b, t, h, d = q.shape
    _, ds = _dscores(q, k, v, do, lse_bht, delta_bht, causal)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * d**-0.5
    return dq.reshape(b, t, h, d).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse_bht, delta_bht, causal: bool):
    """Plain version of the dK/dV kernel: (dk, dv), each summed over the g
    query heads of its group."""
    b, t, h, d = q.shape
    h_kv = k.shape[2]
    p, ds = _dscores(q, k, v, do, lse_bht, delta_bht, causal)
    q5 = q.float().reshape(b, t, h_kv, h // h_kv, d)
    do5 = do.float().reshape(b, t, h_kv, h // h_kv, d)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, q5) * d**-0.5
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, do5)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_delta(o, do, dlse=None):
    """delta = rowsum(dO * O) - dlse in the kernels' [b, h, t] f32 layout.
    The lse cotangent folds in here (d lse_i / d s_ij = p_ij), so the
    backward kernels serve flash_attention_lse unchanged, as in the JAX
    package's _bwd; like there, it is computed outside the kernels."""
    delta = (do.float() * o.float()).sum(dim=-1)  # [b, t, h]
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.transpose(1, 2).contiguous()


def lse_kernel_layout(lse):
    """Public [b, t, h] lse -> the kernels' contiguous [b, h, t] (no copy
    when lse is the kernel's own transposed output)."""
    return lse.transpose(1, 2).contiguous()


def flash_bwd_reference(q, k, v, o, lse, do, dlse, causal: bool):
    """Plain version of the whole backward: (dq, dk, dv) from the forward's
    o and lse [b, t, h] and the cotangents do and dlse (None = zero)."""
    lse_k, delta = lse_kernel_layout(lse), flash_delta(o, do, dlse)
    dq = flash_bwd_dq_reference(q, k, v, do, lse_k, delta, causal)
    dk, dv = flash_bwd_dkv_reference(q, k, v, do, lse_k, delta, causal)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# flash attention: the CUDA kernels
# ---------------------------------------------------------------------------


def flash_smem_bytes(kind: str, dtype: torch.dtype, d: int) -> int:
    """Dynamic shared memory of one block of kernel ``kind`` (``fwd``,
    ``dq``, ``dkv``); the formulas of csrc/flash_*.cu."""
    planes = FLASH_PLANES[dtype]
    if kind == "fwd":
        # FwdLayout: bf16 boxes of 128-byte rows, d padded to 64 or 128
        # columns; Q [2 warpgroups][64 rows] in two buffers (f32: its hi and
        # lo planes); K and V [64 keys] a stage in the element type, 5
        # stages (f32: 1, split into K/V planes); two mbarriers of 8 bytes a
        # stage and a Q buffer; 1024 to align
        row = (64 if d <= 64 else 128) // 64 * 128
        q, kv = 2 * 64 * row, 2 * 64 * row
        stages, qbufs = (1, 1) if planes == 2 else (5, 2)
        split = 2 * kv if planes == 2 else 0
        return 2 * q + stages * planes * kv + split + 2 * (stages + qbufs) * 8 + 1024
    # DqLayout, DkvLayout: d padded to 1 or 2 boxes of 64 columns; a slot
    # holds one landed box of 64 rows (f32: split in place into its bf16 hi
    # and lo planes)
    boxes = 1 if d <= 64 else 2
    slot = FLASH_TILE * 64 * 2 * planes
    if kind == "dq":
        # Q, then dO, of both warpgroups in one buffer at d > 64 (two below;
        # f32: one); K, then V, of a 64-key tile a stage, 4 stages at d > 64,
        # 5 below (f32: 1)
        stages, qbufs = (1, 1) if planes == 2 else ((4, 1) if boxes == 2 else (5, 2))
        return (qbufs * 4 * boxes * slot + stages * 2 * boxes * slot
                + 2 * (stages + qbufs) * 8 + 1024)
    # dkv: the item's K, then V, of 2 x 64 keys at d > 64 (below and f32:
    # 64); Q, then dO, of a 64-query tile a stage, 2 stages at d > 64, 3
    # below (f32: 1); each consumer warp's (4 a group of 64 keys) two
    # buffers of a tile's 64 lse and 64 delta
    groups = 2 if planes == 1 and boxes == 2 else 1
    stages = 1 if planes == 2 else (2 if boxes == 2 else 3)
    return (2 * groups * boxes * slot + stages * 2 * boxes * slot
            + 4 * groups * 2 * 2 * FLASH_TILE * 4 + 2 * (stages + 1) * 8 + 1024)


def check_flash_args(kind, q, k, v, do=None, lse=None, delta=None) -> None:
    """Raise on anything the flash kernel ``kind`` does not take. Runs on
    tensors of any device (no launch), so the CPU tests reach it."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(
            f"flash kernel: q, k, v must be [b, t, heads, d], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, d = q.shape
    h_kv = k.shape[2]
    if tuple(k.shape) != (b, t, h_kv, d) or k.shape != v.shape:
        raise ValueError(
            f"flash kernel: k and v must be [{b}, {t}, h_kv, {d}], got "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    if h_kv == 0 or h % h_kv:
        raise ValueError(f"flash kernel: q heads {h} not a multiple of kv heads {h_kv}")
    named = [("q", q), ("k", k), ("v", v)]
    if do is not None:
        if do.shape != q.shape:
            raise ValueError(f"flash kernel: do {tuple(do.shape)} != q {tuple(q.shape)}")
        named.append(("do", do))
    if q.dtype not in FLASH_PLANES:
        raise TypeError(f"flash kernel: q must be bfloat16 or float32, got {q.dtype}")
    for name, x in named:
        if x.dtype != q.dtype:
            raise TypeError(f"flash kernel: {name} is {x.dtype}, q is {q.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"flash kernel: {name} must be contiguous [b, t, heads, d]")
        if x.data_ptr() % 16:
            raise ValueError(f"flash kernel: {name} must be 16-byte aligned")
    for name, x in (("lse", lse), ("delta", delta)):
        if x is None:
            continue
        if x.dtype != torch.float32:
            raise TypeError(f"flash kernel: {name} must be float32, got {x.dtype}")
        if tuple(x.shape) != (b, h, t) or not x.is_contiguous():
            raise ValueError(
                f"flash kernel: {name} must be a contiguous [b, h, t] = "
                f"[{b}, {h}, {t}], got {tuple(x.shape)}")
        named.append((name, x))
    if len({x.device for _, x in named}) != 1:
        raise ValueError("flash kernel: tensors on several devices")
    if d % 16:
        raise ValueError(f"flash kernel: head_dim {d} must be a multiple of 16")
    if d > FLASH_MAX_D:
        raise ValueError(f"flash kernel: head_dim {d} > {FLASH_MAX_D} (register tiles)")
    smem = flash_smem_bytes(kind, q.dtype, d)
    if smem > FLASH_MAX_SMEM:
        raise ValueError(
            f"flash {kind} kernel: head_dim {d} needs {smem} bytes of shared "
            f"memory > {FLASH_MAX_SMEM}")


# C entry -> (library, pointer arguments)
FLASH_ENTRIES = {"flash_fwd": ("flash_fwd", 5), "flash_bwd_dq": ("flash_bwd", 7),
                 "flash_bwd_dkv": ("flash_bwd", 8)}


def bind_flash_entry(lib: ctypes.CDLL, name: str):
    """C entry ``name`` of a loaded flash library, with its argument types:
    every pointer and the stream as c_void_p (an undeclared argument passes
    as a 32-bit int and cuts the pointer)."""
    fn = getattr(lib, name)
    fn.argtypes = (
        [ctypes.c_void_p] * FLASH_ENTRIES[name][1]
        + [ctypes.c_int] * 6          # b, t, h, h_kv, d, causal
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # scale, bf16, stream
    )
    fn.restype = ctypes.c_int
    return fn


def _flash_fn(name: str):
    fn = _flash_fns.get(name)
    if fn is None:
        from tf_operator_tpu_torch.ops import _build

        fn = _flash_fns[name] = bind_flash_entry(_build.load(FLASH_ENTRIES[name][0]), name)
    return fn


def _launch(name, ptrs, q, k, causal):
    if q.device.type != "cuda":
        raise ValueError(f"flash kernel needs CUDA tensors, got {q.device}")
    b, t, h, d = q.shape
    fn = _flash_fn(name)
    with torch.cuda.device(q.device):
        err = fn(*[x.data_ptr() for x in ptrs], b, t, h, k.shape[2], d, int(bool(causal)),
                 d**-0.5, int(q.dtype == torch.bfloat16),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def flash_fwd_kernel(q, k, v, causal: bool):
    """Launch the forward kernel on CUDA tensors (raises on anything else):
    (o, lse) with lse [b, t, h] f32, a view of the kernel's [b, h, t]."""
    global flash_fwd_launches, flash_fwd_heads
    check_flash_args("fwd", q, k, v)
    b, t, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
    if q.numel():
        _launch("flash_fwd", (q, k, v, o, lse), q, k, causal)
        flash_fwd_launches += 1
        flash_fwd_heads = (h, k.shape[2])
    return o, lse.transpose(1, 2)


def flash_bwd_dq_kernel(q, k, v, do, lse_bht, delta_bht, causal: bool):
    """Launch the dQ kernel; lse and delta in its [b, h, t] layout."""
    global flash_bwd_dq_launches
    check_flash_args("dq", q, k, v, do, lse_bht, delta_bht)
    dq = torch.empty_like(q)
    if q.numel():
        _launch("flash_bwd_dq", (q, k, v, do, lse_bht, delta_bht, dq), q, k, causal)
        flash_bwd_dq_launches += 1
    return dq


def flash_bwd_dkv_kernel(q, k, v, do, lse_bht, delta_bht, causal: bool):
    """Launch the dK/dV kernel; lse and delta in its [b, h, t] layout."""
    global flash_bwd_dkv_launches
    check_flash_args("dkv", q, k, v, do, lse_bht, delta_bht)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel():
        _launch("flash_bwd_dkv", (q, k, v, do, lse_bht, delta_bht, dk, dv), q, k, causal)
        flash_bwd_dkv_launches += 1
    return dk, dv


def flash_bwd_kernel(q, k, v, o, lse, do, dlse, causal: bool):
    """The whole backward on the card: delta in PyTorch, then the dQ and
    dK/dV kernels. Same contract as flash_bwd_reference."""
    lse_k, delta = lse_kernel_layout(lse), flash_delta(o, do, dlse)
    dq = flash_bwd_dq_kernel(q, k, v, do, lse_k, delta, causal)
    dk, dv = flash_bwd_dkv_kernel(q, k, v, do, lse_k, delta, causal)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# flash attention: public entry
# ---------------------------------------------------------------------------


def _flash_fwd(q, k, v, causal):
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal)
    return flash_fwd_kernel(q, k, v, causal)


def _flash_bwd(q, k, v, o, lse, do, dlse, causal):
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, o, lse, do, dlse, causal)
    return flash_bwd_kernel(q, k, v, o, lse, do, dlse, causal)


class _FlashAttention(torch.autograd.Function):
    """Forward: the flash forward kernel, saving (q, k, v, o, lse). Backward:
    the dQ and dK/dV kernels, P rebuilt from lse. Under activation
    checkpointing the forward runs again in the backward to rebuild them,
    as the JAX custom VJP's forward does under remat."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = _flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, o, lse, do.contiguous(), dlse, ctx.causal)
        return dq, dk, dv, None


def _check_heads(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash attention: q [b,t,h,d] (got {tuple(q.shape)}), k/v "
            f"[b,t,h_kv,d] (got {tuple(k.shape)}, {tuple(v.shape)})")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"q heads {q.shape[2]} not a multiple of kv heads {k.shape[2]}")


def flash_attention_lse(q, k, v, causal: bool = False):
    """Self-attention over [b, t, h, d] returning ``(o, lse)``, lse [b, t, h]
    f32 (the row logsumexp of the scaled, masked scores). Gradients are
    exact through lse: its cotangent folds into the backward's delta.
    GQA-native: k/v carry h_kv heads, h % h_kv == 0, never repeated.

    CPU tensors run the plain versions; CUDA tensors run the kernels or
    raise — there is no fallback."""
    _check_heads(q, k, v)
    return _FlashAttention.apply(q, k, v, bool(causal))


def flash_attention(q, k, v, causal: bool = False):
    """flash_attention_lse without the lse (one custom Function serves both;
    the lse is a residual either way)."""
    return flash_attention_lse(q, k, v, causal)[0]
