"""The port's paged decode attention against the JAX package's, on the
CPU: the plain version against JAX's gather reference and against the
Pallas decode kernel in interpret mode, on the cases of
tests/test_flash_decode.py (ragged lengths across page boundaries, MHA
and GQA, scrambled page ids, token-by-token growth). The wrapper's
argument checks, which guard the CUDA kernel, run here too; the kernel
itself runs only on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import importlib  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from tf_operator_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from tf_operator_tpu_torch.serve.kvcache import (  # noqa: E402
    PagePool,
    SequencePages,
    pages_needed,
)

# the JAX package's ops/__init__ re-exports a function under the module's name
jfa = importlib.import_module("tf_operator_tpu.ops.flash_attention")
torch.set_num_threads(1)

# f32 on both sides; the two differ only in summation order.
TOL = dict(atol=2e-5, rtol=2e-5)
RAGGED = [5, 16, 23, 1]  # mid-page end, page boundary, crossing, one token
PAGE = 8


def _paged(lengths, page, h, h_kv, d, seed, scramble=False, stale=0.0):
    """Numpy pools holding each sequence's K/V prefix, its page table
    (padded with a real page id, as the engine pads) and one query per
    sequence. ``stale`` fills every unwritten slot with uniform garbage of
    that size, as freed pages keep their previous owner's K/V."""
    rng = np.random.RandomState(seed)
    num_pages = sum(pages_needed(L, page) for L in lengths) + 2
    pool = PagePool(num_pages)
    if scramble:
        pool._free = [int(p) for p in rng.permutation(num_pages)]
    shape = (num_pages + 1, page, h_kv, d)
    k = rng.uniform(-stale, stale, shape).astype(np.float32)
    v = rng.uniform(-stale, stale, shape).astype(np.float32)
    table = np.full((len(lengths), max(pages_needed(L, page) for L in lengths)),
                    pool.trash_page - 1, np.int32)
    for i, L in enumerate(lengths):
        sp = SequencePages(page)
        if L:
            sp.ensure(L, pool)
        table[i, : len(sp.pages)] = sp.pages
        for t in range(L):
            k[sp.pages[t // page], t % page] = rng.randn(h_kv, d)
            v[sp.pages[t // page], t % page] = rng.randn(h_kv, d)
    q = rng.randn(len(lengths), h, d).astype(np.float32)
    return q, k, v, table, np.asarray(lengths, np.int32)


def _port(*arrays):
    return tfa.flash_attention_decode(*(torch.from_numpy(a) for a in arrays)).numpy()


def _jax_ref(*arrays):
    return np.asarray(jfa.paged_decode_reference(*(jnp.asarray(a) for a in arrays)))


def _jax_kernel(*arrays):
    return np.asarray(jfa.flash_attention_decode(
        *(jnp.asarray(a) for a in arrays), interpret=True))


@pytest.mark.parametrize("h,h_kv", [(4, 4), (4, 2), (8, 2)], ids=["mha", "gqa2", "gqa4"])
@pytest.mark.parametrize("scramble", [False, True], ids=["seq", "scrambled"])
def test_plain_matches_jax_reference(h, h_kv, scramble):
    args = _paged(RAGGED, PAGE, h, h_kv, 16, seed=1, scramble=scramble)
    np.testing.assert_allclose(_port(*args), _jax_ref(*args), **TOL)


@pytest.mark.parametrize("h,h_kv", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_plain_matches_jax_interpret_kernel(h, h_kv):
    """Against the Pallas kernel (interpret mode), with empty rows and
    large stale values in every unwritten slot: live rows agree, and
    seq_len == 0 rows are exact zeros on both."""
    lengths = [5, 0, 16, 23, 1, 0]
    args = _paged(lengths, PAGE, h, h_kv, 128, seed=3, scramble=True, stale=1e4)
    got, want = _port(*args), _jax_kernel(*args)
    live = np.asarray(lengths) > 0
    np.testing.assert_allclose(got[live], want[live], **TOL)
    assert np.all(want[~live] == 0.0)
    assert np.all(got[~live] == 0.0)


def test_plain_incremental_growth_matches_jax():
    """Token-by-token growth across two page boundaries: after writing
    position t, both packages decode with seq_len t + 1 from the same
    pool and agree."""
    L, h, h_kv, d, page = 21, 2, 2, 16, 8
    rng = np.random.RandomState(5)
    q_all = rng.randn(L, h, d).astype(np.float32)
    k_all = rng.randn(L, h_kv, d).astype(np.float32)
    v_all = rng.randn(L, h_kv, d).astype(np.float32)
    pool = PagePool(pages_needed(L, page) + 1)
    sp = SequencePages(page)
    kp = np.zeros((pool.num_pages + 1, page, h_kv, d), np.float32)
    vp = np.zeros_like(kp)
    for t in range(L):
        sp.ensure(t + 1, pool)
        kp[sp.pages[t // page], t % page] = k_all[t]
        vp[sp.pages[t // page], t % page] = v_all[t]
        table = np.zeros((1, pages_needed(L, page)), np.int32)
        table[0, : len(sp.pages)] = sp.pages
        args = (q_all[t][None], kp, vp, table, np.asarray([t + 1], np.int32))
        np.testing.assert_allclose(_port(*args), _jax_ref(*args), **TOL)


def test_plain_matches_contiguous_softmax():
    """Independent of both packages' paging: each row equals softmax
    attention over the sequence's K/V laid out contiguously."""
    q, k, v, table, lens = _paged(RAGGED, PAGE, 4, 2, 16, seed=7, scramble=True)
    out = _port(q, k, v, table, lens)
    for i, L in enumerate(RAGGED):
        ks = k[table[i]].reshape(-1, 2, 16)[:L]
        vs = v[table[i]].reshape(-1, 2, 16)[:L]
        for head in range(4):
            s = ks[:, head // 2] @ q[i, head] / 4.0
            p = np.exp(s - s.max())
            np.testing.assert_allclose(out[i, head], (p / p.sum()) @ vs[:, head // 2], **TOL)


def test_prefill_style_shared_row():
    """The prefill call's table: one row broadcast to C rows (stride 0),
    lengths pos + 1 and padded rows at 0 — the port matches JAX's
    reference on the live rows and gives zeros on the padded ones."""
    q, k, v, table, _ = _paged([20], PAGE, 4, 2, 16, seed=9, stale=50.0)
    c = 8
    lens = np.asarray([13 + i if i < 6 else 0 for i in range(c)], np.int32)
    qc = np.random.RandomState(10).randn(c, 4, 16).astype(np.float32)
    tc = np.broadcast_to(table, (c, table.shape[1]))
    got = tfa.flash_attention_decode(
        torch.from_numpy(qc), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(table[0]).expand(c, -1), torch.from_numpy(lens)).numpy()
    want = _jax_ref(qc, k, v, np.ascontiguousarray(tc), lens)
    np.testing.assert_allclose(got[:6], want[:6], **TOL)
    assert np.all(got[6:] == 0.0)


@pytest.mark.parametrize("splits", [1, 2, 3, 5, 64])
def test_split_reference_matches_jax(splits):
    """The kernel's split-and-merge arithmetic (paged_decode_split_reference)
    against JAX's one-pass reference, f32: runs from one page to all of a
    row's pages, run ends on and off page and split boundaries, large
    stale values in every unwritten slot, seq_len == 0 rows (exact zeros,
    as from the one-pass port) and, at 64 splits, more splits than live
    pages."""
    lengths = [0, 1, 8, 9, 23, 40, 0, 57]
    args = _paged(lengths, PAGE, 8, 2, 16, seed=21, scramble=True, stale=1e4)
    got = tfa.paged_decode_split_reference(*(torch.from_numpy(a) for a in args), splits).numpy()
    want = _jax_ref(*args)
    live = args[4] > 0
    np.testing.assert_allclose(got[live], want[live], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, _port(*args), atol=1e-5, rtol=1e-5)
    assert np.all(got[~live] == 0.0)


def test_decode_splits_from_shapes():
    """The kernel's split count comes from the shapes alone: ~2 blocks an
    SM of an H100 SXM (132 SMs) at the serve shape, never more splits than
    table slots, at least one."""
    assert tfa.decode_splits(8, 4, 256, 2 * 132) == 9
    assert tfa.decode_splits(8, 4, 3, 2 * 132) == 3
    assert tfa.decode_splits(600, 1, 256, 2 * 132) == 1
    assert tfa.decode_splits(1, 1, 0, 2 * 132) == 1
    assert tfa.decode_splits(8, 4, 256, 2 * 114) == 8


@pytest.mark.parametrize("bad,match", [
    (dict(q_shape=(3, 4)), "decode shapes"),
    (dict(v_heads=1), "k/v pool mismatch"),
    (dict(h=3), "not a multiple"),
])
def test_argument_checks_match_jax(bad, match):
    h = bad.get("h", 4)
    q = np.zeros(bad.get("q_shape", (2, h, 8)), np.float32)
    k = np.zeros((4, 8, 2, 8), np.float32)
    v = np.zeros((4, 8, bad.get("v_heads", 2), 8), np.float32)
    table = np.zeros((2, 1), np.int32)
    lens = np.ones(2, np.int32)
    with pytest.raises(ValueError, match=match):
        jfa.flash_attention_decode(*(jnp.asarray(a) for a in (q, k, v, table, lens)))
    with pytest.raises(ValueError, match=match):
        _port(q, k, v, table, lens)


def _kernel_args(s=2, h=4, h_kv=2, d=16, page=8, p=3):
    return [
        torch.zeros(s, h, d), torch.zeros(5, page, h_kv, d),
        torch.zeros(5, page, h_kv, d), torch.zeros(s, p, dtype=torch.int32),
        torch.ones(s, dtype=torch.int32),
    ]


@pytest.mark.parametrize("d,page,g", [
    (d, page, g) for d in (16, 64, 128) for page in (8, 16) for g in (1, 2, 4, 8)
])
def test_kernel_limits_take_required_shapes(d, page, g):
    tfa._check_kernel_args(*_kernel_args(h=2 * g, d=d, page=page))


@pytest.mark.parametrize("edit,exc,match", [
    (lambda a: a.__setitem__(0, a[0].double()), TypeError, "float32"),
    (lambda a: a.__setitem__(1, a[1].half()), TypeError, "float32"),
    (lambda a: a.__setitem__(3, a[3].long()), TypeError, "int32"),
    (lambda a: a.__setitem__(4, a[4].long()), TypeError, "int32"),
    (lambda a: a.__setitem__(1, a[1].transpose(1, 2).contiguous().transpose(1, 2)),
     ValueError, "contiguous"),
    (lambda a: a.__setitem__(3, a[3].t().contiguous().t()), ValueError, "rows must be contiguous"),
    (lambda a: a.__setitem__(4, a[4][:1]), ValueError, "seq_lens"),
], ids=["q-f64", "k-f16", "table-i64", "lens-i64", "pool-strided", "table-colmajor",
        "lens-shape"])
def test_kernel_wrapper_refuses(edit, exc, match):
    args = _kernel_args()
    edit(args)
    with pytest.raises(exc, match=match):
        tfa._check_kernel_args(*args)


@pytest.mark.parametrize("kw,match", [
    (dict(d=18), "multiple of 4"),
    (dict(page=64), "page_size"),
    (dict(h=32, h_kv=2, d=128), "group"),
    (dict(d=256), "at most 128"),
])
def test_kernel_wrapper_refuses_sizes(kw, match):
    with pytest.raises(ValueError, match=match):
        tfa._check_kernel_args(*_kernel_args(**kw))


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel entry never computes on the CPU: the CPU path is the
    dispatcher's choice, by device, and the launch count stays put."""
    before = tfa.decode_launches
    with pytest.raises(ValueError, match="CUDA"):
        tfa.paged_decode_kernel(*_kernel_args())
    assert tfa.decode_launches == before
