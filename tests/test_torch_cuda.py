"""The port's hand-written kernels on the card. Every test here needs a
CUDA device (marker ``cuda``) and skips without one; the file imports no
JAX, so it runs on a GPU host that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import (  # noqa: E402
    DECODE_PLANTS,
    PARITY_GRAD_REL,
    PARITY_LOSS_ATOL,
    PARITY_MOE_METRIC_ATOL,
    FLASH_PLANTS,
    FLS_PLANTS,
    FLS_STATS_C,
    GMM_MIXED_MAP,
    GMM_PLANTS,
    build_plants,
    compare_flash,
    compare_fls,
    compare_gmm,
    compare_kernel,
    decode_planted,
    flash_case,
    flash_within,
    fls_case,
    fls_planted,
    gmm_case,
    gmm_limit,
    gmm_planted,
    gmm_within,
    leaves_with_names,
    paged_case,
    planted,
)
from tf_operator_tpu_torch.compat import tree_map  # noqa: E402
from tf_operator_tpu_torch.models.transformer import (  # noqa: E402
    init_transformer,
    lm_loss_and_metrics,
    preset,
)
from tf_operator_tpu_torch.ops import flash_attention as fa  # noqa: E402
from tf_operator_tpu_torch.ops import fused_linear_stats as fls  # noqa: E402
from tf_operator_tpu_torch.ops import grouped_matmul as gm  # noqa: E402
from tf_operator_tpu_torch.serve.engine import ServeConfig, ServeEngine  # noqa: E402
from tf_operator_tpu_torch.workloads.serve import synthesize_requests  # noqa: E402

pytestmark = pytest.mark.cuda

# f32 kernel vs f32 plain version: only the order of the sums differs.
ATOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("h,h_kv,d,page", [
    (16, 4, 128, 16), (16, 16, 128, 16), (8, 1, 64, 8), (4, 2, 16, 8),
])
def test_paged_decode_kernel_matches_plain(dev, h, h_kv, d, page):
    rng = np.random.RandomState(11)
    args = paged_case(rng, [0, 1, 5, 16, 23, 300, 1000], page, h, h_kv, d, dev)
    before = fa.decode_launches
    got = fa.flash_attention_decode(*args)
    want = fa.paged_decode_reference(*args)
    torch.cuda.synchronize()
    assert fa.decode_launches == before + 1
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    assert bool((got[args[4] == 0] == 0).all())


def test_paged_decode_kernel_shared_table_row(dev):
    """The prefill call's table: one row broadcast to C rows (stride 0)."""
    rng = np.random.RandomState(12)
    _, k, v, table, _ = paged_case(rng, [45], 16, 16, 4, 128, dev)
    c = 16
    q = torch.randn(c, 16, 128, device=dev)
    lens = torch.tensor([33 + i if i < 12 else 0 for i in range(c)],
                        dtype=torch.int32, device=dev)
    rows = table[0].expand(c, -1)
    got = fa.flash_attention_decode(q, k, v, rows, lens)
    want = fa.paged_decode_reference(q, k, v, rows, lens)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    assert bool((got[12:] == 0).all())


def test_paged_decode_kernel_refuses_unsupported(dev):
    rng = np.random.RandomState(13)
    q, k, v, table, lens = paged_case(rng, [5, 9], 8, 4, 2, 16, dev)
    with pytest.raises(TypeError, match="float32"):
        fa.flash_attention_decode(q.half(), k.half(), v.half(), table, lens)
    with pytest.raises(TypeError, match="int32"):
        fa.flash_attention_decode(q, k, v, table.long(), lens)


@pytest.mark.parametrize("page", [8, 16])
def test_paged_decode_kernel_split_edges(dev, page):
    """8 sequences x 8 kv heads over a 12-page table, 5 splits a walk.
    Live pages 10 and 5 end exactly on split boundaries (runs of 2 and 1,
    at a page end), 12 and 11 leave the last split empty, 6 (one position
    into its last page) leaves two empty, 3 gives more splits than live
    pages, 1 is a single page, 0 an empty row; the kernel against the
    plain version and the split-and-merge arithmetic."""
    s, h, h_kv, d = 8, 16, 8, 64
    lengths = [n * page // 8 for n in (80, 40, 96, 85, 3, 20, 0, 41)]
    args = paged_case(np.random.RandomState(14), lengths, page, h, h_kv, d, dev)
    assert args[3].shape[1] == 12
    got = fa.paged_decode_kernel(*args, splits=5)
    want = fa.paged_decode_reference(*args)
    split = fa.paged_decode_split_reference(*(a.cpu() for a in args), 5)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    torch.testing.assert_close(got.cpu(), split, atol=ATOL, rtol=0)
    assert bool((got[args[4] == 0] == 0).all())


@pytest.mark.parametrize("name", sorted(DECODE_PLANTS))
def test_decode_check_fails_on_planted_fault(dev, name):
    """A copy of the paged-decode source with one planted fault fails the
    comparison the real kernel passes (ragged GQA lengths, several splits
    a walk)."""
    lib = build_plants([name], DECODE_PLANTS)[name]
    args = paged_case(np.random.RandomState(15), [0, 1, 5, 16, 23, 300, 1000], 16, 16, 4, 128,
                      dev)
    err, zeros = compare_kernel(*args)
    assert err <= ATOL and zeros
    with decode_planted(lib):
        err, zeros = compare_kernel(*args)
    assert err > ATOL or not zeros, (name, err)


def test_tiny_engine_card_matches_cpu(dev):
    """The whole serving loop on the card and on the CPU from the same
    params: the same greedy streams, and the card ran the kernel once per
    layer of every step function call."""
    cfg = preset("tiny")
    params = init_transformer(cfg, torch.Generator().manual_seed(0), "cpu")
    scfg = ServeConfig(page_size=8, pool_pages=48, max_slots=3, prefill_chunk=8)
    wl = {"requests": 7, "seed": 3, "prompt_len": 6, "max_new_tokens": 6,
          "arrival_rate": 0.0}
    cpu = ServeEngine(cfg, params, scfg, "cpu").run(synthesize_requests(wl, cfg.vocab))
    before = fa.decode_launches
    card = ServeEngine(cfg, params, scfg, dev).run(synthesize_requests(wl, cfg.vocab))
    assert [r.tokens for r in card.requests] == [r.tokens for r in cpu.requests]
    assert card.free_pages_start == card.free_pages_end
    assert fa.decode_launches - before == cfg.n_layers * (
        card.prefill_chunks + card.decode_steps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t,h,h_kv,d,causal", [
    (2, 200, 16, 4, 128, True), (1, 128, 16, 16, 128, False), (2, 77, 4, 2, 64, True),
    (1, 33, 2, 1, 16, False), (2, 512, 12, 12, 64, False),  # the last: bert-base's heads
])
def test_flash_kernels_match_plain(dev, dtype, b, t, h, h_kv, d, causal):
    """K1-K3 against their plain versions: GQA and MHA, causal and not, t
    off the tile grid, a nonzero lse cotangent; each kernel launched once."""
    rng = np.random.RandomState(21)
    before = (fa.flash_fwd_launches, fa.flash_bwd_dq_launches, fa.flash_bwd_dkv_launches)
    errs = compare_flash(*flash_case(rng, b, t, h, h_kv, d, dtype, dev), causal)
    assert (fa.flash_fwd_launches, fa.flash_bwd_dq_launches,
            fa.flash_bwd_dkv_launches) == tuple(n + 1 for n in before)
    assert flash_within(errs), errs


@pytest.mark.parametrize("name", sorted(FLASH_PLANTS))
def test_flash_check_fails_on_planted_fault(dev, name):
    """A copy of a kernel with one planted fault (a key tile dropped for the
    last rows of o or dq, a causal mask off by one, a query tile dropped
    from dk/dv, the forward's q.k^T or p.v descriptors, the backward's
    score descriptors or its MN-major dS.K, dV or dK descriptors stepped
    wrong) fails the check that the real kernels pass, in both types."""
    lib = build_plants([name])[name]
    kind = FLASH_PLANTS[name][0]
    rng = np.random.RandomState(24)
    for dtype in (torch.bfloat16, torch.float32):
        args = flash_case(rng, 1, 256, 4, 2, 64, dtype, dev)
        assert flash_within(compare_flash(*args, True))
        with planted(lib, kind):
            errs = compare_flash(*args, True)
        assert not flash_within(errs), (name, dtype, errs)


def test_flash_attention_autograd_on_card(dev):
    """The public entry on CUDA tensors: value and grads (through o and lse)
    equal the plain versions' on the CPU, f32."""
    rng = np.random.RandomState(22)
    q, k, v, do, dlse = flash_case(rng, 2, 96, 8, 2, 64, torch.float32, "cpu")
    outs = {}
    for where in ("cpu", dev):
        leaves = [x.detach().to(where).requires_grad_(True) for x in (q, k, v)]
        o, lse = fa.flash_attention_lse(*leaves, causal=True)
        torch.autograd.backward((o, lse), (do.to(where), dlse.to(where)))
        outs[str(where)] = [x.detach().cpu() for x in (o, lse, *[a.grad for a in leaves])]
    for got, want in zip(outs[str(dev)], outs["cpu"]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def test_flash_kernel_refuses_unsupported(dev):
    rng = np.random.RandomState(23)
    q, k, v, do, dlse = flash_case(rng, 1, 32, 4, 2, 24, torch.float32, dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        fa.flash_fwd_kernel(q, k, v, True)
    q, k, v, do, dlse = flash_case(rng, 1, 32, 4, 2, 16, torch.float16, dev)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa.flash_attention(q, k, v, causal=True)
    q, k, v, do, dlse = flash_case(rng, 1, 32, 4, 2, 256, torch.float32, dev)
    with pytest.raises(ValueError, match="register tiles"):
        fa.flash_attention(q, k, v, causal=True)


# Every non-sentinel block belongs to expert 2: the longest walk a map of
# 16 blocks allows (13 blocks, 52 stages of the dw kernel's 4-stage ring).
GMM_ONE_EXPERT_MAP = (2, -1, 2, 2, 2, -1, 2, 2, 2, 2, 2, -1, 2, 2, 2, 2)
GMM_MAPS = {"mixed": (GMM_MIXED_MAP, (1, 3, 4)),
            "one_expert": (GMM_ONE_EXPERT_MAP, (0, 1, 3, 4, 5))}


def _mixed_case(dev, dtype, scaled, seed=31, k=264, n=200, block_map="mixed"):
    """Sentinel blocks and experts without blocks: by default (GMM_MIXED_MAP)
    experts 1, 3 and 4 without blocks and interleaved blocks of experts 0,
    2 and 5; widths off the tile grid."""
    blocks, empty = GMM_MAPS[block_map]
    be = torch.tensor(blocks, dtype=torch.int32, device=dev)
    gen = torch.Generator(dev).manual_seed(seed)
    return gmm_case(gen, be, k, n, 6, dtype, dev, scaled=scaled, empty=empty)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("scaled", [False, True], ids=["plain", "row_scale"])
@pytest.mark.parametrize("k,n", [(264, 200), (200, 264), (128, 384)])
@pytest.mark.parametrize("block_map", sorted(GMM_MAPS))
def test_gmm_kernels_match_plain(dev, dtype, scaled, k, n, block_map):
    """K5 or K6, K5 on w^T and K7a or K7b against their plain versions on
    ragged and sentinel block maps, one of them with every block in one
    expert (the dw ring wraps many times); sentinel rows of y and dx and
    the dw of experts without blocks exactly zero; each kernel launched as
    counted. (264, 200) and (200, 264) end inside a 64-deep box and a
    256-wide tile in both pairs of dimensions, where the mixed map puts
    another expert's weights right after each edge."""
    c = _mixed_case(dev, dtype, scaled, k=k, n=n, block_map=block_map)
    before = (gm.gmm_fwd_launches, gm.gmm_fwd_scaled_launches, gm.gmm_dw_launches,
              gm.gmm_dw_scaled_launches)
    errs = compare_gmm(c)
    after = (gm.gmm_fwd_launches, gm.gmm_fwd_scaled_launches, gm.gmm_dw_launches,
             gm.gmm_dw_scaled_launches)
    # (K5, K6, K7a, K7b): y, dx on w^T, dw
    want = (1, 1, 0, 1) if scaled else (2, 0, 1, 0)
    assert tuple(a - b for a, b in zip(after, before)) == want
    assert gmm_within(errs), errs
    y = gm.gmm_fwd_kernel(c["x"], c["w"], c["be"], c["s"], block_rows=256)
    dx = gm.gmm_fwd_kernel(c["dy"], c["w"], c["be"], block_rows=256, trans_w=True)
    dw = gm.gmm_dw_kernel(c["x"], c["dy"], c["be"], 6, c["s"], block_rows=256)
    rows = (c["be"] < 0).repeat_interleave(256)
    assert bool((y[rows] == 0).all())
    assert bool((dx[rows] == 0).all())
    assert all(bool((dw[e] == 0).all()) for e in c["empty"])


@pytest.mark.parametrize("name", sorted(GMM_PLANTS))
def test_gmm_check_fails_on_planted_fault(dev, name):
    """A copy of the grouped-matmul source with one planted fault (a
    sentinel block computed, a dw walk short of its last block, the
    neighbouring expert's weights, K7b's scale from the next row, the dw
    products stepping by columns, the forward's x descriptors stepping 16
    bytes, the dx form's weights read MN-major, K6's scale from the row
    beside) fails the check the real kernels pass, in both types."""
    lib = build_plants([name], GMM_PLANTS)[name]
    for dtype in (torch.bfloat16, torch.float32):
        cases = [_mixed_case(dev, dtype, scaled) for scaled in (False, True)]
        assert all(gmm_within(compare_gmm(c)) for c in cases)
        with gmm_planted(lib):
            errs = [compare_gmm(c) for c in cases]
        assert not all(gmm_within(e) for e in errs), (name, dtype, errs)


def test_gmm_autograd_on_card(dev):
    """The public gmm on CUDA tensors: value and grads (x, w, row_scale)
    equal the plain versions' on the CPU, f32, within gmm_check's f32
    limit (rms over each row of y and dx, each expert's dw, all of ds)."""
    rng = np.random.RandomState(32)
    be = torch.tensor([0, -1, 2, 0], dtype=torch.int32)
    x = torch.from_numpy(rng.randn(512, 64).astype(np.float32))
    w = torch.from_numpy((rng.randn(3, 64, 96) / 8).astype(np.float32))
    s = torch.from_numpy(rng.rand(512).astype(np.float32))
    g = torch.from_numpy(rng.randn(512, 96).astype(np.float32))
    outs = {}
    for where in ("cpu", dev):
        leaves = [a.detach().to(where).requires_grad_(True) for a in (x, w, s)]
        y = gm.gmm(leaves[0], leaves[1], be.to(where), row_scale=leaves[2], block_rows=128)
        y.backward(g.to(where))
        outs[str(where)] = [y.detach().cpu()] + [a.grad.cpu() for a in leaves]
    for name, got, want, dims in zip(("y", "dx", "dw", "ds"), outs[str(dev)], outs["cpu"],
                                     ((-1,), (-1,), (1, 2), (0,))):
        err = (got - want).abs()
        assert bool((err <= gmm_limit(want, torch.float32, dims)).all()), (name, float(err.max()))


def test_gmm_kernel_refuses_unsupported(dev):
    x = torch.zeros(256, 64, device=dev, dtype=torch.float16)
    w = torch.zeros(2, 64, 64, device=dev, dtype=torch.float16)
    be = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        gm.gmm(x, w, be, block_rows=128)
    with pytest.raises(ValueError, match="multiple of 128"):
        gm.gmm(x.float(), w.float(), torch.zeros(4, dtype=torch.int32, device=dev),
               block_rows=64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("prologue", [False, True], ids=["plain", "prologue"])
@pytest.mark.parametrize("m,k,n", [(1000, 72, 40), (640, 256, 128), (333, 8, 136)])
def test_fls_kernel_matches_plain(dev, dtype, prologue, m, k, n):
    """K8 against its plain version (chip_smoke.compare_fls): y, the column
    sums and sums of squares, on and off the tile grid; one launch."""
    gen = torch.Generator(dev).manual_seed(41)
    before = fls.fused_linear_stats_launches
    errs = compare_fls(*fls_case(gen, m, k, n, dtype, dev, prologue))
    assert fls.fused_linear_stats_launches == before + 1
    assert all(r <= 1.0 for _, r in errs.values()), errs


@pytest.mark.parametrize("name", sorted(FLS_PLANTS))
def test_fls_check_fails_on_planted_fault(dev, name):
    """A copy of K8 with one planted fault (a row tile left out of the
    statistics, statistics from the rounded y, the prologue's ReLU
    dropped, x's wgmma descriptors stepped wrong) fails the check the real
    kernel passes, in some case of both types with and without the
    prologue."""
    lib = build_plants([name], FLS_PLANTS)[name]
    gen = torch.Generator(dev).manual_seed(42)
    cases = [fls_case(gen, 1000, 72, 40, dtype, dev, prologue)
             for dtype in (torch.bfloat16, torch.float32) for prologue in (False, True)]
    assert all(r <= 1.0 for c in cases for _, r in compare_fls(*c).values())
    with fls_planted(lib):
        worst = max(r for c in cases for _, r in compare_fls(*c).values())
    assert worst > 10.0, (name, worst)


@pytest.mark.parametrize("prologue", [False, True], ids=["plain", "prologue"])
def test_fls_autograd_on_card(dev, prologue):
    """The public entry on CUDA tensors: y, the statistics and the grads of
    x, w (and a, b) equal the CPU's, f32: y within 1e-4; the statistics
    within FLS_STATS_C["f32"] eps of their magnitude sums; the grads (plain f32
    products on both) within 1e-4 of each one's largest magnitude."""
    rng = np.random.RandomState(43)
    x = torch.from_numpy(rng.randn(520, 64).astype(np.float32))
    w = torch.from_numpy((rng.randn(64, 96) / 8).astype(np.float32))
    a = torch.from_numpy((rng.rand(64) + 0.5).astype(np.float32))
    b = torch.from_numpy((rng.randn(64) * 0.5).astype(np.float32))
    cts = [torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in ((520, 96), (96,), (96,))]
    outs = {}
    for where in ("cpu", dev):
        leaves = [t.detach().to(where).requires_grad_(True) for t in (x, w, a, b)]
        y, s, q = fls.fused_linear_stats(leaves[0], leaves[1],
                                         (leaves[2], leaves[3]) if prologue else None)
        torch.autograd.backward((y, s, q), [c.to(where) for c in cts])
        outs[str(where)] = [t.detach().cpu() for t in (y, s, q)] + [
            t.grad.cpu() for t in leaves if t.grad is not None]
    cpu, card = outs["cpu"], outs[str(dev)]
    assert len(card) == len(cpu) == (7 if prologue else 5)
    torch.testing.assert_close(card[0], cpu[0], atol=1e-4, rtol=0)
    y32 = cpu[0]
    for got, want, mag in ((card[1], cpu[1], y32.abs().sum(0)),
                           (card[2], cpu[2], (y32 * y32).sum(0))):
        assert bool(((got - want).abs() <= FLS_STATS_C["f32"] * 2.0**-23 * mag + 1e-6).all())
    for got, want in zip(card[3:], cpu[3:]):
        torch.testing.assert_close(got, want, atol=1e-4 * float(want.abs().max()), rtol=0)


def test_fls_kernel_refuses_unsupported(dev):
    x = torch.zeros(256, 64, device=dev)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fls.fused_linear_stats(x.half(), torch.zeros(64, 32, device=dev, dtype=torch.float16))
    with pytest.raises(ValueError, match="multiples of 8"):
        fls.fused_linear_stats(torch.zeros(256, 60, device=dev), torch.zeros(60, 32, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        fls.fused_linear_stats(torch.zeros(64, 256, device=dev).t(),
                               torch.zeros(64, 32, device=dev))


def test_device_loader_stages_on_its_own_stream(dev):
    """DeviceLoader on the card: every batch arrives byte-equal to the host's,
    copied on the loader's stream (not the consumer's) through a ring of
    prefetch + 1 pinned buffer sets that is reused, not grown; close()
    while the stager is blocked leaves no copy in flight."""
    from tf_operator_tpu_torch.train.data import DeviceLoader

    rng = np.random.default_rng(0)
    host = [{"x": rng.standard_normal((64, 1024), dtype=np.float32),
             "y": rng.integers(0, 10, 64, dtype=np.int32)} for _ in range(8)]
    loader = DeviceLoader(iter(host), dev, prefetch=2)
    got = [{k: v.cpu().numpy() for k, v in b.items()} for b in loader]
    assert len(got) == 8
    for a, b in zip(host, got):
        assert all(a[k].tobytes() == b[k].tobytes() for k in a)
    stats = loader.stats()
    assert stats["copy_stream"] != stats["consumer_stream"]
    assert stats["consumer_stream"] == torch.cuda.current_stream(dev).stream_id
    assert len(loader._slots) == 3 and all(s[0][0].is_pinned() for s in loader._slots)
    assert stats["copy_device_ms"] is not None and stats["batch_bytes"] == 64 * 1024 * 4 + 256

    def endless():
        while True:
            yield host[0]

    loader = DeviceLoader(endless(), dev, prefetch=1)
    next(loader)
    loader.close()
    assert not loader._thread.is_alive() and loader.copy_stream.query()


@pytest.mark.parametrize("over", [
    {"preset": "tiny", "causal": False},  # the masked LM: K1-K3 non-causal
    {"preset": "tiny", "remat": "dots"},
    {"preset": "tiny", "remat": "save_qkv_mid_up"},
    {"preset": "tiny-moe", "moe_dispatch": "sort", "moe_top_k": 2, "capacity_factor": 0.5},
], ids=["mlm", "dots", "save_qkv_mid_up", "sort"])
def test_train_step_card_matches_cpu(dev, over):
    """One f32 loss and backward of a tiny model on the card (K1-K3) and on
    the CPU from the same params and tokens: the loss and metrics within
    train_parity's limits, each grad within PARITY_GRAD_REL of its
    largest; K1 2 a layer (the remat modes recompute it), K2 and K3 1."""
    name = over.pop("preset")
    cfg = preset(name, dtype=torch.float32, attn_impl="flash", **{"remat": "full", **over})
    params = init_transformer(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.RandomState(3).randint(0, cfg.vocab, (2, 64)))
    out = {}
    for where in ("cpu", dev):
        p = tree_map(lambda x: x.detach().to(where).requires_grad_(True), params)
        before = (fa.flash_fwd_launches, fa.flash_bwd_dq_launches, fa.flash_bwd_dkv_launches)
        loss, metrics = lm_loss_and_metrics(p, tokens.to(where), cfg)
        loss.backward()
        out[str(where)] = (float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()},
                           tree_map(lambda x: x.grad.cpu(), p))
    launches = (fa.flash_fwd_launches - before[0], fa.flash_bwd_dq_launches - before[1],
                fa.flash_bwd_dkv_launches - before[2])
    assert launches == (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
    (card_loss, card_m, card_g), (cpu_loss, cpu_m, cpu_g) = out[str(dev)], out["cpu"]
    assert abs(card_loss - cpu_loss) <= PARITY_LOSS_ATOL
    for k in card_m:
        assert abs(card_m[k] - cpu_m[k]) <= PARITY_MOE_METRIC_ATOL, (k, card_m, cpu_m)
    for (k, g), (_, w) in zip(leaves_with_names(card_g), leaves_with_names(cpu_g)):
        err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        assert err <= PARITY_GRAD_REL, (k, err)


def test_nccl_group_of_one_sharded_step_equals_unsharded(dev):
    """Three AdamW steps of tiny LM (bf16, flash, save_mid) through the
    sharded trainer as an NCCL group of one, mesh {"fsdp": 1, "tp": 1},
    and through the unsharded trainer from the same params and tokens:
    every collective is on an axis of size 1, so the losses are bitwise
    equal, and K1-K3 run as often on both paths."""
    import socket
    from datetime import timedelta

    import torch.distributed as dist

    from tf_operator_tpu_torch.models.transformer import lm_loss, transformer_logical_axes
    from tf_operator_tpu_torch.parallel.mesh import build_mesh
    from tf_operator_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = preset("tiny", attn_impl="flash", remat="save_mid")
    params = init_transformer(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.RandomState(3).randint(0, cfg.vocab, (4, 64))).to(dev)

    def train(mesh):
        trainer = Trainer(lambda p, b, e: lm_loss(p, b, cfg, mesh=mesh), None,
                          TrainerConfig(learning_rate=3e-3), device=dev, mesh=mesh,
                          logical_axes=transformer_logical_axes(cfg))
        state = trainer.state_from_params(tree_map(lambda x: x.clone().to(dev), params))
        before = fa.flash_fwd_launches
        losses = []
        for _ in range(3):
            state, m = trainer.step(state, tokens)
            losses.append(float(m["loss"]))
        return losses, fa.flash_fwd_launches - before

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1, timeout=timedelta(seconds=60),
                            device_id=torch.device("cuda", 0))
    try:
        sharded = train(build_mesh({"fsdp": 1, "tp": 1}, ranks=[0], device_type="cuda"))
    finally:
        dist.destroy_process_group()
    plain = train(None)
    assert sharded == plain and sharded[1] == 2 * cfg.n_layers * 3
