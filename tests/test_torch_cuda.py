"""The port's hand-written kernels on the card. Every test here needs a
CUDA device (marker ``cuda``) and skips without one; the file imports no
JAX, so it runs on a GPU host that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import paged_case  # noqa: E402
from tf_operator_tpu_torch.models.transformer import init_transformer, preset  # noqa: E402
from tf_operator_tpu_torch.ops import flash_attention as fa  # noqa: E402
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
