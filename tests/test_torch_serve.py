"""The port's serving path against the JAX package's, on the CPU at the
``tiny`` preset: both engines from the same params serve the same
synthetic requests to the same token streams in both scheduling modes;
a prefill chunk's logits match the JAX full forward; the workload entry
runs under a real JobContext; and the port's page bookkeeping."""

import logging

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tf_operator_tpu.models import transformer as jt  # noqa: E402
from tf_operator_tpu.rendezvous.context import JobContext  # noqa: E402
from tf_operator_tpu.serve import engine as je  # noqa: E402
from tf_operator_tpu.workloads import serve as jws  # noqa: E402
from tf_operator_tpu_torch.compat import params_from_numpy  # noqa: E402
from tf_operator_tpu_torch.models import transformer as tt  # noqa: E402
from tf_operator_tpu_torch.serve import engine as te  # noqa: E402
from tf_operator_tpu_torch.serve import kvcache as tkv  # noqa: E402
from tf_operator_tpu_torch.workloads import serve as tws  # noqa: E402

torch.set_num_threads(1)

WL = {"requests": 7, "seed": 3, "prompt_len": 6, "max_new_tokens": 6,
      "arrival_rate": 0.0}


def _fake_clock(dt=0.001):
    """Deterministic clock (as tests/test_serve.py): admission order
    cannot depend on host speed."""
    t = [0.0]

    def clock():
        t[0] += dt
        return t[0]

    return clock


@pytest.fixture(scope="module")
def jax_params():
    return jt.init_transformer(jax.random.PRNGKey(0), jt.preset("tiny"))


@pytest.fixture(scope="module")
def engines(jax_params):
    np_params = jax.tree_util.tree_map(np.asarray, jax_params)
    jscfg = je.ServeConfig(page_size=8, pool_pages=48, max_slots=3, prefill_chunk=8)
    tscfg = te.ServeConfig(page_size=8, pool_pages=48, max_slots=3, prefill_chunk=8)
    return (je.ServeEngine(jt.preset("tiny"), jax_params, jscfg),
            te.ServeEngine(tt.preset("tiny"), params_from_numpy(np_params, "cpu"),
                           tscfg, "cpu"))


def test_synthesize_requests_identical():
    wl = {"requests": 9, "seed": 5, "prompt_len": 12, "max_new_tokens": 7,
          "arrival_rate": 20.0}
    a, b = jws.synthesize_requests(wl, 256), tws.synthesize_requests(wl, 256)
    assert [(r.rid, r.prompt, r.max_new, r.arrival) for r in a] == \
        [(r.rid, r.prompt, r.max_new, r.arrival) for r in b]


@pytest.mark.serve
@pytest.mark.parametrize("mode", ["continuous", "static"])
def test_engine_token_streams_match_jax(engines, mode):
    jeng, teng = engines
    a = jeng.run(jws.synthesize_requests(WL, 256), mode=mode, clock=_fake_clock())
    b = teng.run(tws.synthesize_requests(WL, 256), mode=mode, clock=_fake_clock())
    assert [r.tokens for r in b.requests] == [r.tokens for r in a.requests]
    assert b.steps == a.steps
    assert b.completed == len(b.requests) == a.completed
    assert b.free_pages_start == b.free_pages_end
    assert b.generated_tokens == a.generated_tokens
    for ra, rb in zip(a.requests, b.requests):
        assert (rb.admitted, rb.first_token, rb.finished) == \
            pytest.approx((ra.admitted, ra.first_token, ra.finished))
    # every step function call ran the paged attention once per layer
    prompts = [len(r.prompt) for r in b.requests]
    assert b.prefill_chunks == sum(-(-n // 8) for n in prompts)
    assert b.decode_steps > 0


@pytest.mark.serve
def test_engine_reserve_on_demand_matches_jax(jax_params):
    """Pages grown on demand (reserve_full=False) and one admission per
    step: the table updates mid-sequence, and streams still agree."""
    np_params = jax.tree_util.tree_map(np.asarray, jax_params)
    kw = dict(page_size=4, pool_pages=40, max_slots=2, prefill_chunk=4,
              reserve_full=False, max_admit_per_step=1)
    jeng = je.ServeEngine(jt.preset("tiny"), jax_params, je.ServeConfig(**kw))
    teng = te.ServeEngine(tt.preset("tiny"), params_from_numpy(np_params, "cpu"),
                          te.ServeConfig(**kw), "cpu")
    wl = dict(WL, requests=5, seed=8)
    a = jeng.run(jws.synthesize_requests(wl, 256), clock=_fake_clock())
    b = teng.run(tws.synthesize_requests(wl, 256), clock=_fake_clock())
    assert [r.tokens for r in b.requests] == [r.tokens for r in a.requests]
    assert b.free_pages_start == b.free_pages_end


def test_prefill_logits_match_jax_forward(jax_params):
    """A prompt pushed through the port's prefill_chunk, chunk by chunk,
    gives at its last position the logits of the JAX full forward (f32
    config, dense attention) over the whole prompt."""
    cfg_j = jt.preset("tiny", dtype=jnp.float32, attn_impl="dense")
    cfg_t = tt.preset("tiny")
    rng = np.random.RandomState(4)
    prompt = rng.randint(1, cfg_t.vocab, size=21).astype(np.int32)
    want = np.asarray(jt.transformer_forward(jax_params, jnp.asarray(prompt[None]),
                                             cfg_j))[0]
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params), "cpu")
    eng = te.ServeEngine(cfg_t, params, te.ServeConfig(page_size=4, pool_pages=16,
                                                       prefill_chunk=8), "cpu")
    kp, vp = eng.fresh_pools()
    pool = tkv.PagePool(16)
    sp = tkv.SequencePages(4)
    sp.ensure(len(prompt), pool)
    row = torch.full((eng.max_pages_per_seq,), pool.trash_page - 1, dtype=torch.int32)
    row[: len(sp.pages)] = torch.tensor(sp.pages)
    for start in range(0, len(prompt), 8):
        chunk = prompt[start: start + 8]
        buf = torch.zeros(8, dtype=torch.int64)
        buf[: len(chunk)] = torch.from_numpy(chunk.astype(np.int64))
        tok, logits = te.prefill_chunk(cfg_t, eng.params, kp, vp, row, start, buf,
                                       len(chunk))
        np.testing.assert_allclose(logits.numpy(), want[start + len(chunk) - 1],
                                   atol=1e-4, rtol=1e-4)
        assert int(tok) == int(np.argmax(want[start + len(chunk) - 1]))
    # one decode step on top: position 21 attends over the written cache
    nxt = int(tok)
    table = row[None]
    _, dlog = te.decode_step(cfg_t, eng.params, kp, vp, table,
                             torch.tensor([len(prompt)]), torch.tensor([nxt]),
                             torch.tensor([True]))
    full = np.concatenate([prompt, [nxt]]).astype(np.int32)
    want2 = np.asarray(jt.transformer_forward(jax_params, jnp.asarray(full[None]),
                                              cfg_j))[0, -1]
    np.testing.assert_allclose(dlog[0].numpy(), want2, atol=1e-4, rtol=1e-4)


def test_decode_step_inactive_rows_stay_finite(engines):
    """Inactive slots write to the trash page and attend with length 0:
    their rows are finite (zeros from the attention), and the active
    row's logits do not depend on them."""
    _, teng = engines
    cfg = teng.cfg
    kp, vp = teng.fresh_pools()
    table = torch.zeros((3, teng.max_pages_per_seq), dtype=torch.int32)
    table[:, 0] = torch.tensor([0, 1, 2], dtype=torch.int32)
    args = (torch.tensor([5, 3, 7]), torch.tensor([5, 9, 11]))  # seq_lens, tokens
    _, lg_one = te.decode_step(cfg, teng.params, kp, vp, table, *args,
                               torch.tensor([True, False, False]))
    assert torch.isfinite(lg_one).all()
    kp2, vp2 = teng.fresh_pools()
    _, lg_all = te.decode_step(cfg, teng.params, kp2, vp2, table, *args,
                               torch.tensor([True, True, True]))
    torch.testing.assert_close(lg_one[0], lg_all[0], atol=0, rtol=0)
    # inactive writes went to the trash page only
    assert kp[:, 1:teng.scfg.pool_pages].abs().sum() == 0
    assert kp[:, teng.scfg.pool_pages].abs().sum() > 0


def test_engine_rejects_what_jax_rejects():
    params = tt.init_transformer(tt.preset("tiny"), torch.Generator().manual_seed(0), "cpu")
    eng = te.ServeEngine(tt.preset("tiny"), params,
                         te.ServeConfig(page_size=8, pool_pages=2, max_slots=1), "cpu")
    with pytest.raises(ValueError, match="empty prompt"):
        eng.run([te.Request(rid=0, prompt=[], max_new=1)])
    with pytest.raises(ValueError, match="exceeds max_seq"):
        eng.run([te.Request(rid=0, prompt=[1] * 100, max_new=100)])
    with pytest.raises(ValueError, match="never be admitted"):
        eng.run([te.Request(rid=0, prompt=[1] * 30, max_new=8)])
    with pytest.raises(ValueError, match="MoE"):
        te.ServeEngine(tt.preset("tiny-moe"), params, te.ServeConfig(), "cpu")
    with pytest.raises(ValueError, match="kv_page_size"):
        te.ServeEngine(tt.preset("tiny"), params, te.ServeConfig(page_size=0), "cpu")


class _SpyContext(JobContext):
    """A real JobContext whose reporting hooks also keep what they got
    (no API server here, so the real hooks record nothing)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.spans, self.metrics, self.first = [], [], []

    def record_span(self, op, start, end, attrs=None, name=None):
        self.spans.append((op, start, end, name))
        return super().record_span(op, start, end, attrs=attrs, name=name)

    def report_eval_metrics(self, step, metrics):
        self.metrics.append((step, metrics))
        return super().report_eval_metrics(step, metrics)

    def mark_first_step(self, step=0):
        self.first.append(step)
        return super().mark_first_step(step)


def test_workload_main_runs_on_cpu_under_job_context(caplog):
    wl = {"preset": "tiny", "requests": 4, "prompt_len": 5, "max_new_tokens": 3,
          "arrival_rate": 0, "kv_page_size": 8, "kv_pool_pages": 32,
          "max_slots": 2, "prefill_chunk": 8, "seed": 1, "device": "cpu",
          "report_every": 1}
    ctx = _SpyContext(job_name="serve-port", trace_id="abcdef0123", workload=wl)
    with caplog.at_level(logging.INFO, logger="tpujob.serve"):
        tws.main(ctx)
    assert "requests=4/4" in caplog.text and "device=cpu" in caplog.text
    assert ctx.first == [0]
    req_spans = [s for s in ctx.spans
                 if s[0] in ("request-admitted", "first-token", "finished")]
    ops = [s[0] for s in req_spans]
    assert ops.count("request-admitted") == ops.count("first-token") == 4
    assert ops.count("finished") == 4
    assert all(s[3].startswith("serve-port-abcdef01-req") for s in req_spans)
    step, final = ctx.metrics[-1]
    assert final["requests_completed"] == 4.0 and final["tokens_per_s"] > 0
    # a non-zero rank holds its slot and serves nothing
    idle = _SpyContext(job_name="serve-port", workload=wl, process_id=1)
    tws.main(idle)
    assert idle.spans == idle.metrics == []


def test_run_serve_counts_one_attention_per_layer_and_call(monkeypatch):
    wl = {"preset": "tiny", "requests": 3, "prompt_len": 10, "max_new_tokens": 4,
          "arrival_rate": 0, "kv_page_size": 8, "kv_pool_pages": 32,
          "max_slots": 2, "prefill_chunk": 8, "seed": 2}
    calls = []
    real = te.flash_attention_decode
    monkeypatch.setattr(te, "flash_attention_decode",
                        lambda *a: calls.append(1) or real(*a))
    eng, res = tws.run_serve(wl, device="cpu")
    assert res.completed == 3
    assert len(calls) == eng.cfg.n_layers * (res.prefill_chunks + res.decode_steps)


# ---- the port's page bookkeeping ------------------------------------------


def test_pages_needed_and_pool_bytes():
    assert [tkv.pages_needed(n, 8) for n in (0, 1, 8, 9)] == [1, 1, 1, 2]
    # gqa-2048 at the smoke's pool: 12 layers x 257 pages x 16 x 4 x 128, f32, K and V
    assert tkv.pool_bytes(12, 256, 16, 4, 128) == 2 * 12 * 257 * 16 * 4 * 128 * 4


def test_pool_alloc_free_and_exhaustion():
    pool = tkv.PagePool(4)
    a = pool.alloc(3)
    assert a == [0, 1, 2] and pool.free_count == 1 and pool.trash_page == 4
    with pytest.raises(tkv.PoolExhausted):
        pool.alloc(2)
    assert pool.free_count == 1  # all or nothing
    pool.free(a)
    assert pool.free_count == 4
    with pytest.raises(ValueError, match="double free"):
        pool.free([0])
    with pytest.raises(ValueError, match="outside pool"):
        pool.free([4])
    sp = tkv.SequencePages(4)
    sp.ensure(9, pool)
    assert len(sp.pages) == 3 and sp.capacity == 12
    sp.release(pool)
    assert pool.free_count == 4 and sp.pages == []
