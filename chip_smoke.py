#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
and check them.

Usage, from the root of a checkout, on a host with one CUDA card:

    python3 chip_smoke.py

Builds the port's CUDA kernels from the checkout's sources, then prints
one JSON line per phase. Serving path:

1. ``device``: the card's name and power limit (nvidia-smi) and the
   kernels' build time and registers.
2. ``kernel_check``: the paged-decode kernel against its plain PyTorch
   version on the card (GQA and MHA at gqa-2048's head shape, ragged
   lengths with empty rows, scrambled page ids, large finite garbage in
   stale positions; a sweep of the supported head_dim/page/group sizes;
   a prefill-style table with a row stride of 0).
3. ``serve``: the ``gqa-2048`` preset at full width and depth, through
   ``run_serve``: 16 requests, every one completed, zero page leaks, and
   exactly n_layers launches of the kernel per prefill chunk and decode
   step. Tokens/s, TTFT and inter-token latency.
4. ``whole_path``: the same weights on the card and on the CPU, two
   prompts teacher-forced through ``prefill_chunk`` and ``decode_step``;
   logits within tolerance and equal greedy tokens.
5. ``breakdown``: one full-width decode step and one prefill chunk on
   the host clock and under ``torch.profiler``: device busy time, idle
   share and the costliest kernels.
6. ``kernel_timing``: the kernel, its plain version and
   ``scaled_dot_product_attention`` at the decode shapes of phase 3,
   beside the bytes bound.

Training path:

7. ``flash_check``: the flash forward, dQ and dK/dV kernels against their
   plain versions, element by element (gqa-2048's heads and MHA, causal
   and not, t of 128, 200 and 2048, f32 and bf16, a nonzero lse
   cotangent).
8. ``flash_plant``: copies of the flash sources, each with one planted
   fault (a key tile dropped for the last rows, a causal mask off by
   one, a query tile dropped from dK/dV), built and run at t 2048: the
   check of phase 7 must fail on each.
9. ``train``: ``gqa-2048`` at full width and depth (b 6, t 2048, flash
   attention, save_mid remat, bf16, AdamW), one warmup and 8 timed steps
   through ``run_lm``: exactly 2·L forward and L of each backward kernel
   launch per step, finite and falling loss; step time, tokens/s, MFU and
   peak memory.
10. ``train_breakdown``: training steps on the host clock and under
    ``torch.profiler``: device busy, idle share, top kernels.
11. ``train_parity``: gqa-2048 width at 2 layers, t 256: f32 loss and
    grads on the card against the CPU, and 3 bf16 steps with the kernels
    against 3 with the plain versions.
12. ``flash_timing``: the three kernels at the train shape beside their
    bounds, their plain versions and SDPA (forward, and the backward
    that computes dq, dk and dv in one call).

Then the ``kernels`` line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises: the script
then exits non-zero and prints no result. Without a CUDA device it exits
1 at once.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch

from tf_operator_tpu_torch.compat import tree_map
from tf_operator_tpu_torch.device import resolve_device
from tf_operator_tpu_torch.models.transformer import (
    init_transformer,
    lm_loss,
    preset_from_workload,
)
from tf_operator_tpu_torch.ops import _build
from tf_operator_tpu_torch.ops import flash_attention as fa
from tf_operator_tpu_torch.serve.engine import (
    ServeConfig,
    ServeEngine,
    decode_step,
    prefill_chunk,
)
from tf_operator_tpu_torch.serve.kvcache import PagePool, SequencePages, pages_needed
from tf_operator_tpu_torch.train.trainer import Trainer, TrainerConfig
from tf_operator_tpu_torch.workloads.lm import fixed_tokens, run_lm
from tf_operator_tpu_torch.workloads.serve import _quantile, run_serve, synthesize_requests

SERVE_WL = {
    "preset": "gqa-2048", "requests": 16, "prompt_len": 128,
    "max_new_tokens": 64, "arrival_rate": 0, "kv_page_size": 16,
    "kv_pool_pages": 256, "max_slots": 8, "prefill_chunk": 16, "seed": 0,
}
# The repo's north-star training job (examples/gqa_2048_northstar.json) at
# full width and depth, 1 warmup + 8 timed steps, random weights (seed 0).
TRAIN_WL = {
    "preset": "gqa-2048", "steps": 8, "batch_size": 6, "seq_len": 2048,
    "attn": "flash", "remat": "save_mid", "lr": 3e-4, "data": "fixed",
}
# f32 kernel vs f32 plain version on the same inputs: only the order of
# the sums differs, which moves results by a few f32 ulps of O(1) values.
KERNEL_ATOL = 1e-5
# Card vs CPU logits of the whole 12-layer model: both f32 (TF32 off), but
# cuBLAS and the CPU's BLAS sum in different orders, and those ~1e-7
# relative differences compound through 12 residual layers and a
# 32000-wide tied head. Logits are O(1); 1e-3 is ~100x the expected gap
# and far below what a wrong page, mask or rotation gives (O(0.1)).
LOGITS_ATOL = 1e-3
# Flash kernels vs their plain versions (in f32 on the same inputs), held
# element by element. The kernels take bf16 and f32 through the same code;
# f32 operands are split into bf16 hi + lo and multiplied as three
# products, which leaves ~2^-17 relative per product plus the tensor
# cores' truncated sums; at t = 2048 the f32 results (o, dq, dk, dv of
# magnitude <= ~2) came out up to 6.7e-5 off on an H100: the f32 limit is
# 1e-4 absolute. lse is f32 from f32 accumulators for both types (exact
# bf16 products, sums in another order, exp2/log ulps): 1e-4 absolute on
# values ~8. bf16 o, dq, dk, dv are rounded to bf16 (2^-9 relative) and
# built from P or dS rounded to bf16: the limit is 2^-7 |plain| + 2^-6
# rms(plain row over d), which the worst element reached to 0.66 on an
# H100. A key tile dropped for the last rows at t = 2048 moves lse by a
# few hundredths and o, dq by ~10% of the row's rms; phase flash_plant
# builds such faults and checks that they fail.
FLASH_F32_ATOL = 1e-4
FLASH_LSE_ATOL = 1e-4
FLASH_BF16_RTOL = 2.0**-7
FLASH_BF16_ROW_ATOL = 2.0**-6
# train_parity, f32 card (flash kernels, cuBLAS) vs CPU (plain versions,
# CPU BLAS) at gqa-2048 width, 2 layers, 512 tokens: the same math summed
# in other orders, ~1e-6 relative per product (~2^-17 in the flash
# kernels' split products); through two layers, the 32000-wide tied head
# and the backward that stays ~1e-5. Loss (~10.4)
# within 1e-4; each param's grad within 1e-3 of its largest magnitude,
# far below what a wrong mask, tile or group map gives (O(1)).
PARITY_LOSS_ATOL = 1e-4
PARITY_GRAD_REL = 1e-3
# bf16 steps with the kernels vs with the plain versions on the same card
# tensors: the kernels round P and dS to bf16 and sum in tile order, which
# moves each attention output by ~2^-9 relative; the loss (~10.4) moves
# by ~1e-3 through two layers and three updates. Limit 2e-2 (0.2%).
PARITY_BF16_LOSS_ATOL = 2e-2
# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32
# (non-tensor-core) and bf16 (tensor-core, dense) operations/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12  # dense, tensor cores


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# launch counts
# ---------------------------------------------------------------------------

COUNTERS = ("decode_launches", "flash_fwd_launches", "flash_bwd_dq_launches",
            "flash_bwd_dkv_launches")


def reset_counts() -> None:
    for name in COUNTERS:
        setattr(fa, name, 0)


def read_counts() -> dict:
    return {name: getattr(fa, name) for name in COUNTERS}


# ---------------------------------------------------------------------------
# paged inputs
# ---------------------------------------------------------------------------


def paged_case(rng, lengths, page, h, h_kv, d, dev, garbage=1e6):
    """A pool whose every slot holds large finite garbage, live prefixes
    written at scrambled page ids, table rows padded with a real page id
    (as the engine pads), and one query per sequence."""
    n_live = [pages_needed(L, page) if L else 0 for L in lengths]
    num_pages = sum(n_live) + 2
    ids = rng.permutation(num_pages)
    k = rng.uniform(-garbage, garbage, (num_pages + 1, page, h_kv, d)).astype(np.float32)
    v = rng.uniform(-garbage, garbage, (num_pages + 1, page, h_kv, d)).astype(np.float32)
    width = max(max(n_live), 1)
    table = np.full((len(lengths), width), num_pages - 1, np.int32)
    nxt = 0
    for i, L in enumerate(lengths):
        pages = ids[nxt: nxt + n_live[i]]
        nxt += n_live[i]
        table[i, : len(pages)] = pages
        for t in range(L):
            k[pages[t // page], t % page] = rng.randn(h_kv, d)
            v[pages[t // page], t % page] = rng.randn(h_kv, d)
    q = rng.randn(len(lengths), h, d).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return to(q), to(k), to(v), to(table), to(np.asarray(lengths, np.int32))


def compare_kernel(q, k, v, table, lens):
    """Kernel vs plain version on the same card tensors: max abs error,
    and whether every seq_len == 0 row is exactly zero."""
    got = fa.paged_decode_kernel(q, k, v, table, lens)
    want = fa.paged_decode_reference(q, k, v, table, lens)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "kernel output not finite")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    zero_rows = lens == 0
    zeros_exact = bool((got[zero_rows] == 0).all())
    return err, zeros_exact


def flash_case(rng, b, t, h, h_kv, d, dtype, dev):
    """Inputs of one flash-attention call: q, k, v and the cotangents do and
    dlse (nonzero), drawn with numpy and cast to ``dtype`` on ``dev``."""
    def draw(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)
    q, k, v = draw(b, t, h, d), draw(b, t, h_kv, d), draw(b, t, h_kv, d)
    do, dlse = draw(b, t, h, d), draw(b, t, h, scale=0.1)
    return [x.to(dtype) for x in (q, k, v, do)] + [dlse]


def flash_limit(name, want, dtype):
    """Elementwise limit on |kernel - plain| for output ``name`` (see
    FLASH_* above); ``want`` is the f32 plain result."""
    if name == "lse":
        return torch.full_like(want, FLASH_LSE_ATOL)
    if dtype == torch.float32:
        return torch.full_like(want, FLASH_F32_ATOL)
    row_rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
    return FLASH_BF16_RTOL * want.abs() + FLASH_BF16_ROW_ATOL * row_rms


def compare_flash(q, k, v, do, dlse, causal):
    """The three flash kernels against their plain versions on the same
    card tensors, the plain versions in f32. Returns {name: (max abs err,
    largest err / limit)} for o, lse, dq, dk, dv: the check passes where
    every ratio is at most 1."""
    o, lse = fa.flash_fwd_kernel(q, k, v, causal)
    f32 = [x.float() for x in (q, k, v, do)]
    o_ref, lse_ref = fa.flash_fwd_reference(f32[0], f32[1], f32[2], causal)
    # both backward kernels see the same (o, lse, delta) as their plain
    # versions: the kernel's own forward outputs
    lse_k, delta = fa.lse_kernel_layout(lse), fa.flash_delta(o, do, dlse)
    dq = fa.flash_bwd_dq_kernel(q, k, v, do, lse_k, delta, causal)
    dk, dv = fa.flash_bwd_dkv_kernel(q, k, v, do, lse_k, delta, causal)
    dq_ref = fa.flash_bwd_dq_reference(*f32, lse_k, delta, causal)
    dk_ref, dv_ref = fa.flash_bwd_dkv_reference(*f32, lse_k, delta, causal)
    torch.cuda.synchronize()
    out = {}
    for name, got, want in (("o", o, o_ref), ("lse", lse, lse_ref), ("dq", dq, dq_ref),
                            ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
        check(bool(torch.isfinite(got).all()), f"flash {name} not finite")
        err = (got.float() - want).abs()
        out[name] = (float(err.max()), float((err / flash_limit(name, want, q.dtype)).max()))
    return out


def flash_within(errs) -> bool:
    """Every element of every output within its limit (flash_limit)."""
    return all(ratio <= 1.0 for _, ratio in errs.values())


def phase_kernel_check(dev):
    rng = np.random.RandomState(0)
    cases = []
    lengths = [0, 1, 5, 16, 23, 300, 1000]
    for name, h, h_kv in (("gqa", 16, 4), ("mha", 16, 16)):
        cases.append((name, paged_case(rng, lengths, 16, h, h_kv, 128, dev)))
    for d in (16, 64, 128):
        for page in (8, 16):
            for g in (1, 2, 4, 8):
                cases.append((f"d{d}-p{page}-g{g}",
                              paged_case(rng, [0, 1, 7, 8, 9, 33], page, 2 * g, 2, d, dev)))
    # prefill: C rows share one table row (row stride 0), lengths pos+1,
    # padded rows at length 0
    q, k, v, table, _ = paged_case(rng, [45], 16, 16, 4, 128, dev)
    c = 16
    q = torch.randn(c, 16, 128, device=dev, generator=torch.Generator(dev).manual_seed(1))
    lens = torch.tensor([33 + i if i < 12 else 0 for i in range(c)], dtype=torch.int32, device=dev)
    cases.append(("prefill-stride0", (q, k, v, table[0].expand(c, -1), lens)))

    worst = 0.0
    out = {}
    for name, args in cases:
        err, zeros = compare_kernel(*args)
        check(err <= KERNEL_ATOL, f"kernel vs plain {name}: max abs err {err} > {KERNEL_ATOL}")
        check(zeros, f"kernel {name}: seq_len == 0 rows not exactly zero")
        out[name] = err
        worst = max(worst, err)
    emit({"phase": "kernel_check", "cases": len(cases), "atol": KERNEL_ATOL,
          "max_abs_err": worst, "gqa_err": out["gqa"], "mha_err": out["mha"],
          "prefill_stride0_err": out["prefill-stride0"], "zero_rows_exact": True})
    return worst


# ---------------------------------------------------------------------------
# full-width serve
# ---------------------------------------------------------------------------


def phase_serve(smi):
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    engine, res = run_serve(SERVE_WL, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["decode_launches"]
    check(counts["flash_fwd_launches"] == 0, "the serving path launched a flash kernel")
    cfg = engine.cfg
    check(res.completed == SERVE_WL["requests"],
          f"{res.completed}/{SERVE_WL['requests']} requests completed")
    check(res.free_pages_start == res.free_pages_end, "KV page leak")
    want = cfg.n_layers * (res.prefill_chunks + res.decode_steps)
    check(launches == want,
          f"decode_launches {launches} != n_layers x (chunks + steps) = {want}")
    for r in res.requests:
        check(1 <= len(r.tokens) <= r.max_new, f"request {r.rid}: {len(r.tokens)} tokens")
        check(all(0 <= t < cfg.vocab for t in r.tokens), f"request {r.rid}: token out of range")
    ttfts, itls = res.ttfts(), res.token_latencies()
    emit({
        "phase": "serve", "preset": SERVE_WL["preset"], "n_layers": cfg.n_layers,
        "d_model": cfg.d_model, "params": cfg.n_params(),
        "requests": len(res.requests), "completed": res.completed,
        "generated_tokens": res.generated_tokens, "steps": res.steps,
        "prefill_chunks": res.prefill_chunks, "decode_steps": res.decode_steps,
        "decode_launches": launches, "page_leaks": 0,
        "engine_wall_s": res.wall_s, "run_serve_wall_s": wall,
        "tokens_per_s": res.tokens_per_s,
        "ttft_p50_s": _quantile(ttfts, 0.50), "ttft_p99_s": _quantile(ttfts, 0.99),
        "itl_p50_s": _quantile(itls, 0.50), "itl_p99_s": _quantile(itls, 0.99),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "card": smi,
    })
    return engine, res, launches


# ---------------------------------------------------------------------------
# whole path: card vs CPU
# ---------------------------------------------------------------------------




def teacher_force(engine, prompts, n_decode, forced=None):
    """Prefill each prompt chunk by chunk, then ``n_decode`` batched
    decode steps over all prompts. Decode inputs are this run's own greedy
    tokens, or ``forced[step]``. Returns (logits moved to the host, greedy
    tokens, decode inputs), in call order."""
    ps, c = engine.scfg.page_size, engine.scfg.prefill_chunk
    dev = engine.device
    kp, vp = engine.fresh_pools()
    pool = PagePool(engine.scfg.pool_pages)
    seqs = []
    for p in prompts:
        sp = SequencePages(ps)
        sp.ensure(len(p) + n_decode, pool)
        seqs.append(sp)
    table = np.full((len(prompts), max(len(sp.pages) for sp in seqs)),
                    pool.trash_page - 1, np.int32)
    for i, sp in enumerate(seqs):
        table[i, : len(sp.pages)] = sp.pages
    table_d = torch.tensor(table, device=dev)
    logits_out, greedy, inputs, cur = [], [], [], []
    for i, p in enumerate(prompts):
        for start in range(0, len(p), c):
            chunk = p[start: start + c]
            buf = torch.zeros(c, dtype=torch.int64)
            buf[: len(chunk)] = torch.tensor(chunk)
            tok, logits = prefill_chunk(engine.cfg, engine.params, kp, vp, table_d[i],
                                        start, buf.to(dev), len(chunk))
            logits_out.append(logits.cpu())
            greedy.append(int(tok))
        cur.append(greedy[-1])
    lens = [len(p) for p in prompts]
    active = torch.ones(len(prompts), dtype=torch.bool, device=dev)
    for step in range(n_decode):
        toks = forced[step] if forced is not None else cur
        inputs.append(list(toks))
        nxt, logits = decode_step(
            engine.cfg, engine.params, kp, vp, table_d,
            torch.tensor(lens, device=dev), torch.tensor(toks, device=dev), active)
        logits_out.append(logits.cpu())
        cur = nxt.cpu().tolist()
        greedy.extend(cur)
        lens = [n + 1 for n in lens]
    return logits_out, greedy, inputs


def phase_whole_path(engine):
    n_decode = 4
    prompts = [r.prompt for r in synthesize_requests(SERVE_WL, engine.cfg.vocab)[:2]]
    scfg = ServeConfig(page_size=SERVE_WL["kv_page_size"], pool_pages=64,
                       prefill_chunk=SERVE_WL["prefill_chunk"])
    card = ServeEngine(engine.cfg, engine.params, scfg, "cuda")
    lg_card, tok_card, inputs = teacher_force(card, prompts, n_decode)
    t0 = time.perf_counter()
    cpu = ServeEngine(engine.cfg, tree_map(lambda t: t.cpu(), engine.params), scfg, "cpu")
    # the CPU replays the card's decode inputs, so one early disagreement
    # cannot cascade into different sequences
    lg_cpu, tok_cpu, _ = teacher_force(cpu, prompts, n_decode, forced=inputs)
    cpu_s = time.perf_counter() - t0
    check(all(bool(torch.isfinite(a).all()) for a in lg_card), "card logits not finite")
    check(all(a.shape == (engine.cfg.vocab,) or a.shape == (len(prompts), engine.cfg.vocab)
              for a in lg_card), "unexpected logits shape")
    err = max(float((a - b).abs().max()) for a, b in zip(lg_card, lg_cpu))
    check(err <= LOGITS_ATOL, f"card vs CPU logits: max abs diff {err} > {LOGITS_ATOL}")
    check(tok_card == tok_cpu, "card vs CPU greedy tokens differ")
    emit({"phase": "whole_path", "prompt_lens": [len(p) for p in prompts],
          "calls": len(lg_card), "decode_steps": n_decode,
          "logits_max_abs_diff": err, "atol": LOGITS_ATOL,
          "logits_max_abs": max(float(a.abs().max()) for a in lg_card),
          "greedy_equal": True, "tokens_compared": len(tok_card),
          "cpu_seconds": cpu_s})


# ---------------------------------------------------------------------------
# where a step's time goes
# ---------------------------------------------------------------------------


def phase_breakdown(engine, smi, iters=10):
    """One full decode step (max_slots sequences mid-way through phase 3's
    requests) and one prefill chunk, each timed on the host clock with a
    synchronise, and traced: the device's busy time per call, its idle
    share, and the kernels that take the most device time."""
    cfg, scfg = engine.cfg, engine.scfg
    dev = engine.device
    s, ps = scfg.max_slots, scfg.page_size
    reqs = synthesize_requests(SERVE_WL, cfg.vocab)[:s]
    lens = [len(r.prompt) + r.max_new // 2 for r in reqs]
    kp, vp = engine.fresh_pools()
    pool = PagePool(scfg.pool_pages)
    table = np.full((s, engine.max_pages_per_seq), pool.trash_page - 1, np.int32)
    for i, r in enumerate(reqs):
        sp = SequencePages(ps)
        sp.ensure(len(r.prompt) + r.max_new, pool)
        table[i, : len(sp.pages)] = sp.pages
    table_d = torch.tensor(table, device=dev)
    lens_d = torch.tensor(lens, device=dev)
    toks = torch.tensor([r.prompt[0] for r in reqs], device=dev)
    active = torch.ones(s, dtype=torch.bool, device=dev)
    c = scfg.prefill_chunk
    buf = torch.tensor(reqs[0].prompt[:c], device=dev)
    calls = {
        "decode_step": lambda: decode_step(cfg, engine.params, kp, vp, table_d,
                                           lens_d, toks, active),
        "prefill_chunk": lambda: prefill_chunk(cfg, engine.params, kp, vp, table_d[0],
                                               4 * c, buf, c),
    }
    out = {"phase": "breakdown", "decode_batch": s, "decode_seq_lens": lens,
           "chunk_len": c, "card": smi}
    for name, fn in calls.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / iters * 1e3
        rows = profile_kernels(lambda: [fn() for _ in range(iters)])
        # None where the profiler saw no device activity: not measured
        busy_ms = sum(r[2] for r in rows) / iters or None
        out[name] = {
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
            "top_kernels": [{"kernel": k[:80], "launches_per_call": n / iters,
                             "ms_per_call": t / iters, "share_of_busy": t / iters / busy_ms}
                            for k, n, t in rows[:6]],
        }
    emit(out)


# ---------------------------------------------------------------------------
# kernel timing at the decode shapes of phase 3
# ---------------------------------------------------------------------------


def call_ms(fn, iters, warmup=10):
    """Time per call of fn(i) over ``iters`` back-to-back calls, from CUDA
    events around the whole run: host launch overhead included wherever
    the host, not the card, sets the pace."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(event) -> float:
    return float(getattr(event, "self_device_time_total",
                         getattr(event, "self_cuda_time_total", 0.0)))


def profile_kernels(fn):
    """Run fn() under torch.profiler (CUDA activity only). Returns
    [(kernel name, calls, device ms)] over everything that ran on the card
    (kernels, copies, fills), largest first."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.count, _device_us(e) / 1e3) for e in prof.key_averages()]
    return sorted((r for r in rows if r[2] > 0), key=lambda r: -r[2])


def device_ms(fn, iters, warmup=10):
    """Device time per call of fn(i): the durations of everything the
    calls ran on the card, without host overhead or idle gaps. A trace can
    lose records (seen on the H100: 3 of 10 launches of a kernel missing
    from one trace, every turn), so each item counts at its mean duration
    times the launches a call makes (its records over iters, rounded, at
    least 1), not at its summed duration over iters. None when the
    profiler saw no device activity."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    rows = profile_kernels(lambda: [fn(i) for i in range(iters)])
    total = sum(t / n * max(1, round(n / iters)) for _, n, t in rows)
    return total if total > 0 else None


def phase_kernel_timing(cfg):
    """One decode step's attention call: max_slots sequences, mid-way
    through phase 3's requests (prompt + half the generation budget),
    pages from the engine's allocator, the engine's full-width table. Each
    call reads another layer's pools, as consecutive layers do, so the
    live K/V (several MB a layer, 12 layers) is not served from L2."""
    dev = torch.device("cuda")
    ps, s = SERVE_WL["kv_page_size"], SERVE_WL["max_slots"]
    h, h_kv, d, L = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    reqs = synthesize_requests(SERVE_WL, cfg.vocab)[:s]
    lens = [len(r.prompt) + r.max_new // 2 for r in reqs]
    pool = PagePool(SERVE_WL["kv_pool_pages"])
    table = np.full((s, pages_needed(cfg.max_seq, ps)), pool.trash_page - 1, np.int32)
    for i, r in enumerate(reqs):
        sp = SequencePages(ps)
        sp.ensure(len(r.prompt) + r.max_new, pool)
        table[i, : len(sp.pages)] = sp.pages
    g = torch.Generator(dev).manual_seed(0)
    shape = (L, pool.num_pages + 1, ps, h_kv, d)
    kp = torch.randn(shape, device=dev, generator=g)
    vp = torch.randn(shape, device=dev, generator=g)
    q = torch.randn(s, h, d, device=dev, generator=g)
    table_d = torch.tensor(table, device=dev)
    lens_d = torch.tensor(lens, dtype=torch.int32, device=dev)

    got = fa.paged_decode_kernel(q, kp[0], vp[0], table_d, lens_d)
    want = fa.paged_decode_reference(q, kp[0], vp[0], table_d, lens_d)
    err = float((got - want).abs().max())
    check(err <= KERNEL_ATOL, f"kernel vs plain at decode shape: {err}")

    # library yardstick: SDPA over K/V already gathered into contiguous
    # [s, h_kv, T, d] per layer (excludes the page gather), lengths masked
    T = max(lens)
    kc = torch.stack([kp[l][table_d.long()].reshape(s, -1, h_kv, d)[:, :T] for l in range(L)])
    vc = torch.stack([vp[l][table_d.long()].reshape(s, -1, h_kv, d)[:, :T] for l in range(L)])
    kc = kc.permute(0, 1, 3, 2, 4).contiguous()  # [L, s, h_kv, T, d]
    vc = vc.permute(0, 1, 3, 2, 4).contiguous()
    mask = (torch.arange(T, device=dev)[None, :] < lens_d[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]  # [s, h, 1, d]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def lib(i):
        return sdpa(q4, kc[i % L], vc[i % L], attn_mask=mask, enable_gqa=True)

    lib_err = float((lib(0)[:, :, 0] - want).abs().max())
    check(lib_err <= 1e-4, f"SDPA yardstick disagrees with the plain version: {lib_err}")

    kernel = lambda i: fa.paged_decode_kernel(q, kp[i % L], vp[i % L], table_d, lens_d)  # noqa: E731
    plain = lambda i: fa.paged_decode_reference(q, kp[i % L], vp[i % L], table_d, lens_d)  # noqa: E731
    # in turns on one card: kernel, plain, library, kernel
    runs = {"kernel": [], "plain": [], "library": []}
    for name, fn, iters in (("kernel", kernel, 300), ("plain", plain, 50),
                            ("library", lib, 300), ("kernel", kernel, 300)):
        runs[name].append((device_ms(fn, iters), call_ms(fn, iters)))
    dev_ok = all(d is not None for rs in runs.values() for d, _ in rs)
    # "ms" is device time where the profiler saw the card, else per-call time
    pick = (lambda rs: min(d for d, _ in rs)) if dev_ok else (lambda rs: min(c for _, c in rs))

    live_tokens = sum(lens)
    live_pages = sum(pages_needed(n, ps) for n in lens)
    bytes_moved = (2 * live_tokens * h_kv * d * 4   # live K and V, read once
                   + 2 * s * h * d * 4              # q in, o out
                   + live_pages * 4 + s * 4)        # live table entries, lengths
    ops = 4 * live_tokens * h * d                   # q.k and p.v, 2 ops per multiply-add
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    timing = {
        "ms": pick(runs["kernel"]), "plain_ms": pick(runs["plain"]),
        "library_ms": pick(runs["library"]), "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "max_abs_err": err,
    }
    emit({"phase": "kernel_timing", "shape": {"s": s, "h": h, "h_kv": h_kv, "d": d,
          "page": ps, "table_width": table.shape[1], "seq_lens": lens},
          "bytes": bytes_moved, "ops": ops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
          "library": "scaled_dot_product_attention on contiguous K/V, page gather excluded",
          "library_max_abs_err": lib_err,
          "ms_source": "device time (torch.profiler)" if dev_ok else "CUDA events per call",
          "device_ms_runs": {k: [d for d, _ in v] for k, v in runs.items()},
          "call_ms_runs": {k: [c for _, c in v] for k, v in runs.items()},
          **timing})
    return timing


# ---------------------------------------------------------------------------
# training: the flash kernels against their plain versions
# ---------------------------------------------------------------------------


def phase_flash_check(dev, shapes=((16, 4, 128), (16, 16, 128)), ts=(128, 200, 2048)):
    """K1-K3 against their plain versions on the card: gqa-2048's heads
    (16 query / 4 kv, d 128) and MHA, causal and not, t on and off the
    tile grid, f32 and bf16, a nonzero lse cotangent."""
    rng = np.random.RandomState(2)
    worst = {dt: {k: 0.0 for k in FLASH_KINDS} for dt in ("f32", "bf16")}
    ratio = {dt: {x: 0.0 for parts in FLASH_KINDS.values() for x in parts}
             for dt in ("f32", "bf16")}
    cases = 0
    for h, h_kv, d in shapes:
        for t in ts:
            b = 1 if t >= 2048 else 2
            for causal in (True, False):
                for dtype in (torch.float32, torch.bfloat16):
                    errs = compare_flash(*flash_case(rng, b, t, h, h_kv, d, dtype, dev), causal)
                    name = f"h{h}/kv{h_kv} d{d} t{t} causal={causal} {dtype}"
                    check(flash_within(errs), f"flash kernels vs plain, {name}: {errs}")
                    key = "f32" if dtype == torch.float32 else "bf16"
                    for kind, parts in FLASH_KINDS.items():
                        worst[key][kind] = max(worst[key][kind], *(errs[x][0] for x in parts))
                    for x, (_, r) in errs.items():
                        ratio[key][x] = max(ratio[key][x], r)
                    cases += 1
    emit({"phase": "flash_check", "cases": cases,
          "limits": {"f32_atol": FLASH_F32_ATOL, "lse_atol": FLASH_LSE_ATOL,
                     "bf16_rtol": FLASH_BF16_RTOL, "bf16_row_rms_atol": FLASH_BF16_ROW_ATOL},
          "max_abs_err": worst, "worst_err_over_limit": ratio})
    return worst


# Faults planted in copies of the kernel sources: (kernel, source, the
# line as it is, the line with the fault). Each must make the check fail.
FLASH_PLANTS = {
    # key tile 0 dropped for the last 64 query rows (1 of 32 at t = 2048)
    "fwd_drop_tile": ("fwd", "flash_fwd.cu",
                      "if (col >= t || (causal && col > row)) x = kNegInf;",
                      "if (col >= t || (causal && col > row) || (row >= t - 64 && col < 64)) "
                      "x = kNegInf;"),
    # the causal mask lets each row see one key past its own
    "fwd_mask_off_by_one": ("fwd", "flash_fwd.cu", "(causal && col > row)",
                            "(causal && col > row + 1)"),
    # key tile 0 dropped from dq for the last 64 query rows
    "dq_drop_tile": ("dq", "flash_bwd.cu",
                     "const bool live = row < t && col < t && !(causal && col > row);",
                     "const bool live = row < t && col < t && !(causal && col > row) && "
                     "!(row >= t - 64 && col < 64);"),
    # the last query tile never reaches dk, dv
    "dkv_drop_tile": ("dkv", "flash_bwd.cu",
                      "const bool live = row < t && key < t && !(causal && key > row);",
                      "const bool live = row < t - 64 && key < t && !(causal && key > row);"),
}
FLASH_KINDS = {"fwd": ("o", "lse"), "dq": ("dq",), "dkv": ("dk", "dv")}
FLASH_ENTRY = {"fwd": "flash_fwd", "dq": "flash_bwd_dq", "dkv": "flash_bwd_dkv"}


def build_plants(names=tuple(FLASH_PLANTS)):
    """Copies of the flash sources, each with one planted fault, built
    together into build/torch_kernels/plant/ (named by a hash of the
    faulty source, so a second call reuses them). Returns name -> CDLL."""
    import ctypes
    import hashlib
    import shutil

    out = _build.BUILD_DIR / "plant"
    out.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copyfile(header, out / header.name)
    jobs, libs = {}, {}
    for name in names:
        _, src, line, fault = FLASH_PLANTS[name]
        text = (_build.CSRC / src).read_text()
        check(text.count(line) == 1, f"plant {name}: the line occurs {text.count(line)} times")
        text = text.replace(line, fault)
        tag = hashlib.sha256(text.encode() + b"".join(
            h.read_bytes() for h in sorted(_build.CSRC.glob("*.cuh")))).hexdigest()[:16]
        libs[name] = out / f"{name}-{tag}.so"
        if not libs[name].exists():
            (out / f"{name}.cu").write_text(text)
            jobs[name] = (out / f"{name}.cu", libs[name])
    _build.compile_sources(jobs)
    return {name: ctypes.CDLL(str(path)) for name, path in libs.items()}


@contextlib.contextmanager
def planted(lib, kind):
    """Route the wrapper of flash kernel ``kind`` to the planted library."""
    entry = FLASH_ENTRY[kind]
    fa._flash_fn(entry)  # bind the real one first, so it can be put back
    real = fa._flash_fns[entry]
    fa._flash_fns[entry] = fa.bind_flash_entry(lib, entry)
    try:
        yield
    finally:
        fa._flash_fns[entry] = real


def phase_flash_plant(dev, t=2048):
    """Each planted fault (FLASH_PLANTS) at gqa-2048's heads, t 2048,
    causal, bf16 and f32: the check of phase flash_check must fail on the
    faulty kernel's own outputs. Launches here are not the main path's."""
    rng = np.random.RandomState(6)
    libs = build_plants()
    out = {}
    for name, lib in libs.items():
        kind = FLASH_PLANTS[name][0]
        for dtype in (torch.bfloat16, torch.float32):
            args = flash_case(rng, 1, t, 16, 4, 128, dtype, dev)
            with planted(lib, kind):
                errs = compare_flash(*args, True)
            worst = max(errs[x][1] for x in FLASH_KINDS[kind])
            check(worst > 1.0, f"planted fault {name} ({dtype}) passed the check: {errs}")
            out[f"{name}/{str(dtype)[6:]}"] = {x: errs[x][1] for x in FLASH_KINDS[kind]}
    emit({"phase": "flash_plant", "t": t, "caught": len(out),
          "worst_err_over_limit": out})


# ---------------------------------------------------------------------------
# training: the main path
# ---------------------------------------------------------------------------


def phase_train(smi, wl=TRAIN_WL, dev="cuda"):
    """gqa-2048 at full width and depth through run_lm: one warmup and
    wl["steps"] timed steps. Every step launches the flash forward 2·L
    times (save_mid recomputes the attention half in the backward) and
    each backward kernel L times; the loss stays finite and falls."""
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    run = run_lm(wl, device=dev)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    L, n = run.cfg.n_layers, len(run.losses)
    want = {"decode_launches": 0, "flash_fwd_launches": 2 * L * n,
            "flash_bwd_dq_launches": L * n, "flash_bwd_dkv_launches": L * n}
    check(counts == want, f"train launches {counts} != {want}")
    check(all(np.isfinite(run.losses)), f"non-finite loss: {run.losses}")
    check(run.losses[-1] < run.losses[0], f"loss did not fall: {run.losses}")
    emit({
        "phase": "train", "preset": wl["preset"], "n_layers": L, "d_model": run.cfg.d_model,
        "params": run.cfg.n_params(), "batch": wl["batch_size"], "seq": wl["seq_len"],
        "attn": wl["attn"], "remat": wl["remat"], "dtype": str(run.cfg.dtype),
        "steps": n, "timed_steps": run.timed, "losses": run.losses,
        "launches": counts, "launches_per_step": {k: v / n for k, v in counts.items()},
        "step_ms": run.step_s * 1e3, "tokens_per_s": run.tokens_per_s,
        "model_flops_exact": run.flops_exact, "model_flops_6nd": run.flops_6nd,
        "mfu_exact": run.mfu(run.flops_exact), "mfu_6nd": run.mfu(run.flops_6nd),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9 if on_card else None,
        "run_lm_wall_s": wall, "card": smi,
    })
    return run, counts


def kernel_category(name: str) -> str:
    """A device item's family, read from its name."""
    n = name.lower()
    for cat, marks in (("flash kernels", ("flash::",)),
                       ("matmul (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma", "sm90_")),
                       ("reduction", ("reduce",)), ("copy/cast", ("copy", "memcpy")),
                       ("fill", ("fill", "memset")), ("elementwise", ("elementwise",))):
        if any(m in n for m in marks):
            return cat
    return "other"


def phase_train_breakdown(run, smi, iters=2):
    """Training steps of phase ``train`` on the host clock and under
    torch.profiler: device busy time per step, idle share, top kernels and
    the three flash kernels' share."""
    holder = {"state": run.state}

    def step():
        holder["state"], m = run.trainer.step(holder["state"], run.tokens)
        return m

    float(step()["loss"])
    t0 = time.perf_counter()
    for _ in range(iters):
        m = step()
    float(m["loss"])
    wall_ms = (time.perf_counter() - t0) / iters * 1e3
    rows = profile_kernels(lambda: [step() for _ in range(iters)])
    busy_ms = sum(r[2] for r in rows) / iters or None
    flash = {kind: sum(t for k, _, t in rows if "flash::" in k and f"{kind}_" in k) / iters
             for kind in ("fwd", "dq", "dkv")}
    by_category = {}
    for k, _, t in rows:
        by_category[kernel_category(k)] = by_category.get(kernel_category(k), 0.0) + t / iters
    emit({
        "phase": "train_breakdown", "steps": iters, "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
        "flash_ms_per_step": flash,
        "flash_share_of_busy": sum(flash.values()) / busy_ms if busy_ms else None,
        "ms_per_step_by_category": dict(sorted(by_category.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"kernel": k[:100], "launches_per_step": c / iters,
                         "ms_per_step": t / iters,
                         "share_of_busy": t / iters / busy_ms if busy_ms else None}
                        for k, c, t in rows[:12]],
        "card": smi,
    })


@contextlib.contextmanager
def plain_attention():
    """Route CUDA tensors of flash_attention to the plain versions (the
    Function looks its kernels up by module attribute at call time)."""
    saved = fa.flash_fwd_kernel, fa.flash_bwd_kernel
    fa.flash_fwd_kernel, fa.flash_bwd_kernel = fa.flash_fwd_reference, fa.flash_bwd_reference
    try:
        yield
    finally:
        fa.flash_fwd_kernel, fa.flash_bwd_kernel = saved


def phase_train_parity(dev, n_layers=2, batch=2, seq=256, steps=3):
    """The training path at gqa-2048 width, cut to 2 layers and t 256:
    (1) f32 loss and grads on the card (flash kernels, cuBLAS) against the
    CPU (plain versions) from the same params and tokens; (2) 3 bf16
    AdamW steps on the card with the kernels against 3 with the plain
    versions called directly on the same card tensors."""
    wl = {**TRAIN_WL, "n_layers": n_layers, "seq_len": seq, "batch_size": batch}
    cfg16 = preset_from_workload(wl)
    cfg32 = replace(cfg16, dtype=torch.float32)
    params = init_transformer(cfg32, torch.Generator().manual_seed(0), "cpu")
    tokens = fixed_tokens(batch, seq, cfg32.vocab, "cpu")

    def loss_and_grads(where):
        p = tree_map(lambda x: x.detach().to(where).requires_grad_(True), params)
        loss = lm_loss(p, tokens.to(where), cfg32)
        loss.backward()
        return float(loss.detach()), tree_map(lambda x: x.grad.cpu(), p)

    card_loss, card_g = loss_and_grads(dev)
    t0 = time.perf_counter()
    cpu_loss, cpu_g = loss_and_grads("cpu")
    cpu_s = time.perf_counter() - t0
    loss_err = abs(card_loss - cpu_loss)
    check(loss_err <= PARITY_LOSS_ATOL, f"card vs CPU loss: {card_loss} vs {cpu_loss}")
    grad_rel = {name: float((gc - gp).abs().max()) / max(float(gp.abs().max()), 1e-30)
                for (name, gc), (_, gp) in zip(leaves_with_names(card_g),
                                               leaves_with_names(cpu_g))}
    check(max(grad_rel.values()) <= PARITY_GRAD_REL, f"card vs CPU grads: {grad_rel}")

    tok = tokens.to(dev)

    def train(use_plain):
        trainer = Trainer(loss_fn=lambda p, b, e: lm_loss(p, b, cfg16), init_fn=None,
                          config=TrainerConfig(learning_rate=wl["lr"]), device=dev)
        state = trainer.state_from_params(tree_map(lambda x: x.clone().to(dev), params))
        reset_counts()
        losses = []
        with plain_attention() if use_plain else contextlib.nullcontext():
            for _ in range(steps):
                state, m = trainer.step(state, tok)
                losses.append(m["loss"])
        return [float(x) for x in losses], read_counts()

    kern, kern_counts = train(False)
    plain, plain_counts = train(True)
    check(kern_counts["flash_fwd_launches"] == 2 * n_layers * steps
          and kern_counts["flash_bwd_dkv_launches"] == n_layers * steps,
          f"kernel run launches {kern_counts}")
    check(not any(plain_counts.values()), f"plain run launched kernels: {plain_counts}")
    step_err = max(abs(a - b) for a, b in zip(kern, plain))
    check(all(np.isfinite(kern)) and step_err <= PARITY_BF16_LOSS_ATOL,
          f"bf16 steps, kernels {kern} vs plain {plain}")
    emit({"phase": "train_parity", "n_layers": n_layers, "batch": batch, "seq": seq,
          "f32_loss_card": card_loss, "f32_loss_cpu": cpu_loss, "f32_loss_abs_diff": loss_err,
          "f32_loss_atol": PARITY_LOSS_ATOL, "f32_grad_rel_diff_max": max(grad_rel.values()),
          "f32_grad_rel_limit": PARITY_GRAD_REL, "f32_grad_rel_diff": grad_rel,
          "bf16_losses_kernels": kern, "bf16_losses_plain": plain,
          "bf16_loss_max_abs_diff": step_err, "bf16_loss_atol": PARITY_BF16_LOSS_ATOL,
          "cpu_seconds": cpu_s})


def leaves_with_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves_with_names(tree[k], f"{prefix}{k}/")]
    return [(prefix.rstrip("/"), tree)]


# ---------------------------------------------------------------------------
# training: kernel timing at the train shape
# ---------------------------------------------------------------------------


def timed_in_turns(fns, iters):
    """{name: ms} for each (name, fn) of ``fns``, run in three turns (the
    list, reversed, then again) on one card: device time from
    torch.profiler (see device_ms) where it saw the card, else CUDA-event
    time per call; the median of the turns."""
    runs = {name: [] for name, _ in fns}
    for name, fn in [*fns, *reversed(fns), *fns]:
        runs[name].append((device_ms(fn, iters[name], warmup=2), call_ms(fn, iters[name], 2)))
    dev_ok = all(d is not None for rs in runs.values() for d, _ in rs)
    return ({name: statistics.median((d if dev_ok else c) for d, c in rs)
             for name, rs in runs.items()},
            "device time (torch.profiler)" if dev_ok else "CUDA events per call", runs)


def phase_flash_timing(smi, b=6, t=2048, h=16, h_kv=4, d=128, dev="cuda"):
    """K1, K2 and K3 at the train phase's attention shape (bf16, causal),
    beside their bounds, their plain versions and SDPA (forward; backward
    against K2 + K3). Each bound is the larger of the live operations at
    989 TFLOP/s and the bytes (inputs read once, outputs written once) at
    3.35 TB/s."""
    rng = np.random.RandomState(4)
    q, k, v, do, dlse = flash_case(rng, b, t, h, h_kv, d, torch.bfloat16, dev)
    errs = compare_flash(q, k, v, do, dlse, True)
    check(flash_within(errs), f"flash at the train shape: {errs}")
    o, lse = fa.flash_fwd_kernel(q, k, v, True)
    lse_k, delta = fa.lse_kernel_layout(lse), fa.flash_delta(o, do, dlse)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    out_t = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
    o_ref = fa.flash_fwd_reference(q.float(), k.float(), v.float(), True)[0]
    lib_diff = (out_t.detach().transpose(1, 2).float() - o_ref).abs()
    lib_err = float(lib_diff.max())
    check(bool((lib_diff <= flash_limit("o", o_ref, torch.bfloat16)).all()),
          f"SDPA yardstick disagrees with the plain version: {lib_err}")
    do_t = do.transpose(1, 2).contiguous()
    fns = {
        "fwd": [("kernel", lambda i: fa.flash_fwd_kernel(q, k, v, True)),
                ("plain", lambda i: fa.flash_fwd_reference(q, k, v, True)),
                ("library", lambda i: sdpa(qt.detach(), kt.detach(), vt.detach(),
                                           is_causal=True, enable_gqa=True))],
        "dq": [("kernel", lambda i: fa.flash_bwd_dq_kernel(q, k, v, do, lse_k, delta, True)),
               ("plain", lambda i: fa.flash_bwd_dq_reference(q, k, v, do, lse_k, delta, True))],
        "dkv": [("kernel", lambda i: fa.flash_bwd_dkv_kernel(q, k, v, do, lse_k, delta, True)),
                ("plain", lambda i: fa.flash_bwd_dkv_reference(q, k, v, do, lse_k, delta, True)),
                ("library_bwd", lambda i: torch.autograd.grad(
                    out_t, (qt, kt, vt), do_t, retain_graph=True))]}
    iters = {"kernel": 10, "plain": 3, "library": 10, "library_bwd": 10}
    pairs = b * h * t * (t + 1) // 2  # live (query, key) pairs under causal masking
    e2, e4 = 2, 4
    qb, kvb, rowb = b * t * h * d * e2, b * t * h_kv * d * e2, b * h * t * e4
    work = {  # (operations, bytes)
        "fwd": (4 * d * pairs, qb + 2 * kvb + qb + rowb),
        "dq": (6 * d * pairs, 2 * qb + 2 * kvb + 2 * rowb + qb),
        "dkv": (8 * d * pairs, 2 * qb + 2 * kvb + 2 * rowb + 2 * kvb),
    }
    out = {}
    for kind, kfns in fns.items():
        ms, source, runs = timed_in_turns(kfns, iters)
        ops, nbytes = work[kind]
        ops_ms, bytes_ms = ops / BF16_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        out[kind] = {
            "ms": ms["kernel"], "plain_ms": ms["plain"], "library_ms": ms.get("library"),
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "ops": ops, "bytes": nbytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "tflops": ops / ms["kernel"] / 1e9,
            "max_abs_err_bf16": max(errs[x][0] for x in FLASH_KINDS[kind]),
            "ms_source": source, "runs": {n: r for n, r in runs.items()},
        }
        if "library_bwd" in ms:  # SDPA's backward: dq, dk and dv in one call
            out["library_bwd_all_ms"] = ms["library_bwd"]
    emit({"phase": "flash_timing", "shape": {"b": b, "t": t, "h": h, "h_kv": h_kv, "d": d,
                                             "dtype": "bfloat16", "causal": True},
          "library": "scaled_dot_product_attention(is_causal, enable_gqa) on [b, h, t, d]; "
                     "its backward computes dq, dk and dv together",
          "library_max_abs_err_vs_plain": lib_err, "card": smi, **out})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    dev = resolve_device("cuda")
    smi = nvidia_smi()
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for _, out in _build.build_log.values()
             for ln in out.splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "device", "card": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_build_s": build_s, "ptxas": ptxas})

    # serving path
    check_err = phase_kernel_check(dev)
    engine, res, launches = phase_serve(smi)
    phase_whole_path(engine)
    phase_breakdown(engine, smi)
    cfg = engine.cfg
    del engine, res
    torch.cuda.empty_cache()
    timing = phase_kernel_timing(cfg)

    # training path
    flash_err = phase_flash_check(dev)
    phase_flash_plant(dev)
    run, train_counts = phase_train(smi)
    phase_train_breakdown(run, smi)
    del run
    torch.cuda.empty_cache()
    phase_train_parity(dev)
    ft = phase_flash_timing(smi)

    kernels = [{
        "name": "paged_decode", "route": "cuda",
        "source": "tf_operator_tpu_torch/ops/csrc/paged_decode.cu",
        "replaces": "tf_operator_tpu/ops/flash_attention.py:686",
        "launches": launches,
        "max_abs_err": max(check_err, timing["max_abs_err"]),
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }]
    for kind, name, src, line, counter in (
            ("fwd", "flash_fwd", "flash_fwd.cu", 132, "flash_fwd_launches"),
            ("dq", "flash_bwd_dq", "flash_bwd.cu", 228, "flash_bwd_dq_launches"),
            ("dkv", "flash_bwd_dkv", "flash_bwd.cu", 271, "flash_bwd_dkv_launches")):
        t = ft[kind]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tf_operator_tpu_torch/ops/csrc/{src}",
            "replaces": f"tf_operator_tpu/ops/flash_attention.py:{line}",
            "launches": train_counts[counter],
            # bf16 (the path's type) against the f32 plain version on the same
            # inputs, over every flash_check case and the train shape; the f32
            # instantiation's error beside it
            "max_abs_err": max(flash_err["bf16"][kind], t["max_abs_err_bf16"]),
            "max_abs_err_f32": flash_err["f32"][kind],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
        if kind != "fwd":
            # no library call computes dq (or dk, dv) alone; SDPA's backward
            # computes all three in one call, timed here as a yardstick
            kernels[-1]["library_bwd_all_ms"] = ft["library_bwd_all_ms"]
    emit({"kernels": kernels})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
