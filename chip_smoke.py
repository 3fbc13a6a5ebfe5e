#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

Usage, from the root of a checkout, on a host with one CUDA card:

    python3 chip_smoke.py

Builds the port's CUDA kernels from the checkout's sources, then prints
one JSON line per phase:

1. ``device``: the card's name and power limit (nvidia-smi) and the
   kernels' build time.
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

Then the ``kernels`` line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises: the script
then exits non-zero and prints no result. Without a CUDA device it exits
1 at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from tf_operator_tpu_torch.compat import tree_map
from tf_operator_tpu_torch.device import resolve_device
from tf_operator_tpu_torch.ops import _build
from tf_operator_tpu_torch.ops import flash_attention as fa
from tf_operator_tpu_torch.serve.engine import (
    ServeConfig,
    ServeEngine,
    decode_step,
    prefill_chunk,
)
from tf_operator_tpu_torch.serve.kvcache import PagePool, SequencePages, pages_needed
from tf_operator_tpu_torch.workloads.serve import _quantile, run_serve, synthesize_requests

SERVE_WL = {
    "preset": "gqa-2048", "requests": 16, "prompt_len": 128,
    "max_new_tokens": 64, "arrival_rate": 0, "kv_page_size": 16,
    "kv_pool_pages": 256, "max_slots": 8, "prefill_chunk": 16, "seed": 0,
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
# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32
# (non-tensor-core) operations/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


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
    fa.decode_launches = 0
    t0 = time.perf_counter()
    engine, res = run_serve(SERVE_WL, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.decode_launches
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
    """Device time per call of fn(i): the summed durations of everything
    the calls ran on the card, without host overhead or idle gaps. None
    when the profiler saw no device activity."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    rows = profile_kernels(lambda: [fn(i) for i in range(iters)])
    total = sum(r[2] for r in rows)
    return total / iters if total > 0 else None


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

    check_err = phase_kernel_check(dev)
    engine, res, launches = phase_serve(smi)
    phase_whole_path(engine)
    phase_breakdown(engine, smi)
    cfg = engine.cfg
    del engine, res
    torch.cuda.empty_cache()
    timing = phase_kernel_timing(cfg)

    emit({"kernels": [{
        "name": "paged_decode", "route": "cuda",
        "source": "tf_operator_tpu_torch/ops/csrc/paged_decode.cu",
        "replaces": "tf_operator_tpu/ops/flash_attention.py:686",
        "launches": launches,
        "max_abs_err": max(check_err, timing["max_abs_err"]),
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
