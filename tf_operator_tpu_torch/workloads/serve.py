"""Continuous-batching LM serving workload on the port (operator-launchable).

Port of ``tf_operator_tpu/workloads/serve.py``: seeded synthetic requests
(identical stream), served by ``serve/engine.py`` over the paged KV
cache; the job fails on a page leak. The operator launches
``tf_operator_tpu_torch.workloads.serve:main`` like any entrypoint.
``main`` uses the context only through its attributes (``workload``,
``process_id``, ``job_name``, ``trace_id``, ``mark_first_step``,
``report_eval_metrics``, ``record_span``) and does not join a JAX gang.

Workload keys: the JAX workload's (preset and TransformerConfig
overrides, requests, prompt_len, max_new_tokens, arrival_rate, seed,
kv_page_size, kv_pool_pages, max_slots, prefill_chunk, reserve_full,
max_admit_per_step, mode, report_every) plus ``device`` (default
``cuda``). Init draws from a ``torch.Generator`` seeded with ``seed``,
so the weights differ from the JAX workload's ``PRNGKey(seed)`` init.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from tf_operator_tpu_torch.device import DeviceLike, resolve_device
from tf_operator_tpu_torch.models.transformer import (
    init_transformer,
    preset_from_workload,
)
from tf_operator_tpu_torch.serve.engine import (
    Request,
    RunResult,
    ServeConfig,
    ServeEngine,
)

log = logging.getLogger("tpujob.serve")


def synthesize_requests(wl: dict, vocab: int):
    """The seeded request stream, identical to the JAX package's: Poisson
    arrivals, uniform prompt lengths around prompt_len, uniform random
    prompt tokens, ragged generation budgets in [1, max_new_tokens]."""
    rng = np.random.RandomState(int(wl.get("seed", 0)))
    n = int(wl.get("requests", 8))
    rate = float(wl.get("arrival_rate", 20.0))
    mean_prompt = max(1, int(wl.get("prompt_len", 8)))
    max_new = max(1, int(wl.get("max_new_tokens", 16)))
    t = 0.0
    reqs = []
    for i in range(n):
        if rate > 0:
            t += float(rng.exponential(1.0 / rate))
        plen = int(rng.randint(max(1, mean_prompt // 2), mean_prompt * 2 + 1))
        reqs.append(
            Request(
                rid=i,
                prompt=[int(x) for x in rng.randint(1, vocab, size=plen)],
                max_new=int(rng.randint(1, max_new + 1)),
                arrival=t,
            )
        )
    return reqs


def _quantile(xs, q):
    if not xs:
        return 0.0
    ys = sorted(xs)
    idx = min(len(ys) - 1, int(round(q * (len(ys) - 1))))
    return ys[idx]


def serve_config(wl: dict) -> ServeConfig:
    return ServeConfig(
        page_size=int(wl.get("kv_page_size", 16)),
        pool_pages=int(wl.get("kv_pool_pages", 64)),
        max_slots=int(wl.get("max_slots", 4)),
        prefill_chunk=int(wl.get("prefill_chunk", 16)),
        reserve_full=bool(wl.get("reserve_full", True)),
        max_admit_per_step=int(wl.get("max_admit_per_step", 0)),
        mode=str(wl.get("mode", "continuous")),
    )


def run_serve(
    wl: dict,
    device: DeviceLike = None,
    on_event: Optional[Callable[[str, Any], None]] = None,
) -> Tuple[ServeEngine, RunResult]:
    """Build the model from ``wl``, serve its synthetic requests to
    completion and return (engine, result). ``device`` overrides the
    workload's ``device`` key (default ``cuda``). Raises on a page leak."""
    dev = resolve_device(device if device is not None else wl.get("device", "cuda"))
    cfg = preset_from_workload(wl)
    gen = torch.Generator(device=dev).manual_seed(int(wl.get("seed", 0)))
    params = init_transformer(cfg, gen, dev)
    engine = ServeEngine(cfg, params, serve_config(wl), dev)
    res = engine.run(synthesize_requests(wl, cfg.vocab), on_event=on_event)
    leaked = res.free_pages_start - res.free_pages_end
    if leaked:
        raise RuntimeError(
            f"KV page leak: {leaked} pages not returned to the free list"
        )
    return engine, res


def main(ctx) -> None:
    if ctx.process_id != 0:
        # the decode engine is single-process; extra ranks hold their slot
        return
    wl = ctx.workload
    total = int(wl.get("requests", 8))
    report_every = max(1, int(wl.get("report_every", 4)))
    wall0 = time.time()  # engine offsets -> epoch times for spans
    trace8 = (ctx.trace_id or "")[:8]

    def span_name(rid: int, op: str) -> str:
        return f"{ctx.job_name}-{trace8}-req{rid}-{op}"

    first_step = []

    def on_event(kind: str, payload) -> None:
        if kind == "step":
            if not first_step:
                first_step.append(payload["step"])
                ctx.mark_first_step(0)
            if payload["step"] % report_every == 0:
                ctx.report_eval_metrics(payload["step"], {
                    "requests_total": float(total),
                    "requests_active": float(payload["active"]),
                    "requests_completed": float(payload["completed"]),
                    "tokens_generated": float(payload["generated"]),
                })
            return
        req = payload
        base = {"request": str(req.rid), "track": "serve"}
        if kind == "admitted":
            ctx.record_span(
                "request-admitted", wall0 + req.arrival, wall0 + req.admitted,
                attrs=base, name=span_name(req.rid, "request-admitted"),
            )
        elif kind == "first_token":
            ctx.record_span(
                "first-token", wall0 + req.arrival, wall0 + req.first_token,
                attrs=base, name=span_name(req.rid, "first-token"),
            )
        elif kind == "finished":
            ctx.record_span(
                "finished", wall0 + req.arrival, wall0 + req.finished,
                attrs={**base, "tokens": str(len(req.tokens))},
                name=span_name(req.rid, "finished"),
            )

    engine, res = run_serve(wl, on_event=on_event)
    ctx.report_eval_metrics(res.steps, {
        "requests_total": float(total),
        "requests_active": 0.0,
        "requests_completed": float(res.completed),
        "tokens_generated": float(res.generated_tokens),
        "tokens_per_s": float(res.tokens_per_s),
    })
    ttfts = res.ttfts()
    log.info(
        "serve done: preset=%s device=%s mode=%s requests=%d/%d tokens=%d "
        "tok/s=%.1f ttft_p50=%.3fs ttft_p99=%.3fs steps=%d (0 page leaks)",
        wl.get("preset", "tiny"), engine.device, engine.scfg.mode,
        res.completed, total, res.generated_tokens, res.tokens_per_s,
        _quantile(ttfts, 0.50), _quantile(ttfts, 0.99), res.steps,
    )
