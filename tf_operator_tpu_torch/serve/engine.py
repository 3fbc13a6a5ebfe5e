"""Continuous-batching decode engine over the paged KV cache.

Port of ``tf_operator_tpu/serve/engine.py`` (Orca-style iteration-level
scheduling over vLLM-style paged K/V). The scheduler loop is the same:
at every step boundary the engine admits arrivals into free slots, runs
one prefill chunk for each still-prefilling slot and one batched decode
step over the decoding slots, and evicts finished sequences at once
(``mode="static"`` reintroduces the drain-the-batch barrier as the
baseline).

The two step functions are module-level and run eagerly under
``torch.inference_mode()``:

- ``decode_step``: every slot advances one token. Each layer computes
  single-position q/k/v, rotates them at the token's absolute position,
  writes k/v into the slot's current page row and attends through the
  page table (``ops.flash_attention_decode``: the Hopper kernel on the
  card, the plain version on the CPU). Inactive slots write to the
  pool's trash page and attend with seq_len 0.
- ``prefill_chunk``: C prompt positions of ONE sequence run as C
  pseudo-sequences that share the sequence's page-table row, with
  lengths pos+1 — causal by construction, on the same decode attention.

Both return the greedy token and the logits it was taken from. Greedy
argmax, f32 throughout.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tf_operator_tpu_torch.compat import tree_map
from tf_operator_tpu_torch.device import DeviceLike, resolve_device
from tf_operator_tpu_torch.models.transformer import (
    TransformerConfig,
    _rms_norm,
    rope_at_positions,
)
from tf_operator_tpu_torch.ops.flash_attention import flash_attention_decode
from tf_operator_tpu_torch.serve.kvcache import (
    PagePool,
    PoolExhausted,
    SequencePages,
    pages_needed,
)


@dataclass
class ServeConfig:
    """Engine policy knobs (workload keys carry the same names with a
    ``kv_``/serve prefix — see workloads/serve.py)."""

    page_size: int = 16
    pool_pages: int = 64
    max_slots: int = 4
    prefill_chunk: int = 16
    # reserve prompt + max_new pages at admission, so a running sequence
    # never hits PoolExhausted mid-decode; False grows on demand.
    reserve_full: bool = True
    # at most this many admissions per step boundary (0 = unlimited)
    max_admit_per_step: int = 0
    mode: str = "continuous"  # "continuous" | "static" (drain baseline)


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    arrival: float = 0.0  # seconds offset from run start

    # filled in by the engine
    tokens: List[int] = field(default_factory=list)
    admitted: float = -1.0
    first_token: float = -1.0
    finished: float = -1.0
    token_times: List[float] = field(default_factory=list)


@dataclass
class RunResult:
    requests: List[Request]
    steps: int
    wall_s: float
    generated_tokens: int
    free_pages_start: int
    free_pages_end: int
    # calls of each step function (each runs every layer's attention once)
    prefill_chunks: int = 0
    decode_steps: int = 0

    @property
    def completed(self) -> int:
        return sum(1 for r in self.requests if r.finished >= 0)

    @property
    def tokens_per_s(self) -> float:
        return self.generated_tokens / self.wall_s if self.wall_s > 0 else 0.0

    def ttfts(self) -> List[float]:
        return [r.first_token - r.arrival for r in self.requests
                if r.first_token >= 0]

    def token_latencies(self) -> List[float]:
        """Inter-token gaps per request (TTFT excluded)."""
        out: List[float] = []
        for r in self.requests:
            ts = r.token_times
            out.extend(b - a for a, b in zip(ts, ts[1:]))
        return out


class _Slot:
    __slots__ = ("req", "pages", "seq_len", "prefill_pos", "cur_tok", "generated")

    def __init__(self, req: Request, pages: SequencePages):
        self.req = req
        self.pages = pages
        self.seq_len = 0        # K/V positions written
        self.prefill_pos = 0    # prompt tokens consumed
        self.cur_tok = -1       # pending input token once decoding
        self.generated = 0


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------


def _body(cfg: TransformerConfig, params, kp, vp, x, pos, table, lens,
          write_pid, write_row):
    """Every layer over x [n, d] at absolute positions pos [n]: writes row
    i's k/v to (write_pid[i], write_row[i]) of the pools, then attends
    through ``table`` with per-row lengths ``lens`` (int32). Returns the
    final hidden [n, d]."""
    n = x.shape[0]
    hd = cfg.head_dim
    lp = params["layers"]
    pos2 = pos[:, None]
    for l in range(cfg.n_layers):
        h = _rms_norm(x, lp["attn_norm"][l], cfg.norm_eps)
        q = (h @ lp["wq"][l]).view(n, 1, -1, hd)
        k = (h @ lp["wk"][l]).view(n, 1, -1, hd)
        v = (h @ lp["wv"][l]).view(n, -1, hd)
        q = rope_at_positions(q, pos2, cfg.rope_theta)[:, 0]
        k = rope_at_positions(k, pos2, cfg.rope_theta)[:, 0]
        # In place: the JAX engine donates the pools to its jitted step
        # for the same effect. Duplicate indices only ever hit the trash page.
        kp[l].index_put_((write_pid, write_row), k)
        vp[l].index_put_((write_pid, write_row), v)
        attn = flash_attention_decode(q, kp[l], vp[l], table, lens)
        x = x + attn.reshape(n, -1) @ lp["wo"][l]
        h2 = _rms_norm(x, lp["mlp_norm"][l], cfg.norm_eps)
        x = x + (F.silu(h2 @ lp["w_gate"][l]) * (h2 @ lp["w_up"][l])) @ lp["w_down"][l]
    return x


@torch.inference_mode()
def decode_step(cfg: TransformerConfig, params, kp, vp, table, seq_lens,
                tokens, active):
    """One token for every slot. tokens[i] (int64) sits at position
    seq_lens[i]; table [s, p] int32; active [s] bool. The pools
    kp/vp [L, pool_pages + 1, page, h_kv, d] are updated in place (the
    last page is the trash page). Returns (greedy tokens [s], logits
    [s, vocab])."""
    ps, trash = kp.shape[2], kp.shape[1] - 1
    s = tokens.shape[0]
    pos = seq_lens.long()
    x = params["embed"][tokens]
    pid = table[torch.arange(s, device=tokens.device), pos // ps].long()
    pid = torch.where(active, pid, trash)
    lens = torch.where(active, pos + 1, 0).to(torch.int32)
    x = _body(cfg, params, kp, vp, x, pos, table, lens, pid, pos % ps)
    logits = _rms_norm(x, params["final_norm"], cfg.norm_eps) @ params["embed"].T
    return logits.argmax(dim=-1), logits


@torch.inference_mode()
def prefill_chunk(cfg: TransformerConfig, params, kp, vp, table_row, start: int,
                  tokens_c, n_valid: int):
    """One chunk of one sequence's prompt: tokens_c [C] int64 at positions
    start.., the first n_valid real, the rest padding. The C positions
    run as C pseudo-sequences over the shared page-table row [p] int32
    (lengths pos+1, hence causal). Returns (greedy token, logits [vocab])
    at the last real position."""
    ps, trash = kp.shape[2], kp.shape[1] - 1
    c = tokens_c.shape[0]
    idx = torch.arange(c, device=tokens_c.device)
    pos = start + idx
    valid = idx < n_valid
    x = params["embed"][tokens_c]
    # Padding rows may lie past the table's end (JAX clamps that gather;
    # torch would fault): clamp their lookup, whose result goes unused.
    page_idx = (pos // ps).clamp(max=table_row.shape[0] - 1)
    pid = torch.where(valid, table_row[page_idx].long(), trash)
    table_c = table_row.expand(c, -1)  # rows share storage (row stride 0)
    lens = torch.where(valid, pos + 1, 0).to(torch.int32)
    x = _body(cfg, params, kp, vp, x, pos, table_c, lens, pid, pos % ps)
    last = _rms_norm(x[n_valid - 1], params["final_norm"], cfg.norm_eps)
    logits = last @ params["embed"].T
    return logits.argmax(), logits


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


class ServeEngine:
    def __init__(self, cfg: TransformerConfig, params: Dict[str, Any],
                 scfg: ServeConfig, device: DeviceLike = None):
        if cfg.n_experts:
            raise ValueError("serve engine: MoE presets not supported")
        if cfg.pp_microbatches:
            raise ValueError("serve engine: pipeline presets not supported")
        if scfg.page_size < 1:
            raise ValueError(f"kv_page_size must be >= 1, got {scfg.page_size}")
        if scfg.pool_pages < 1:
            raise ValueError(f"kv_pool_pages must be >= 1, got {scfg.pool_pages}")
        self.cfg = cfg
        self.scfg = scfg
        self.device = resolve_device(device)
        # f32 weights and pools: serving determinism and the logits-parity
        # checks. A tensor already f32 on the device is not copied.
        self.params = tree_map(
            lambda t: torch.as_tensor(t).to(self.device, torch.float32), params
        )
        self.max_pages_per_seq = pages_needed(cfg.max_seq, scfg.page_size)

    def fresh_pools(self):
        cfg, scfg = self.cfg, self.scfg
        shape = (
            cfg.n_layers, scfg.pool_pages + 1, scfg.page_size,
            cfg.n_kv_heads, cfg.head_dim,
        )
        return (torch.zeros(shape, dtype=torch.float32, device=self.device),
                torch.zeros(shape, dtype=torch.float32, device=self.device))

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(a, device=self.device)

    # -- the scheduler loop ----------------------------------------------

    def run(
        self,
        requests: List[Request],
        mode: Optional[str] = None,
        clock: Callable[[], float] = time.perf_counter,
        on_event: Optional[Callable[[str, Any], None]] = None,
    ) -> RunResult:
        """Serve ``requests`` (arrival offsets in seconds from run start)
        to completion. ``on_event(kind, payload)`` fires with kinds
        "admitted"/"first_token"/"finished" (payload: the Request) and
        "step" (payload: dict with step/active/waiting/completed)."""
        mode = mode or self.scfg.mode
        if mode not in ("continuous", "static"):
            raise ValueError(f"mode {mode!r}")
        scfg = self.scfg
        for r in requests:
            if not r.prompt:
                raise ValueError(f"request {r.rid}: empty prompt")
            if len(r.prompt) + r.max_new > self.cfg.max_seq:
                raise ValueError(
                    f"request {r.rid}: prompt {len(r.prompt)} + max_new "
                    f"{r.max_new} exceeds max_seq {self.cfg.max_seq}"
                )
            if pages_needed(len(r.prompt) + r.max_new, scfg.page_size) > scfg.pool_pages:
                raise ValueError(
                    f"request {r.rid} alone needs "
                    f"{pages_needed(len(r.prompt) + r.max_new, scfg.page_size)} "
                    f"pages but the pool holds {scfg.pool_pages} — it could "
                    f"never be admitted"
                )
        pool = PagePool(scfg.pool_pages)
        free_start = pool.free_count
        kp, vp = self.fresh_pools()
        s_n = scfg.max_slots
        table = np.full((s_n, self.max_pages_per_seq), pool.trash_page - 1,
                        np.int32)
        slots: List[Optional[_Slot]] = [None] * s_n

        pending = deque(sorted(requests, key=lambda r: (r.arrival, r.rid)))
        waiting: deque = deque()
        emit = on_event or (lambda kind, payload: None)
        t0 = clock()
        step = 0
        completed = 0
        generated = 0
        n_prefill = 0
        n_decode = 0

        def _admit_ok() -> bool:
            if mode == "static":
                # drain-the-batch baseline: the batch forms only when EMPTY
                return all(sl is None for sl in slots)
            return True

        def _try_admit(now: float) -> int:
            n = 0
            while waiting and _admit_ok():
                if scfg.max_admit_per_step and n >= scfg.max_admit_per_step:
                    break
                free = [i for i, sl in enumerate(slots) if sl is None]
                if not free:
                    break
                req = waiting[0]
                want = len(req.prompt) + (req.max_new if scfg.reserve_full else 0)
                sp = SequencePages(scfg.page_size)
                try:
                    sp.ensure(want, pool)
                except PoolExhausted:
                    break  # head-of-line blocks: FIFO admission, no bypass
                waiting.popleft()
                i = free[0]
                slots[i] = _Slot(req, sp)
                table[i, : len(sp.pages)] = sp.pages
                req.admitted = now
                emit("admitted", req)
                n += 1
                if mode == "static" and n >= s_n:
                    break
            return n

        def _finish(i: int, now: float) -> None:
            """Continuous mode frees the slot and its pages at once;
            static mode holds everything until the whole batch drains."""
            nonlocal completed
            sl = slots[i]
            sl.req.finished = now
            completed += 1
            emit("finished", sl.req)
            if mode == "continuous":
                sl.pages.release(pool)
                table[i, :] = pool.trash_page - 1
                slots[i] = None

        def _drain_static(now: float) -> None:
            if mode != "static":
                return
            live = [sl for sl in slots if sl is not None]
            if live and all(sl.generated >= sl.req.max_new for sl in live):
                for j, sl in enumerate(slots):
                    if sl is not None:
                        sl.pages.release(pool)
                        table[j, :] = pool.trash_page - 1
                        slots[j] = None

        while completed < len(requests):
            now = clock() - t0
            while pending and pending[0].arrival <= now:
                waiting.append(pending.popleft())
            _try_admit(now)
            busy = [sl for sl in slots if sl is not None]
            if not busy:
                if pending:
                    time.sleep(
                        max(0.0, min(0.01, pending[0].arrival - (clock() - t0)))
                    )
                continue

            # ---- prefill: one chunk per still-prefilling slot ----------
            for i, sl in enumerate(slots):
                if sl is None or sl.prefill_pos >= len(sl.req.prompt):
                    continue
                prompt = sl.req.prompt
                c = scfg.prefill_chunk
                chunk = prompt[sl.prefill_pos : sl.prefill_pos + c]
                n_valid = len(chunk)
                buf = np.zeros(c, np.int64)
                buf[:n_valid] = chunk
                if not scfg.reserve_full:
                    sl.pages.ensure(sl.prefill_pos + n_valid, pool)
                    table[i, : len(sl.pages.pages)] = sl.pages.pages
                tok, _ = prefill_chunk(
                    self.cfg, self.params, kp, vp, self._dev(table[i]),
                    sl.prefill_pos, self._dev(buf), n_valid,
                )
                n_prefill += 1
                sl.prefill_pos += n_valid
                sl.seq_len = sl.prefill_pos
                if sl.prefill_pos >= len(prompt):
                    # the last chunk's logits give the first generated
                    # token; int() waits for the device before the clock
                    first = int(tok)
                    t_tok = clock() - t0
                    sl.req.tokens.append(first)
                    sl.req.token_times.append(t_tok)
                    sl.req.first_token = t_tok
                    sl.generated = 1
                    sl.cur_tok = first
                    generated += 1
                    emit("first_token", sl.req)
                    if sl.generated >= sl.req.max_new:
                        _finish(i, t_tok)

            # ---- decode: one batched step over decoding slots ----------
            dec = [
                (i, sl) for i, sl in enumerate(slots)
                if sl is not None
                and sl.prefill_pos >= len(sl.req.prompt)
                and sl.generated < sl.req.max_new
            ]
            if dec:
                active = np.zeros(s_n, bool)
                toks = np.zeros(s_n, np.int64)
                lens = np.zeros(s_n, np.int64)
                for i, sl in dec:
                    if not scfg.reserve_full:
                        sl.pages.ensure(sl.seq_len + 1, pool)
                        table[i, : len(sl.pages.pages)] = sl.pages.pages
                    active[i] = True
                    toks[i] = sl.cur_tok
                    lens[i] = sl.seq_len
                nxt, _ = decode_step(
                    self.cfg, self.params, kp, vp, self._dev(table),
                    self._dev(lens), self._dev(toks), self._dev(active),
                )
                n_decode += 1
                nxt = nxt.cpu().numpy()
                t_tok = clock() - t0
                for i, sl in dec:
                    sl.seq_len += 1
                    sl.generated += 1
                    sl.cur_tok = int(nxt[i])
                    sl.req.tokens.append(sl.cur_tok)
                    sl.req.token_times.append(t_tok)
                    generated += 1
                    if sl.generated >= sl.req.max_new:
                        _finish(i, t_tok)
            _drain_static(clock() - t0)
            step += 1
            emit("step", {
                "step": step,
                "active": sum(1 for sl in slots if sl is not None),
                "waiting": len(waiting) + len(pending),
                "completed": completed,
                "generated": generated,
                "free_pages": pool.free_count,
            })

        wall = clock() - t0
        return RunResult(
            requests=list(requests), steps=step, wall_s=wall,
            generated_tokens=generated, free_pages_start=free_start,
            free_pages_end=pool.free_count, prefill_chunks=n_prefill,
            decode_steps=n_decode,
        )
