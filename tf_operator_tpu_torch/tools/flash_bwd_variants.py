"""The flash-attention backward kernels (K2: dq, K3: dk/dv) on one CUDA
card: the design in ``ops/csrc/flash_bwd.cu`` beside variants of it, and
the gqa-2048 training step of a checkout.

Run from the root of a checkout on a CUDA host:

    python -m tf_operator_tpu_torch.tools.flash_bwd_variants [variant ...]
    python -m tf_operator_tpu_torch.tools.flash_bwd_variants --build [variant ...]
    python <this file> --train    # in any checkout: its train step

The first form builds one copy of ``flash_bwd.cu`` per entry of VARIANTS
(all, or those named; a few lines replaced; one ``nvcc`` per copy, all at
once, under ``build/torch_kernels/variants/``), checks each copy's dq, dk
and dv against the plain versions (``chip_smoke.flash_limit``), and times
each kernel alone (device time from ``torch.profiler``, median of three
turns over the variants) at two bf16 causal shapes: gqa-2048's train shape
and moe-small's. One JSON line per (shape, variant). ``--build`` only
builds them and prints each instantiation's registers, spills and nvcc's
wgmma serialisation advisories. ``--train`` runs ``chip_smoke``'s train
and train_breakdown phases on the checkout in the current directory;
alternate it between two checkouts to compare them.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import statistics
import sys
from pathlib import Path

# The lines the variants replace, as they stand in the source.
_DQ_QBUFS = "constexpr int dq_qbufs(int dp) { return dp > 64 ? 1 : 2; }"
_DQ_STAGES = "constexpr int dq_stages(int dp) { return dp > 64 ? 4 : 5; }"
_DKV_STAGES = "constexpr int dkv_stages(int dp) { return dp > 64 ? 2 : 3; }"
_GROUPS = "constexpr int dkv_groups(int dp) { return dp > 64 ? 2 : 1; }"

# name -> [(text in the source, its replacement)]
VARIANTS = {
    "design": [],
    # dq: Q/dO buffers and K/V stages (the design: one buffer and 4 stages
    # at d 128, two and 5 at d 64): 2 stages at both; two buffers and 3
    # stages at d 128; one buffer and 6 stages at d 64
    "dq_stages_2": [(_DQ_STAGES, "constexpr int dq_stages(int dp) { return 2; }")],
    "dq_two_q_stages_3": [(_DQ_QBUFS, "constexpr int dq_qbufs(int dp) { return 2; }"),
                          (_DQ_STAGES,
                           "constexpr int dq_stages(int dp) { return dp > 64 ? 3 : 5; }")],
    "dq_one_q_stages_6": [(_DQ_QBUFS, "constexpr int dq_qbufs(int dp) { return 1; }"),
                          (_DQ_STAGES,
                           "constexpr int dq_stages(int dp) { return dp > 64 ? 4 : 6; }")],
    # dk/dv: Q/dO stages (the design: 2 at d 128, 3 at d 64)
    "dkv_stages_4_5": [(_DKV_STAGES,
                        "constexpr int dkv_stages(int dp) { return dp > 64 ? 4 : 5; }")],
    # dk/dv: an item of 128 keys, two consumer warpgroups (the design at d
    # 128), or of 64 keys, one consumer warpgroup a block and two blocks an
    # SM (the design at d 64; each Q/dO tile then serves 64 keys), at both
    "dkv_keys_128": [(_GROUPS, "constexpr int dkv_groups(int dp) { return 2; }"),
                     (_DKV_STAGES, "constexpr int dkv_stages(int dp) { return dp > 64 ? 2 : 3; }")],
    "dkv_keys_64": [(_GROUPS, "constexpr int dkv_groups(int dp) { return 1; }")],
    # dq: one query head x 128 positions an item whatever the group size
    "dq_no_fold": [("const int fold = (h / h_kv) % 2 == 0;", "const int fold = 0;")],
    # both: each product waited for before the next is issued (dq: the next
    # tile's S and dP after dS.K; dk/dv: dP^T after dV, dS^T from P^T's
    # bf16 fragments after it)
    "no_overlap": [("constexpr bool kOverlap = true;", "constexpr bool kOverlap = false;")],
    # both: items dealt round robin (block p takes p, p + G, p + 2G, ...)
    "round_robin": [("return round * G + ((round & 1) ? G - 1 - p : p);",
                     "return round * G + p;")],
}

# (b, t, h, h_kv, d): gqa-2048's train shape and moe-small's attention
SHAPES = {"gqa2048": (6, 2048, 16, 4, 128), "moe_small": (16, 512, 12, 12, 64)}


def variant_source(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"variant edit: the line occurs {text.count(old)} times: {old[:60]}")
        text = text.replace(old, new)
    return text


def build_variants(names):
    """name -> (loaded library, nvcc's output) of each variant."""
    from tf_operator_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        (out / header.name).write_text(header.read_text())
    src = (_build.CSRC / "flash_bwd.cu").read_text()
    jobs = {}
    for name in names:
        (out / f"bwd_{name}.cu").write_text(variant_source(src, VARIANTS[name]))
        jobs[name] = (out / f"bwd_{name}.cu", out / f"bwd_{name}.so")
    logs = _build.compile_sources(jobs)
    return {name: (ctypes.CDLL(str(out / f"bwd_{name}.so")), logs[name][1]) for name in names}


def build_report(log):
    """{instantiation: registers and spills, the serialisation advisories
    and all of ptxas's wgmma notes (C75xx)} from nvcc's output."""
    import chip_smoke as cs

    usage = cs.ptxas_usage(log)
    out = {}
    for key, piece in cs.BWD_INSTANCES.items():
        found = [u for fn, u in usage.items() if piece in fn]
        out[key] = {**(found[0] if found else {}),
                    "advisories": len(cs.wgmma_advisories(log, piece)),
                    "c75_notes": sum("(C75" in ln and piece in ln for ln in log.splitlines())}
    return out


@contextlib.contextmanager
def routed(lib):
    """Both backward wrappers routed to library ``lib``."""
    import chip_smoke as cs

    with cs.planted(lib, "dq"), cs.planted(lib, "dkv"):
        yield


def run_variants(names=tuple(VARIANTS), shapes=SHAPES):
    import chip_smoke as cs
    import numpy as np
    import torch
    from tf_operator_tpu_torch.ops import flash_attention as fa

    built = build_variants(names)
    smi = cs.nvidia_smi()
    rng = np.random.RandomState(7)
    for shape_name, (b, t, h, h_kv, d) in shapes.items():
        q, k, v, do, dlse = cs.flash_case(rng, b, t, h, h_kv, d, torch.bfloat16, "cuda")
        o, lse = fa.flash_fwd_kernel(q, k, v, True)
        lse_k, delta = fa.lse_kernel_layout(lse), fa.flash_delta(o, do, dlse)
        f32 = [x.float() for x in (q, k, v, do)]
        want = {"dq": fa.flash_bwd_dq_reference(*f32, lse_k, delta, True),
                **dict(zip(("dk", "dv"), fa.flash_bwd_dkv_reference(*f32, lse_k, delta, True)))}
        del f32
        fns = {"dq": lambda i: fa.flash_bwd_dq_kernel(q, k, v, do, lse_k, delta, True),
               "dkv": lambda i: fa.flash_bwd_dkv_kernel(q, k, v, do, lse_k, delta, True)}
        res = {n: {"dq_us": [], "dkv_us": []} for n in names}
        for turn in (list(names), list(reversed(names)), list(names)):
            for name in turn:
                r = res[name]
                with routed(built[name][0]):
                    if "ok" not in r:
                        got = {"dq": fns["dq"](0), **dict(zip(("dk", "dv"), fns["dkv"](0)))}
                        ratio = max(float(((got[x].float() - want[x]).abs()
                                           / cs.flash_limit(x, want[x], torch.bfloat16)).max())
                                    for x in got)
                        r["ok"], r["worst_err_over_limit"] = ratio <= 1.0, ratio
                        del got
                    for kind, kernel in (("dq", "dq_kernel"), ("dkv", "dkv_kernel")):
                        kern, _ = cs.device_ms_split(fns[kind], 20, kernel)
                        r[f"{kind}_us"].append(kern * 1e3)
        work = cs.flash_work(b, t, h, h_kv, d)
        for name in names:
            r = res[name]
            us = {kind: statistics.median(r[f"{kind}_us"]) for kind in ("dq", "dkv")}
            print(json.dumps({"shape": shape_name, "b": b, "t": t, "h": h, "h_kv": h_kv, "d": d,
                              "variant": name, "ok": r["ok"],
                              "worst_err_over_limit": r["worst_err_over_limit"],
                              **{f"{kind}_us": us[kind] for kind in us},
                              "pair_us": us["dq"] + us["dkv"],
                              **{f"{kind}_tflops": work[kind][0] / us[kind] / 1e6 for kind in us},
                              "turns_us": {kind: r[f"{kind}_us"] for kind in us},
                              "build": build_report(built[name][1]), "card": smi}),
                  flush=True)
        del q, k, v, do, o, lse, lse_k, delta, want
        torch.cuda.empty_cache()


def run_train():
    """train and train_breakdown of the checkout in the current directory
    (its own chip_smoke and package)."""
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from tf_operator_tpu_torch.ops import _build

    print(json.dumps({"checkout": str(Path.cwd())}), flush=True)
    _build.build()
    smi = cs.nvidia_smi()
    run, _ = cs.phase_train(smi)
    cs.phase_train_breakdown(run, smi)


if __name__ == "__main__":
    args = sys.argv[1:]
    if "--train" in args:
        run_train()
    else:
        sys.path.insert(0, os.getcwd())
        names = tuple(a for a in args if a != "--build") or tuple(VARIANTS)
        if "--build" in args:
            for name, (_, log) in build_variants(names).items():
                print(json.dumps({"variant": name, "build": build_report(log)}), flush=True)
        else:
            run_variants(names)
