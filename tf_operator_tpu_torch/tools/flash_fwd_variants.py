"""The flash-attention forward kernel (K1) on one CUDA card: the design in
``ops/csrc/flash_fwd.cu`` beside variants of it, and the gqa-2048 training
step of a checkout.

Run from the root of a checkout on a CUDA host:

    python -m tf_operator_tpu_torch.tools.flash_fwd_variants [variant ...]
    python <this file> --train    # in any checkout: its train step

The first form builds one copy of ``flash_fwd.cu`` per entry of VARIANTS
(all, or those named; a few lines replaced; one ``nvcc`` per copy, all at once, under
``build/torch_kernels/variants/``), checks each copy's o and lse against
the plain version (``chip_smoke.flash_limit``), and times the kernel alone
(device time from ``torch.profiler``, median of three turns over the
variants) at two bf16 causal shapes: gqa-2048's train shape and
moe-small's. One JSON line per (shape, variant). ``--train`` runs
``chip_smoke``'s train and train_breakdown phases on the checkout in the
current directory; alternate it between two checkouts to compare them.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import sys
from pathlib import Path

# The lines the variants replace, as they stand in the source.
_STAGES = "constexpr int kStages = 5;"
_KT = "static constexpr int KT = 64;"
_FOLD = "const int fold = (h / h_kv) % 2 == 0;"
_EDGE = "const bool edge = k0 + KT > t || (causal && k0 + KT - 1 > pw);"
_GRID = "const int grid = items < sms ? (int)items : sms;"
_KV_OF_END = """      return L::split ? base + L::planes : base + L::ring + (it % L::stages) * L::stage;
    };
"""
_S0 = """      hopper::wgmma_fence();
      qk_products<P, DP, KT>(s, qa, kv_of(it), L::qbox, L::kvbox, L::qplane, L::kvplane);
      hopper::wgmma_commit();
"""
_STEP_FENCE = """        const uint32_t vb = kv_of(it) + L::boxes * L::kvbox;
        hopper::wgmma_fence();
"""
_PV_COMMIT = """        hopper::wgmma_commit();
        if constexpr (decltype(more)::value) {
          hopper::wgmma_wait<1>();"""
_RESCALE = """#pragma unroll
        for (int x = 0; x < DP / 8; ++x) {
          acc[4 * x] *= a[0];
          acc[4 * x + 1] *= a[0];
          acc[4 * x + 2] *= a[1];
          acc[4 * x + 3] *= a[1];
        }
"""
# FA3's ping-pong (bf16): the warpgroups take turns to issue their products
# (named barriers 2 and 3), warpgroup 0 first; warpgroup 1 passes no turn
# after the block's last
_TURN = "        if (!L::split) hopper::bar_sync(2 + wg, 256);\n"
_PINGPONG = [
    (_KV_OF_END, _KV_OF_END + "    if (!L::split && wg == 1) hopper::bar_arrive(2, 256);\n"),
    (_S0, _TURN[2:] + _S0 + "      if (!L::split) hopper::bar_arrive(3 - wg, 256);\n"),
    (_STEP_FENCE, _STEP_FENCE.replace("        hopper::wgmma_fence();\n",
                                      _TURN + "        hopper::wgmma_fence();\n")),
    (_PV_COMMIT, _PV_COMMIT.replace(
        "        hopper::wgmma_commit();\n",
        "        hopper::wgmma_commit();\n"
        "        if (!L::split && !(wg == 1 && !decltype(more)::value &&\n"
        "                           item_index(n + 1, blockIdx.x, gridDim.x) >= items))\n"
        "          hopper::bar_arrive(3 - wg, 256);\n")),
]

# name -> [(text in the source, its replacement)]
VARIANTS = {
    "design": [],
    "stages_2": [(_STAGES, "constexpr int kStages = 2;")],
    "stages_4": [(_STAGES, "constexpr int kStages = 4;")],
    # 128 keys a bf16 tile (f32 keeps 64: its planes would not fit) in two
    # stages, as many as fit beside Q's two buffers
    "key_tile_128": [(_KT, "static constexpr int KT = split ? 64 : 128;"),
                     (_STAGES, "constexpr int kStages = 2;")],
    # one block for each item (query block x head pair), heaviest first
    "not_persistent": [(_GRID, "const int grid = (int)items;")],
    # items dealt round robin (block p takes p, p + G, p + 2G, ...)
    "round_robin": [("return round * G + ((round & 1) ? G - 1 - p : p);",
                     "return round * G + p;")],
    # one query head x 128 positions an item whatever the group size
    "no_fold": [(_FOLD, "const int fold = 0;")],
    "pingpong": _PINGPONG,
    # O rescaled only where some row of the warp has a new max
    "rescale_when_moved": [
        (_RESCALE, "        if (__any_sync(0xffffffffu, a[0] != 1.f || a[1] != 1.f)) {\n"
         + _RESCALE + "        }\n")],
    # the mask on every tile, not only those that cross the diagonal or t
    "mask_every_tile": [(_EDGE, "const bool edge = true;")],
    # exp2 through exp2f (its range fix-up around the MUFU instruction)
    "exp2f": [("asm(\"ex2.approx.ftz.f32 %0, %1;\" : \"=f\"(y) : \"f\"(x));",
               "y = exp2f(x);")],
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
    from tf_operator_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        (out / header.name).write_text(header.read_text())
    src = (_build.CSRC / "flash_fwd.cu").read_text()
    jobs = {}
    for name in names:
        (out / f"fwd_{name}.cu").write_text(variant_source(src, VARIANTS[name]))
        jobs[name] = (out / f"fwd_{name}.cu", out / f"fwd_{name}.so")
    _build.compile_sources(jobs)
    return {name: ctypes.CDLL(str(out / f"fwd_{name}.so")) for name in names}


def run_variants(names=tuple(VARIANTS), shapes=SHAPES):
    import chip_smoke as cs
    import numpy as np
    import torch
    from tf_operator_tpu_torch.ops import flash_attention as fa

    libs = build_variants(names)
    smi = cs.nvidia_smi()
    rng = np.random.RandomState(7)
    for shape_name, (b, t, h, h_kv, d) in shapes.items():
        q, k, v, _, _ = cs.flash_case(rng, b, t, h, h_kv, d, torch.bfloat16, "cuda")
        o_ref, lse_ref = fa.flash_fwd_reference(q.float(), k.float(), v.float(), True)
        fn = lambda i: fa.flash_fwd_kernel(q, k, v, True)  # noqa: E731
        res = {n: {"us": []} for n in names}
        for turn in (list(names), list(reversed(names)), list(names)):
            for name in turn:
                r = res[name]
                with cs.planted(libs[name], "fwd"):
                    if "ok" not in r:
                        o, lse = fn(0)
                        ratio = max(
                            float(((o.float() - o_ref).abs()
                                   / cs.flash_limit("o", o_ref, torch.bfloat16)).max()),
                            float(((lse - lse_ref).abs()
                                   / cs.flash_limit("lse", lse_ref, torch.bfloat16)).max()))
                        r["ok"], r["worst_err_over_limit"] = ratio <= 1.0, ratio
                    kern, _ = cs.device_ms_split(fn, 20, "fwd_kernel")
                    r["us"].append(kern * 1e3)
        ops = 4 * d * (b * h * t * (t + 1) // 2)
        for name in names:
            r = res[name]
            us = statistics.median(r["us"])
            print(json.dumps({"shape": shape_name, "b": b, "t": t, "h": h, "h_kv": h_kv, "d": d,
                              "variant": name, "ok": r["ok"],
                              "worst_err_over_limit": r["worst_err_over_limit"],
                              "kernel_us": us, "tflops": ops / us / 1e6, "turns_us": r["us"],
                              "card": smi}), flush=True)
        del q, k, v, o_ref, lse_ref
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
    if "--train" in sys.argv[1:]:
        run_train()
    else:
        sys.path.insert(0, os.getcwd())
        run_variants(tuple(sys.argv[1:]) or tuple(VARIANTS))
