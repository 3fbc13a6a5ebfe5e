"""The MoE forward grouped-matmul kernels (K5, its dx form, K6) on one CUDA
card: the design in ``ops/csrc/grouped_matmul.cu`` beside variants of it.

Run from the root of a checkout on a CUDA host:

    python -m tf_operator_tpu_torch.tools.gmm_fwd_variants [variant ...]

It builds one copy of ``grouped_matmul.cu`` per entry of VARIANTS (all, or
those named; a few lines replaced; one ``nvcc`` per copy, all at once,
under ``build/torch_kernels/variants/``), checks each copy's outputs
against the plain version (``chip_smoke.gmm_limit``, bf16) and times the
forward kernel alone (device time from ``torch.profiler``, median of three
turns over the variants) at the four forward launches of a moe-small step,
on gmm_timing's routed block map (8192 tokens over 8 experts, 10240 rows):
K5 d -> f (gate, up), K6 f -> d (down, row-scaled), and the dx form f -> d
(gate, up) and d -> f (the down product's t). One JSON line per variant.
To compare the moe-small step of two checkouts, alternate
``python <checkout>/tf_operator_tpu_torch/tools/gmm_dw_variants.py --moe``
between them.
"""

from __future__ import annotations

import json
import os
import statistics
import sys

# The lines the variants replace, as they stand in the source.
_STAGES = "constexpr int kFwdStages = 4;"
_EPI = "constexpr int kEpiCols = 128;"
_FN = "constexpr int kFN = 256;"
_TMA_STORE = "static constexpr bool tma_store = !split;"
_GRID = "const int blocks = items < sms ? items : sms;"
_ORDER = "  w.m0 = i / tiles_n * kBM;\n  w.n0 = i % tiles_n * kFN;\n"

# name -> [(text in the source, its replacement)]. Shared memory holds the
# ring (48 KB a stage at 128 x 256, 32 KB at 128 x 128) and, for TMA
# stores, 2 x 64 rows x kEpiCols of bf16: 5 stages of a 128 x 256 tile do
# not fit in the 227 KB a block may take, so 5 stages are measured at 128 x
# 128.
VARIANTS = {
    "design": [],
    # y stored in one round of 256 columns a warpgroup (3 x 48 + 64 KB)
    "stages_3": [(_STAGES, "constexpr int kFwdStages = 3;"),
                 (_EPI, "constexpr int kEpiCols = 256;")],
    "tile_128x128_stages_4": [(_FN, "constexpr int kFN = 128;")],
    "tile_128x128_stages_5": [(_FN, "constexpr int kFN = 128;"),
                              (_STAGES, "constexpr int kFwdStages = 5;")],
    "tile_128x128_stages_6": [(_FN, "constexpr int kFN = 128;"),
                              (_STAGES, "constexpr int kFwdStages = 6;")],
    # bf16 tiles stored from registers (4-byte stores), no epilogue buffer
    "direct_stores": [(_TMA_STORE, "static constexpr bool tma_store = false;")],
    # one block for each item
    "not_persistent": [(_GRID, "const int blocks = items;")],
    # items numbered column tile by column tile: a round's items run down
    # the rows of every expert, not along one expert's row tiles
    "round_robin": [(_ORDER, "  w.m0 = i % tiles_m * kBM;\n  w.n0 = i / tiles_m * kFN;\n")],
}


def cases(dev, E=8, B=256, d=768, f=3072, tokens=8192):
    """name -> (kernel call, plain result in f32, 2 x the products' flops):
    the four forward launches of a moe-small step at gmm_timing's shapes."""
    import chip_smoke as cs
    import numpy as np
    import torch
    from tf_operator_tpu_torch.ops import grouped_matmul as gm

    be, valid, _ = cs.routed_block_map(np.random.RandomState(8), tokens, E, B, dev)
    R = be.numel() * B
    gen = torch.Generator(dev).manual_seed(8)
    bf = torch.bfloat16

    def draw(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale).to(bf)

    x, h = draw(R, d), draw(R, f)
    w_up, w_down = draw(E, d, f, scale=d**-0.5), draw(E, f, d, scale=f**-0.5)
    dy_up, dy_down = draw(R, f) * valid[:, None], draw(R, d) * valid[:, None]
    s = torch.rand(R, device=dev, generator=gen) * valid
    rows = int((be >= 0).sum()) * B
    calls = {
        "k5": (x, w_up, None, False), "k6": (h, w_down, s, False),
        "k5_dx_f_to_d": (dy_up, w_up, None, True), "k5_dx_d_to_f": (dy_down, w_down, None, True),
    }
    out = {}
    for name, (a, w, sc, trans) in calls.items():
        want = gm.gmm_fwd_reference(a.float(), w.float(), be, sc, block_rows=B, trans_w=trans)
        out[name] = ((lambda i, a=a, w=w, sc=sc, trans=trans: gm.gmm_fwd_kernel(
            a, w, be, sc, block_rows=B, trans_w=trans)), want, 2 * rows * d * f)
    return out


def run_variants(names=tuple(VARIANTS)):
    import chip_smoke as cs
    import torch
    from tf_operator_tpu_torch.tools.gmm_dw_variants import build_variants

    libs = build_variants(names, VARIANTS, prefix="fwd_")
    smi = cs.nvidia_smi()
    calls = cases("cuda")
    res = {n: {k: {"us": []} for k in calls} for n in names}
    for turn in (list(names), list(reversed(names)), list(names)):
        for name in turn:
            with cs.gmm_planted(libs[name]):
                for k, (fn, want, _) in calls.items():
                    r = res[name][k]
                    if "ok" not in r:
                        err = (fn(0).float() - want).abs()
                        limit = cs.gmm_limit(want, torch.bfloat16, (-1,))
                        r["ok"] = bool((err <= limit).all())
                        r["worst_err_over_limit"] = float(
                            torch.where(err == 0, 0.0, err / limit).max())
                    kern, _ = cs.device_ms_split(fn, 20, "fwd_kernel")
                    r["us"].append(kern * 1e3)
    for name in names:
        out = {}
        for k, r in res[name].items():
            us = statistics.median(r["us"])
            out[k] = {"ok": r["ok"], "worst_err_over_limit": r["worst_err_over_limit"],
                      "kernel_us": us, "tflops": calls[k][2] / us / 1e6, "turns_us": r["us"]}
        print(json.dumps({"variant": name, "card": smi, **out}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.getcwd())
    run_variants(tuple(sys.argv[1:]) or tuple(VARIANTS))
