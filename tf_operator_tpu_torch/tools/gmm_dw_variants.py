"""The MoE weight-gradient kernels (K7a, K7b) on one CUDA card: the design
in ``ops/csrc/grouped_matmul.cu`` beside variants of it, and the moe-small
training step of a checkout.

Run from the root of a checkout on a CUDA host:

    python -m tf_operator_tpu_torch.tools.gmm_dw_variants
    python <this file> --moe    # in any checkout: its moe_train step

The first form builds one copy of ``grouped_matmul.cu`` per entry of
VARIANTS (a few lines replaced; one ``nvcc`` per copy, all at once, under
``build/torch_kernels/variants/``), checks each copy's dw against the plain
version (``chip_smoke.gmm_limit``) and times the dw kernel alone and the
wrapper's block-list ops (device time from ``torch.profiler``, median of
three turns over the variants) at two bf16 block maps of moe_train's
shapes: gmm_timing's routed map, and one where every expert has 5 blocks.
One JSON line per (map, variant). ``--moe`` runs ``chip_smoke``'s
moe_train and moe_train_breakdown phases on the checkout in the current
directory; alternate it between two checkouts to compare them.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import sys
from pathlib import Path

# the widths hopper.cuh defines Wgmma<N> for
HEADER_WIDTHS = (64, 128, 256)

# The lines the variants replace, as they stand in the source.
_PLAN = """  const int count = plan_items(reinterpret_cast<int*>(smem + L::plan), nblocks, E, tiles,
                               block_rows / kDepth);  // synchronises the block
"""
_PRODUCER_LOOP = """      for (int j = 0; j < count; ++j) {
        const int item = mine[j], e = item / tiles, rest = item - e * tiles;"""
_CONSUMER_LOOP = """  for (int j = 0; j < count; ++j) {
    const int item = mine[j], e = item / tiles, rest = item - e * tiles;"""
_STAGES = "static constexpr int stages = Planes<T>::value == 1 ? 4 : 1;"
_SCALE = """        if constexpr (SCALED) {
          scale_box(stage + wg * kPlaneBox, ss, t);
          fence_async_smem();  // the generic stores, before wgmma's reads
          bar_sync(2 + wg, 128);
        }
        const uint32_t a = base + st * L::stage;
        wgmma_fence();
        stage_products(acc, a + wg * kPlaneBox, a + kXBoxes * kPlaneBox);
        wgmma_commit();"""
_RELEASE = """        wgmma_wait<1>();
        if (step > 0 && t == 0) mbar_arrive(empty + 8 * ((it - 1) % L::stages));"""
_LAST_RELEASE = (
    "    if (!kSplit && w.steps > 0 && t == 0) mbar_arrive(empty + 8 * ((it - 1) % L::stages));")
_DESC = "return hopper::sw128_desc(addr, kPlaneBox, 1024);"
WIDTH = "WGMMA_WIDTH"


def _narrow(n: int, stages: int) -> list:
    """A 128 x n tile (n / 64 dy boxes) with `stages` stages."""
    return [("constexpr int kTN = 256;", f"constexpr int kTN = {n};"),
            (_STAGES, _STAGES.replace("? 4 :", f"? {stages} :")),
            (WIDTH, n)]


# name -> [(text in the source, its replacement)]; (WIDTH, n) defines
# hopper::Wgmma<n> in the source where hopper.cuh does not.
VARIANTS = {
    "design": [],
    # each block takes items blockIdx.x, blockIdx.x + gridDim.x, ... (no plan)
    "static_order": [
        (_PLAN, "  __syncthreads();\n"),
        (_PRODUCER_LOOP, """      for (int item = blockIdx.x; item < E * tiles; item += gridDim.x) {
        const int e = item / tiles, rest = item - e * tiles;"""),
        (_CONSUMER_LOOP, """  for (int item = blockIdx.x; item < E * tiles; item += gridDim.x) {
    const int e = item / tiles, rest = item - e * tiles;"""),
    ],
    "stages_3": [(_STAGES, _STAGES.replace("? 4 :", "? 3 :"))],
    "depth_32_stages_8": [("constexpr int kDepth = 64;", "constexpr int kDepth = 32;"),
                          (_STAGES, _STAGES.replace("? 4 :", "? 8 :"))],
    "tile_128x192_stages_5": _narrow(192, 5),
    "tile_128x128_stages_6": _narrow(128, 6),
    # half as many persistent blocks: each takes about twice the stages
    "half_grid": [("dim3(grid)", "dim3((grid + 1) / 2)")],
    # a slot goes back once its own products are done (no product in flight
    # across stages within a warpgroup)
    "release_after_wait0": [(_RELEASE, """        wgmma_wait<0>();
        if (t == 0) mbar_arrive(empty + 8 * st);"""), (_LAST_RELEASE, "")],
    # K7b: scale the next stage's x box while this stage's products run
    "scale_next_stage": [(_SCALE, """        if (SCALED && step == 0) {
          scale_box(stage + wg * kPlaneBox, ss, t);
          fence_async_smem();
          bar_sync(2 + wg, 128);
        }
        const uint32_t a = base + st * L::stage;
        wgmma_fence();
        stage_products(acc, a + wg * kPlaneBox, a + kXBoxes * kPlaneBox);
        wgmma_commit();
        if (SCALED && step + 1 < w.steps) {
          const int nt = (it + 1) % L::stages;
          mbar_wait(full + 8 * nt, ((it + 1) / L::stages) & 1);
          scale_box(smem + nt * L::stage + wg * kPlaneBox, scales + nt * kDepth, t);
          fence_async_smem();
          bar_sync(2 + wg, 128);
        }""")],
    # the descriptors' LBO and SBO swapped: must fail the check
    "lbo_sbo_swapped": [(_DESC, "return hopper::sw128_desc(addr, 1024, kPlaneBox);")],
}


def variant_source(text: str, edits) -> str:
    for old, new in edits:
        if old == WIDTH:
            if new not in HEADER_WIDTHS:
                from tf_operator_tpu_torch.tools.wgmma_source import with_widths

                text = with_widths(text, [new])
            continue
        if text.count(old) != 1:
            raise ValueError(f"variant edit: the line occurs {text.count(old)} times: {old[:60]}")
        text = text.replace(old, new)
    return text


def build_variants(names, variants=VARIANTS, prefix=""):
    """name -> loaded library of each named copy of grouped_matmul.cu, its
    edits from ``variants``, built under build/torch_kernels/variants/ as
    ``<prefix><name>``."""
    from tf_operator_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        (out / header.name).write_text(header.read_text())
    src = (_build.CSRC / "grouped_matmul.cu").read_text()
    jobs = {}
    for name in names:
        (out / f"{prefix}{name}.cu").write_text(variant_source(src, variants[name]))
        jobs[name] = (out / f"{prefix}{name}.cu", out / f"{prefix}{name}.so")
    _build.compile_sources(jobs)
    return {name: ctypes.CDLL(str(out / f"{prefix}{name}.so")) for name in names}


def block_maps(dev, E=8, B=256):
    """name -> (block_expert, valid rows): gmm_timing's routed map (8192
    tokens, seed 8) and a map of 5 blocks an expert."""
    import chip_smoke as cs
    import numpy as np
    import torch

    be, valid, _ = cs.routed_block_map(np.random.RandomState(8), 8192, E, B, dev)
    equal = torch.arange(E, device=dev, dtype=torch.int32).repeat_interleave(5)
    return {"routed": (be, valid),
            "equal_walks": (equal, torch.ones(equal.numel() * B, dtype=torch.bool, device=dev))}


def run_variants(names=tuple(VARIANTS), E=8, B=256, d=768, f=3072):
    import chip_smoke as cs
    import torch
    from tf_operator_tpu_torch.ops import grouped_matmul as gm

    dev = "cuda"
    libs = build_variants(names)
    smi = cs.nvidia_smi()
    gen = torch.Generator(dev).manual_seed(8)
    bf = torch.bfloat16
    for map_name, (be, valid) in block_maps(dev, E, B).items():
        R = be.numel() * B
        x = torch.randn(R, d, device=dev, generator=gen).to(bf)
        h = torch.randn(R, f, device=dev, generator=gen).to(bf)
        dy_up = (torch.randn(R, f, device=dev, generator=gen) * valid[:, None]).to(bf)
        dy_down = (torch.randn(R, d, device=dev, generator=gen) * valid[:, None]).to(bf)
        s = torch.rand(R, device=dev, generator=gen) * valid
        calls = {"k7a": (lambda i: gm.gmm_dw_kernel(x, dy_up, be, E, block_rows=B),
                         gm.gmm_dw_reference(x, dy_up, be, E, block_rows=B)),
                 "k7b": (lambda i: gm.gmm_dw_kernel(h, dy_down, be, E, s, block_rows=B),
                         gm.gmm_dw_reference(h, dy_down, be, E, s, block_rows=B))}
        res = {n: {k: {"us": []} for k in calls} for n in names}
        for turn in (list(names), list(reversed(names)), list(names)):
            for name in turn:
                with cs.gmm_planted(libs[name]):
                    for k, (fn, want) in calls.items():
                        r = res[name][k]
                        if "ok" not in r:
                            err = (fn(0) - want).abs()
                            r["ok"] = bool((err <= cs.gmm_limit(want, bf, (1, 2))).all())
                            r["worst_err_over_limit"] = float(
                                (err / cs.gmm_limit(want, bf, (1, 2))).max())
                        kern, rest = cs.device_ms_split(fn, 20, "dw_kernel")
                        r["us"].append(kern * 1e3)
                        r["block_lists_us"] = rest * 1e3
        for name in names:
            out = {k: {"ok": r["ok"], "worst_err_over_limit": r["worst_err_over_limit"],
                       "kernel_us": statistics.median(r["us"]), "turns_us": r["us"],
                       "block_lists_us": r["block_lists_us"]} for k, r in res[name].items()}
            print(json.dumps({"map": map_name, "variant": name, "card": smi, **out}),
                  flush=True)


def run_moe():
    """moe_train and moe_train_breakdown of the checkout in the current
    directory (its own chip_smoke and package)."""
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from tf_operator_tpu_torch.ops import _build

    print(json.dumps({"checkout": str(Path.cwd())}), flush=True)
    _build.build()
    smi = cs.nvidia_smi()
    run, _ = cs.phase_train(smi, cs.MOE_WL, per_layer=cs.MOE_PER_LAYER, phase="moe_train")
    cs.phase_train_breakdown(run, smi, phase="moe_train_breakdown")


if __name__ == "__main__":
    if "--moe" in sys.argv[1:]:
        run_moe()
    else:
        sys.path.insert(0, os.getcwd())
        run_variants()
