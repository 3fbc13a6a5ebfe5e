"""The fused matmul + BN-statistics kernel (K8) and the paged-decode kernel
(K4) on one CUDA card: each design beside variants of its source.

Run from the root of a checkout on a CUDA host:

    python -m tf_operator_tpu_torch.tools.fls_decode_variants [variant ...]

It builds one copy of ``fused_linear_stats.cu`` or ``paged_decode.cu`` per
entry of VARIANTS (all, or those named; a few lines replaced; one ``nvcc``
per copy, all at once, under ``build/torch_kernels/variants/``) and times
each against the others in three turns (device time from
``torch.profiler``, the median). K8 variants run at every distinct shape
of a ResNet-50 step (b 128, 224^2, bf16, no prologue, as resnet_train runs
it), each checked first against the plain version (``chip_smoke.compare_fls``,
the check's limits); the line gives the kernel's time a step (each shape
weighted by its launches) and per shape. K4 variants run at
``chip_smoke.decode_shapes``' two shapes of gqa-2048 (the serve decode step
and a long context), checked against the plain version at
``chip_smoke.KERNEL_ATOL``; the line gives both kernels' time a call. One
JSON line per variant. With ``--resnet`` each K8 variant instead trains
ResNet-50 as resnet_train does (fused_1x1, 9 steps; the losses, and first
those of the unfused run and of the same run through K8's plain version),
beside ``chip_smoke.resnet_disagreement`` with the unfused run (the check
of ``resnet_agreement``), and runs ``chip_smoke.phase_resnet_forward_check``
and ``chip_smoke.phase_resnet_parity`` (their lines, or why they failed):
what the accumulation's rounding does end to end.
Names ``fls_plant_<plant>`` run a fault of ``chip_smoke.FLS_PLANTS`` the
same way (with ``--resnet`` only), to see what the end-to-end checks
catch.
"""

from __future__ import annotations

import json
import os
import statistics
import sys

# The lines the variants replace, as they stand in the sources.
_FLS_STAGES = "constexpr int kMaxStages = 4;"
_FLS_FRESH = "constexpr int kFresh = 2;"
_DECODE_STAGES = "constexpr int kStages = 4;"

# name -> (source in ops/csrc/, [(text in the source, its replacement)]);
# the decode kernel's split count is an argument of its wrapper, so
# DECODE_BLOCKS_PER_SM gives the blocks a launch aims at, per SM, where a
# variant changes it
VARIANTS = {
    "fls_design": ("fused_linear_stats.cu", []),
    # ring depth: as many stages as fit (8 at 128 x 64, 5 at 128 x 128), or 3
    "fls_stages_fit": ("fused_linear_stats.cu", [(_FLS_STAGES, "constexpr int kMaxStages = 8;")]),
    "fls_stages_3": ("fused_linear_stats.cu", [(_FLS_STAGES, "constexpr int kMaxStages = 3;")]),
    # a fresh accumulator every 16 (kFresh 1) or every 64 (a stage) of the
    # depth, not every 32
    "fls_fresh_1": ("fused_linear_stats.cu", [(_FLS_FRESH, "constexpr int kFresh = 1;")]),
    "fls_fresh_4": ("fused_linear_stats.cu", [(_FLS_FRESH, "constexpr int kFresh = 4;")]),
    "decode_design": ("paged_decode.cu", []),
    # a shallower ring: more blocks resident an SM
    "decode_stages_2": ("paged_decode.cu", [(_DECODE_STAGES, "constexpr int kStages = 2;")]),
    "decode_stages_3": ("paged_decode.cu", [(_DECODE_STAGES, "constexpr int kStages = 3;")]),
    # fewer or more splits: 1, 4 or 8 blocks an SM instead of 2
    "decode_blocks_1x": ("paged_decode.cu", []),
    "decode_blocks_4x": ("paged_decode.cu", []),
    "decode_blocks_8x": ("paged_decode.cu", []),
}
DECODE_BLOCKS_PER_SM = {"decode_blocks_1x": 1, "decode_blocks_4x": 4, "decode_blocks_8x": 8}


def fls_cases(dev):
    """[(shape, launches a step, inputs)] at every distinct shape of a
    ResNet-50 step, bf16, no prologue (fls_timing's)."""
    import chip_smoke as cs
    import torch
    from tf_operator_tpu_torch.models.resnet import ResNetConfig

    launches = cs.fused_1x1_shapes(ResNetConfig.resnet50(), cs.RESNET_WL["batch_size"],
                                   cs.RESNET_WL["image_size"])
    gen = torch.Generator(dev).manual_seed(8)
    return [(shape, launches.count(shape), cs.fls_case(gen, *shape, torch.bfloat16, dev, False))
            for shape in sorted(set(launches))]


def time_fls(names, libs, smi):
    import chip_smoke as cs
    from tf_operator_tpu_torch.ops import fused_linear_stats as fls

    cases = fls_cases("cuda")
    res = {n: {c[0]: {"us": [], "rest_us": []} for c in cases} for n in names}
    for turn in (list(names), list(reversed(names)), list(names)):
        for name in turn:
            with cs.fls_planted(libs[name]):
                for shape, _, (x, w, a, b) in cases:
                    r = res[name][shape]
                    if "ok" not in r:
                        errs = cs.compare_fls(x, w, a, b)
                        r["ok"] = all(e <= 1.0 for _, e in errs.values())
                        r["worst_err_over_limit"] = {k: e for k, (_, e) in errs.items()}
                    kern, rest = cs.device_ms_split(
                        lambda i: fls.fused_linear_stats_kernel(x, w), 20, "fls_kernel")
                    r["us"].append(kern * 1e3)
                    r["rest_us"].append(rest * 1e3)
    for name in names:
        shapes = {}
        step = rest = 0.0
        for shape, count, _ in cases:
            r = res[name][shape]
            us = statistics.median(r["us"])
            step += us * count / 1e3
            rest += statistics.median(r["rest_us"]) * count / 1e3
            shapes["x".join(map(str, shape))] = {
                "launches": count, "kernel_us": us, "ok": r["ok"],
                "worst_err_over_limit": r["worst_err_over_limit"], "turns_us": r["us"]}
        print(json.dumps({"variant": name, "card": smi, "kernel_ms_a_step": step,
                          "wrapper_rest_ms_a_step": rest,
                          "all_ok": all(v["ok"] for v in shapes.values()), "shapes": shapes}),
              flush=True)


def time_decode(names, libs, smi):
    import chip_smoke as cs
    import torch
    from tf_operator_tpu_torch.models.transformer import preset
    from tf_operator_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    shapes = cs.decode_shapes(preset("gqa-2048"), dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = {n: DECODE_BLOCKS_PER_SM[n] * sms if n in DECODE_BLOCKS_PER_SM
              else fa.decode_target_blocks(dev) for n in names}
    res = {n: {s: {"runs": []} for s in shapes} for n in names}
    for turn in (list(names), list(reversed(names)), list(names)):
        for name in turn:
            with cs.decode_planted(libs[name]):
                for key, (q, kp, vp, table, lens) in shapes.items():
                    r = res[name][key]
                    L = kp.shape[0]
                    splits = fa.decode_splits(q.shape[0], kp.shape[3], table.shape[1],
                                              blocks[name])
                    if "ok" not in r:
                        got = fa.paged_decode_kernel(q, kp[0], vp[0], table, lens, splits)
                        want = fa.paged_decode_reference(q, kp[0], vp[0], table, lens)
                        r["max_abs_err"] = float((got - want).abs().max())
                        r["ok"] = r["max_abs_err"] <= cs.KERNEL_ATOL

                    def fn(i, q=q, kp=kp, vp=vp, table=table, lens=lens, L=L, splits=splits):
                        return fa.paged_decode_kernel(q, kp[i % L], vp[i % L], table, lens,
                                                      splits)

                    r["runs"].append((cs.device_ms(fn, 100), cs.call_ms(fn, 100)))
    for name in names:
        out = {}
        for k, r in res[name].items():
            # device time where the profiler saw every turn, else CUDA events
            dev_ok = all(x is not None for x, _ in r["runs"])
            us = [1e3 * (x if dev_ok else c) for x, c in r["runs"]]
            out[k] = {"us": statistics.median(us), "ok": r["ok"], "max_abs_err": r["max_abs_err"],
                      "turns_us": us, "source": "device" if dev_ok else "CUDA events per call"}
        print(json.dumps({"variant": name, "card": smi,
                          "blocks": blocks[name], **out}), flush=True)


def resnet_fls(names, libs, smi):
    import chip_smoke as cs
    import torch
    from dataclasses import replace
    from tf_operator_tpu_torch.models.resnet import ResNetConfig
    from tf_operator_tpu_torch.workloads.resnet import run_resnet

    cfg = replace(ResNetConfig.resnet50(int(cs.RESNET_WL["num_classes"])), fused_1x1=True)
    unfused = run_resnet(cs.RESNET_WL, device="cuda", cfg=replace(cfg, fused_1x1=False)).losses
    print(json.dumps({"variant": "unfused", "card": smi, "resnet50_losses": unfused}), flush=True)

    def report(name, losses):
        rel = cs.resnet_disagreement(losses, unfused)
        print(json.dumps({"variant": name, "card": smi, "resnet50_losses": losses,
                          "rel_diff_unfused": rel,
                          "agreement_ok": max(rel) <= cs.RESNET_AGREE_RTOL}), flush=True)

    with cs.plain_fls():  # the same path through K8's plain version: the reference semantics
        report("plain version", run_resnet(cs.RESNET_WL, device="cuda", cfg=cfg).losses)
    for name in names:
        with cs.fls_planted(libs[name]):
            run = run_resnet(cs.RESNET_WL, device="cuda", cfg=cfg)
            report(name, run.losses)
            try:
                cs.phase_resnet_forward_check(run)
            except AssertionError as exc:
                print(json.dumps({"variant": name, "resnet_forward_check_failed": str(exc)}),
                      flush=True)
            del run
            torch.cuda.empty_cache()
            try:
                cs.phase_resnet_parity(torch.device("cuda"))
            except AssertionError as exc:
                print(json.dumps({"variant": name, "resnet_parity_failed": str(exc)}), flush=True)


def run_variants(names=tuple(VARIANTS), resnet=False):
    import chip_smoke as cs
    from tf_operator_tpu_torch.tools.gmm_dw_variants import build_variants

    smi = cs.nvidia_smi()
    table = dict(VARIANTS)
    if resnet:
        table.update({f"fls_plant_{n}": (src, [(old, new)])
                      for n, (_, src, old, new) in cs.FLS_PLANTS.items()})
    timers = (("fls", resnet_fls),) if resnet else (("fls", time_fls), ("decode", time_decode))
    for kernel, timer in timers:
        mine = [n for n in names if n.startswith(kernel + "_")]
        if not mine:
            continue
        source = table[mine[0]][0]
        libs = build_variants(mine, {n: table[n][1] for n in mine}, source=source)
        timer(mine, libs, smi)


if __name__ == "__main__":
    sys.path.insert(0, os.getcwd())
    args = [a for a in sys.argv[1:] if a != "--resnet"]
    run_variants(tuple(args) or tuple(VARIANTS), resnet="--resnet" in sys.argv[1:])
