#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths (dense, MoE and
ResNet) on one NVIDIA GPU and check them.

Usage, from the root of a checkout, on a host with one CUDA card:

    python3 chip_smoke.py

Builds the port's CUDA kernels from the checkout's sources, and the
planted-fault copies of phases 8, 14 and 20, all at once (one ``nvcc`` per
source), then prints one JSON line per phase. Serving path:

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
   and not, t of 128, 200 and 2048; moe-small's heads, 12 / 12 at d 64,
   causal, t 512 and 2048; f32 and bf16, a nonzero lse cotangent).
8. ``flash_plant``: copies of the flash sources, each with one planted
   fault (a key tile dropped for the last rows of o or dq, a causal mask
   off by one, a query tile dropped from dK/dV, a K-major depth step or an
   MN-major reduction step of a forward or backward product stepped
   wrong), built and run at t 2048: the check of phase 7 must fail on
   each, in bf16 and in f32.
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
    that computes dq, dk and dv in one call), then at moe-small's
    attention shape; each kernel instantiation's wgmma and TMA
    instructions (which must be there), registers and spills (which must
    be none) and nvcc's wgmma serialisation advisories (which must be
    none).

MoE training path:

13. ``gmm_check``: the four grouped-matmul kernels (forward, forward with
    row scale, dw, dw with row scale) and the forward on transposed
    weights (the dx use) against their plain versions, element by
    element, in bf16 and f32: moe-small's gate/up (768 -> 3072) and down
    (3072 -> 768) products at 10240 routed rows with an expert that gets
    no token (padding rows carry zero cotangents and scales, as in the
    model), and a map with sentinel blocks, experts without blocks and
    interleaved blocks of one expert at widths off the tile grid.
    Sentinel rows and the dw of an expert without tokens must be exact
    zeros.
14. ``gmm_plant``: copies of the grouped-matmul source, each with one
    planted fault (a sentinel block computed instead of zeroed, a dw walk
    that skips an expert's last block, the weights of the neighbouring
    expert, K7b's scale read from the next row, the dw products stepping
    through their MN-major tiles by columns): the check of phase 13 must
    fail on each, in bf16 and in f32.
15. ``moe_train``: ``moe-small`` at full width and depth (b 16, t 512,
    flash attention, full remat, bf16, AdamW; 8 experts, top-1, gmm
    dispatch), one warmup and 8 timed steps through ``run_lm``: per layer
    and step exactly 7 / 2 / 2 / 1 launches of the four grouped-matmul
    kernels and 2 / 1 / 1 of the flash kernels; finite and falling loss;
    the router health line; step time, tokens/s, MFU on the active params
    and peak memory.
16. ``moe_train_breakdown``: as phase 10, the grouped-matmul kernels a
    family of their own.
17. ``moe_parity``: moe-small width at 2 layers, t 256: f32 loss, MoE
    metrics and grads on the card against the CPU, and 3 bf16 steps with
    the kernels against 3 with the plain versions.
18. ``gmm_timing``: the four kernels at the moe_train shapes beside their
    bounds, their plain versions and ``torch._grouped_mm`` on the same
    expert groups (or one ``torch.mm`` of the same FLOPs where the card's
    PyTorch lacks it or it disagrees, which the line says); for K7b also
    the two calls that compute its function (scale x, then
    ``torch._grouped_mm``). For the dw kernels (K7a, K7b): the dw kernel's
    and the wrapper's block-list ops' device time apart, the wgmma
    (HGMMA) and TMA (UTMALDG, UBLKCP) instructions in their SASS
    (``cuobjdump``, which must find both), their registers and spills
    from the build log, their tile and the operand bytes a launch.

ResNet training path:

19. ``fls_check``: the fused matmul + BN-statistics kernel (K8) against
    its plain version, element by element, in bf16 and f32, with and
    without the prologue: every distinct (M, K, N) of ResNet-50's 1x1
    convolutions at b 128, 224^2 (15 shapes) and shapes off the tile grid.
    y within the flash limits; each column's sum within FLS_STATS_C
    (by dtype) eps_f32 sum|y| and its sum of squares within as many eps_f32
    of sum y^2.
20. ``fls_plant``: copies of the K8 source, each with one planted fault
    (the last row tile left out of the statistics, the statistics taken
    from the bf16-rounded y, the prologue's ReLU dropped): the check of
    phase 19 must fail on each by 10x its limit or more.
21. ``resnet_train``: ResNet-50 at full width and depth (b 128, 224^2,
    bf16, ``fused_1x1``, SGD momentum 0.9, lr 0.1, "var" statistics
    gradient, fixed data), one warmup and 8 timed steps through
    ``run_resnet``: exactly 36 K8 launches a step, finite and falling
    loss; step time, images/s, MFU and peak memory. Then the same with
    ``fused_1x1`` off (cuDNN 1x1 convolutions, the plain BN path).
22. ``resnet_breakdown``: as phase 10, with K8, cuDNN convolutions, the
    elementwise work and the SGD update as families of their own; then the
    same for the unfused run (its device time, which the host clock of a
    shared host does not give).
23. ``resnet_parity``: ResNet-50 widths at one block a stage, 64^2, b 8:
    f32 loss, BN state and grads on the card against the CPU with
    ``fused_1x1`` on and off, and 3 bf16 steps with K8 against 3 with its
    plain version.
24. ``fls_timing``: K8 at each distinct shape of phase 21 beside its
    bound, its plain version, ``torch.mm`` alone (the product without the
    statistics) and ``torch.mm`` plus the two column reductions (the
    unfused sequence).

Then a ``wall`` line (seconds per phase), the ``kernels`` line, the
nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises: the script
then exits non-zero and prints no result. Without a CUDA device it exits
1 at once.
"""

from __future__ import annotations

import contextlib
import json
import re
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from tf_operator_tpu_torch.compat import tree_map
from tf_operator_tpu_torch.device import resolve_device
from tf_operator_tpu_torch.models.resnet import ResNetConfig, init_resnet
from tf_operator_tpu_torch.models.transformer import (
    init_transformer,
    lm_loss,
    lm_loss_and_metrics,
    preset_from_workload,
)
from tf_operator_tpu_torch.ops import _build
from tf_operator_tpu_torch.ops import flash_attention as fa
from tf_operator_tpu_torch.ops import fused_linear_stats as fls
from tf_operator_tpu_torch.ops import grouped_matmul as gm
from tf_operator_tpu_torch.parallel.moe import block_layout
from tf_operator_tpu_torch.serve.engine import (
    ServeConfig,
    ServeEngine,
    decode_step,
    prefill_chunk,
)
from tf_operator_tpu_torch.serve.kvcache import PagePool, SequencePages, pages_needed
from tf_operator_tpu_torch.train.trainer import Trainer, TrainerConfig
from tf_operator_tpu_torch.workloads.lm import fixed_tokens, router_metrics, run_lm
from tf_operator_tpu_torch.workloads.resnet import resnet_loss, run_resnet
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
# The MoE training job (examples/moe_small_h100.json) at full width and
# depth, 1 warmup + 8 timed steps, random weights (seed 0).
MOE_WL = {
    "preset": "moe-small", "steps": 8, "batch_size": 16, "seq_len": 512,
    "attn": "flash", "remat": "full", "lr": 3e-4, "data": "fixed",
}
# The ResNet-50 training job (examples/resnet50_h100.json) at full width
# and depth, 1 warmup + 8 timed steps, random weights (seed 0); fused_1x1
# comes from the config run_resnet is given, as bench.py sets it.
RESNET_WL = {"variant": "resnet50", "steps": 8, "batch_size": 128, "image_size": 224,
             "num_classes": 1000, "lr": 0.1, "data": "fixed"}
# Kernel launches per layer and step on each training path (the counters
# of COUNTERS; the rest must stay 0): save_mid (gqa-2048) and full remat
# (moe-small) both run the attention forward twice. The MoE layer's
# forward is two K5 (gate, up) and one K6 (down, gate weights as row
# scale); its backward three K5 on w^T (dx of gate and up, and the down
# product's unscaled t), two K7a and one K7b; full remat runs the forward
# again: K5 7, K6 2, K7a 2, K7b 1.
DENSE_PER_LAYER = {"flash_fwd_launches": 2, "flash_bwd_dq_launches": 1,
                   "flash_bwd_dkv_launches": 1}
MOE_PER_LAYER = {**DENSE_PER_LAYER, "gmm_fwd_launches": 7, "gmm_fwd_scaled_launches": 2,
                 "gmm_dw_launches": 2, "gmm_dw_scaled_launches": 1}
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
# The first of those steps runs both sides from the same params, so only
# the kernels' rounding differs (~1e-4 of the loss): limit 2e-3 there. In
# moe_parity the later steps also route some tokens to other experts on
# the two sides: the bf16 router logits of near-tied experts flip after
# one update of slightly different params, and each flipped choice moves
# the mean loss over 512 tokens by up to ~1e-3. On an H100 (700 W)
# moe_parity measured 0.019 at step 3, just inside the dense limit above,
# with step 1 at 9e-5; limit 5e-2 (0.6% of the loss) for its later
# steps.
PARITY_BF16_FIRST_STEP_ATOL = 2e-3
PARITY_MOE_BF16_LOSS_ATOL = 5e-2
# Grouped-matmul kernels vs their plain versions (f32 arithmetic on the
# same inputs), element by element: |kernel - plain| <= RTOL |plain| +
# RMS_ATOL rms(plain), the rms over an output row (y, dx) or over an
# expert's whole dw, so an all-zero sentinel row or an expert without
# tokens must come out exactly zero. f32 runs on split bf16 operands
# (~2^-17 relative a product, lo.lo dropped) with each 16-deep partial
# summed apart: over up to 3072-deep sums of random-sign terms the error
# is ~1e-5 of the rms, with tails to a few times that; limit 2^-12 of the
# rms plus 2^-16 of the value. bf16: y and dx are rounded to bf16 once
# (2^-9 relative), and K7b rounds s * x to bf16 before its products, which
# leaves ~2^-9 of the rms per dw element with tails to a few times that;
# limit 2^-7 of the value plus 2^-6 of the rms, as for the flash kernels.
# A planted fault (a block of one expert skipped or computed with the
# wrong weights) moves its outputs by O(1) of the rms.
GMM_F32_RTOL = 2.0**-16
GMM_F32_RMS_ATOL = 2.0**-12
GMM_BF16_RTOL = 2.0**-7
GMM_BF16_RMS_ATOL = 2.0**-6
# moe_parity's f32 MoE metrics card vs CPU (lb and z losses, entropy,
# all O(1)): the same routing and sums in other orders, ~1e-6; a flipped
# token choice moves lb by ~1e-3. Limit 1e-4.
PARITY_MOE_METRIC_ATOL = 1e-4
# K8 (fused_linear_stats) vs its plain version, element by element. y
# (rounded to x's dtype) as the flash kernels: bf16 2^-7 of the value +
# 2^-6 of its row's rms; f32 1e-4 absolute, plus 2^-16 of the value: the
# split operands keep each product to ~2^-17 of itself, and K8's y is not
# bounded near 1 as flash's outputs are (an f32 prologue case at K 8
# measured 1.02e-4 on the first H100 run). The statistics: both sides
# sum the f32 product of the same operands, in other orders. Each
# column's sum differs by (a) the reduction orders, within ~log2(M) eps of
# sum|y| at worst (the kernel: 8 rows a thread, 8 lanes, 2 warps, then the
# per-tile partial rows; the plain version: torch.sum) and a few eps
# typically; (b) the per-element product differences: with bf16 operands
# (the path's type) the products are exact and only the tensor cores'
# truncated 16-term sums differ, a few ulps of y, random in sign over the
# rows unless every row has one sign; with f32 operands the kernel
# multiplies bf16 hi + lo splits, which keep each value to ~2^-17 of
# itself, and a weight's dropped bits are the same for every row, so where
# the rows are all >= 0 (a ReLU'd x, or the prologue's output) they do not
# cancel in a column's sum. This check on an H100 (its cases below, 700
# W) measured up to 4.5 eps for bf16 and 105 for f32 (the prologue's
# cases, whose rows are all >= 0; a first limit of 32 for both failed
# there). Limits, in eps_f32 of sum|y| for the sum and of
# sum y^2 for the sum of squares: 32 for bf16, 256 for f32. With the prologue in
# bf16 the kernel multiplies relu(x*a + b) rounded to bf16 (a declared
# difference); its statistics are held to the plain version of that
# rounded operand, and its y to the plain version of the unrounded one
# within the bf16 limit above. A row tile left out of the statistics moves
# a column's sum of squares by ~128 y^2 (far above the limit at any M of
# the path); statistics taken from the bf16-rounded y move it by ~2^-9
# sqrt(M) y^2, ~16x the bf16 limit at M 1000, where fls_plant runs (less at
# larger M, as 1/sqrt(M)).
FLS_STATS_C = {"bf16": 32, "f32": 256}
FLS_F32_RTOL = 2.0**-16
F32_EPS = 2.0**-23
# f32 ResNet card vs CPU (resnet_parity): loss (~6.9) within 1e-4 and the
# BN running statistics (O(1)) within 1e-4, other sum orders only. The
# grads are held norm-wise (|g_card - g_cpu| / |g_cpu| over every param),
# against the network's own sensitivity to rounding: a few leaves' true
# values cancel to near zero (a BN bias in front of another batch norm;
# tests/test_torch_resnet_forward.py), so f32 rounding anywhere moves them
# by up to ~5% of their size, and on the first H100 run the card-CPU gap
# was 1.15e-3 norm-wise. The phase measures that sensitivity on the CPU:
# the grads' norm-wise change when the images move by one f32 ulp each
# (a perturbation the size of one rounding). The card must stay within 10
# times it (and 1e-4 at least); a wrong statistic, tile or backward moves
# the grads by O(1).
RESNET_PARITY_ATOL = 1e-4
RESNET_PARITY_NOISE_X = 10.0
RESNET_PARITY_GRAD_FLOOR = 1e-4
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

# every kernel's launch counter -> its wrapper module
COUNTERS = {
    "decode_launches": fa, "flash_fwd_launches": fa, "flash_bwd_dq_launches": fa,
    "flash_bwd_dkv_launches": fa, "gmm_fwd_launches": gm, "gmm_fwd_scaled_launches": gm,
    "gmm_dw_launches": gm, "gmm_dw_scaled_launches": gm, "fused_linear_stats_launches": fls,
}


def reset_counts() -> None:
    for name, module in COUNTERS.items():
        setattr(module, name, 0)


def read_counts() -> dict:
    return {name: getattr(module, name) for name, module in COUNTERS.items()}


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


def device_ms_split(fn, iters, name, warmup=2):
    """(device ms per call of the kernels whose name holds ``name``, of the
    rest), counted as device_ms counts."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    rows = profile_kernels(lambda: [fn(i) for i in range(iters)])
    part = {True: 0.0, False: 0.0}
    for key, n, t in rows:
        part[name in key] += t / n * max(1, round(n / iters))
    return part[True], part[False]


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


# (h, h_kv, d, ts, causal modes) of flash_check: gqa-2048's heads and MHA
# on and off the tile grid, and moe-small's (d 64) at its t and at 2048
FLASH_CHECK_CASES = (
    (16, 4, 128, (128, 200, 2048), (True, False)),
    (16, 16, 128, (128, 200, 2048), (True, False)),
    (12, 12, 64, (512, 2048), (True,)),
)


def phase_flash_check(dev, cases_spec=FLASH_CHECK_CASES):
    """K1-K3 against their plain versions on the card (FLASH_CHECK_CASES),
    f32 and bf16, a nonzero lse cotangent."""
    rng = np.random.RandomState(2)
    worst = {dt: {k: 0.0 for k in FLASH_KINDS} for dt in ("f32", "bf16")}
    ratio = {dt: {x: 0.0 for parts in FLASH_KINDS.values() for x in parts}
             for dt in ("f32", "bf16")}
    cases = 0
    for h, h_kv, d, ts, causals in cases_spec:
        for t in ts:
            b = 1 if t >= 2048 else 2
            for causal in causals:
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
          "shapes": [{"h": h, "h_kv": h_kv, "d": d, "t": list(ts), "causal": list(c)}
                     for h, h_kv, d, ts, c in cases_spec],
          "limits": {"f32_atol": FLASH_F32_ATOL, "lse_atol": FLASH_LSE_ATOL,
                     "bf16_rtol": FLASH_BF16_RTOL, "bf16_row_rms_atol": FLASH_BF16_ROW_ATOL},
          "max_abs_err": worst, "worst_err_over_limit": ratio})
    return worst


# Faults planted in copies of the kernel sources: (kernel, source, the
# line as it is, the line with the fault; or a tuple of lines and one of
# faults, planted together). Each must make the check fail.
FLASH_PLANTS = {
    # key tile 0 dropped for the last 64 query rows (1 of 32 at t = 2048);
    # the mask then runs on every tile, not only those that cross the
    # diagonal or t
    "fwd_drop_tile": ("fwd", "flash_fwd.cu",
                      ("const bool edge = k0 + KT > t || (causal && k0 + KT - 1 > pw);",
                       "if (col >= t || (causal && col > row)) s[4 * n + e] = kNegInf;"),
                      ("const bool edge = true;",
                       "if (col >= t || (causal && col > row) || (row >= t - 64 && col < 64)) "
                       "s[4 * n + e] = kNegInf;")),
    # the causal mask lets each row see one key past its own
    "fwd_mask_off_by_one": ("fwd", "flash_fwd.cu", "(causal && col > row)",
                            "(causal && col > row + 1)"),
    # the K-major descriptors of q.k^T step 16 bytes along the swizzled row
    # a depth step of 16, not 32
    "fwd_qk_k_step": ("fwd", "flash_fwd.cu", "return (kk >> 2) * box + (kk & 3) * 32;",
                      "return (kk >> 2) * box + (kk & 3) * 16;"),
    # p.v steps through V's MN-major boxes by 16 columns, not 16 rows
    "fwd_pv_v_step": ("fwd", "flash_fwd.cu", "return kk * 16 * kRowBytes;", "return kk * 32;"),
    # key tile 0 dropped from dq for the last 64 query rows; the mask then
    # runs on every tile
    "dq_drop_tile": ("dq", "flash_bwd.cu",
                     ("const bool edge = k0 + KT > t || (causal && k0 + KT - 1 > pw);",
                      "if (col >= t || (causal && col > row)) s[4 * n + e] = 0.f;"),
                     ("const bool edge = true;",
                      "if (col >= t || (causal && col > row) || (row >= t - 64 && col < 64)) "
                      "s[4 * n + e] = 0.f;")),
    # the last query tile never reaches dk, dv; the mask then runs on every
    # tile
    "dkv_drop_tile": ("dkv", "flash_bwd.cu",
                      ("const bool edge = q0 + KT > t || kw + kRows > t || "
                       "(causal && kw + kRows - 1 > q0);",
                       "if (col >= t || key >= t || (causal && key > col)) s[4 * n + e] = 0.f;"),
                      ("const bool edge = true;",
                       "if (col >= t - 64 || key >= t || (causal && key > col)) "
                       "s[4 * n + e] = 0.f;")),
    # the backward's MN-major products step through their B boxes by 16
    # columns, not 16 rows: dq's dS.K on K, and (the same line, checked on
    # the other kernel) dk/dv's dV and dK on dO and Q
    "dq_mn_step": ("dq", "flash_bwd.cu", "return kk * 16 * kRowBytes;", "return kk * 32;"),
    "dkv_mn_step": ("dkv", "flash_bwd.cu", "return kk * 16 * kRowBytes;", "return kk * 32;"),
    # the backward's score products (K-major) step 16 bytes along the
    # swizzled row a depth step of 16, not 32
    "bwd_k_step": ("dq", "flash_bwd.cu", "return (kk >> 2) * box + (kk & 3) * 32;",
                   "return (kk >> 2) * box + (kk & 3) * 16;"),
}
FLASH_KINDS = {"fwd": ("o", "lse"), "dq": ("dq",), "dkv": ("dk", "dv")}
FLASH_ENTRY = {"fwd": "flash_fwd", "dq": "flash_bwd_dq", "dkv": "flash_bwd_dkv"}


# The same for the grouped-matmul source (phase gmm_plant).
GMM_PLANTS = {
    # a sentinel block computes expert 0's product instead of writing zeros
    # (the forward's expert read, which both of its roles take)
    "sentinel_computed": ("gmm", "grouped_matmul.cu", "w.e = be[w.m0 / block_rows];",
                          "w.e = max(be[w.m0 / block_rows], 0);"),
    # the dw walk skips the last block of every expert that has several
    "dw_skips_last_block": ("gmm", "grouped_matmul.cu", "const int steps = nblocks[e] * spb;",
                            "const int steps = (nblocks[e] > 1 ? nblocks[e] - 1 : nblocks[e]) "
                            "* spb;"),
    # the forward reads the weights of the neighbouring expert (e xor 1):
    # the outer coordinate of w's 3-D map
    "weight_of_neighbour": ("gmm", "grouped_matmul.cu",
                            "hopper::tma_box_3d(dst + (kXFBoxes + b) * L::box, wmap, bar, c0, c1, "
                            "w.e);",
                            "hopper::tma_box_3d(dst + (kXFBoxes + b) * L::box, wmap, bar, c0, c1, "
                            "w.e ^ 1);"),
    # K7b multiplies each x row by the scale of the next row of its stage
    "dw_scale_next_row": ("gmm", "grouped_matmul.cu", "return SCALED ? ss[r] : 1.f;",
                          "return SCALED ? ss[(r + 1) % kDepth] : 1.f;"),
    # the dw products step through the MN-major tiles by 16 columns, not
    # 16 rows
    "dw_k_step_by_columns": ("gmm", "grouped_matmul.cu",
                             "wgmma_256(acc, sw128_desc(a + k * 16 * kRowBytes), "
                             "sw128_desc(b + k * 16 * kRowBytes));",
                             "wgmma_256(acc, sw128_desc(a + k * 32), sw128_desc(b + k * 32));"),
    # the forward's K-major x descriptors step 16 bytes along the swizzled
    # row a depth step of 16, not 32
    "fwd_a_k_step": ("gmm", "grouped_matmul.cu",
                     "const uint64_t ad = hopper::kmajor_desc(a + k * 32);",
                     "const uint64_t ad = hopper::kmajor_desc(a + k * 16);"),
    # the dx form reads its K-major w[e] boxes as MN-major
    "fwd_dx_b_major": ("gmm", "grouped_matmul.cu",
                       "hopper::Wgmma<kFN>::ss<0, TRANS ? 0 : 1>(acc, ad, bd, 1);",
                       "hopper::Wgmma<kFN>::ss<0, 1>(acc, ad, bd, 1);"),
    # K6's epilogue takes the scale of the row beside each row (row ^ 1)
    "fwd_scale_next_row": ("gmm", "grouped_matmul.cu",
                           "const float s0 = scaled ? s[row] : 1.f, s1 = scaled ? s[row + 8] : 1.f;",
                           "const float s0 = scaled ? s[row ^ 1] : 1.f, "
                           "s1 = scaled ? s[(row + 8) ^ 1] : 1.f;"),
}


def plant_jobs(names, plants):
    """(compile jobs for the plant libraries not built yet, name -> library
    path): copies of the sources, each with one planted fault, under
    build/torch_kernels/plant/, named by a hash of the faulty source."""
    import hashlib
    import shutil

    out = _build.BUILD_DIR / "plant"
    out.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copyfile(header, out / header.name)
    jobs, libs = {}, {}
    for name in names:
        _, src, lines, faults = plants[name]
        if isinstance(lines, str):
            lines, faults = (lines,), (faults,)
        text = (_build.CSRC / src).read_text()
        for line, fault in zip(lines, faults):
            check(text.count(line) == 1,
                  f"plant {name}: the line occurs {text.count(line)} times: {line}")
            text = text.replace(line, fault)
        tag = hashlib.sha256(text.encode() + b"".join(
            h.read_bytes() for h in sorted(_build.CSRC.glob("*.cuh")))).hexdigest()[:16]
        libs[name] = out / f"{name}-{tag}.so"
        if not libs[name].exists():
            (out / f"{name}.cu").write_text(text)
            jobs[name] = (out / f"{name}.cu", libs[name])
    return jobs, libs


def build_plants(names=tuple(FLASH_PLANTS), plants=FLASH_PLANTS):
    """The plant libraries ``names`` of ``plants``, built together where
    missing. Returns name -> CDLL."""
    import ctypes

    jobs, libs = plant_jobs(names, plants)
    _build.compile_sources(jobs)
    return {name: ctypes.CDLL(str(path)) for name, path in libs.items()}


def build_all():
    """Every kernel library and every plant library, one nvcc per source,
    all started together."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for n in _build.KERNELS:
        lib = _build._lib_path(n)
        if not lib.exists():
            jobs[n] = (_build.CSRC / f"{n}.cu", lib)
    for plants in (FLASH_PLANTS, GMM_PLANTS, FLS_PLANTS):
        jobs.update(plant_jobs(tuple(plants), plants)[0])
    _build.build_log.update(_build.compile_sources(jobs))


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


def phase_train(smi, wl=TRAIN_WL, dev="cuda", per_layer=DENSE_PER_LAYER, phase="train"):
    """A training job at full width and depth through run_lm: one warmup
    and wl["steps"] timed steps. Every step launches each kernel exactly
    per_layer[counter] x L times (the other counters stay 0); the loss
    stays finite and falls. For an MoE model, the router health line of
    the workload after the counts are read."""
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
    want = {name: per_layer.get(name, 0) * L * n for name in COUNTERS}
    check(counts == want, f"{phase} launches {counts} != {want}")
    check(all(np.isfinite(run.losses)), f"non-finite loss: {run.losses}")
    check(run.losses[-1] < run.losses[0], f"loss did not fall: {run.losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    router = router_metrics(run)
    emit({
        "phase": phase, "preset": wl["preset"], "n_layers": L, "d_model": run.cfg.d_model,
        "params": run.cfg.n_params(), "active_params": run.cfg.n_active_params(),
        "batch": wl["batch_size"], "seq": wl["seq_len"],
        "attn": wl["attn"], "remat": wl["remat"], "dtype": str(run.cfg.dtype),
        "steps": n, "timed_steps": run.timed, "losses": run.losses,
        "launches": counts, "launches_per_step": {k: v / n for k, v in counts.items()},
        "step_ms": run.step_s * 1e3, "tokens_per_s": run.tokens_per_s,
        "model_flops_exact": run.flops_exact, "model_flops_6nd": run.flops_6nd,
        "mfu_exact": run.mfu(run.flops_exact), "mfu_6nd": run.mfu(run.flops_6nd),
        "peak_mem_gb": peak_gb, "run_lm_wall_s": wall, "router": router, "card": smi,
    })
    return run, counts


def kernel_category(name: str) -> str:
    """A device item's family, read from its name."""
    n = name.lower()
    for cat, marks in (("flash kernels", ("flash::",)), ("grouped-matmul kernels", ("gmm::",)),
                       ("fused-linear-stats kernel", ("fls::",)),
                       ("convolution (cuDNN)", ("fprop", "dgrad", "wgrad", "implicit_gemm",
                                                "cudnn", "conv2d", "convolve")),
                       ("matmul (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma", "sm90_")),
                       ("reduction", ("reduce",)), ("copy/cast", ("copy", "memcpy")),
                       ("fill", ("fill", "memset")), ("elementwise", ("elementwise",))):
        if any(m in n for m in marks):
            return cat
    return "other"


def phase_train_breakdown(run, smi, iters=2, phase="train_breakdown", batch=None):
    """Training steps of a train phase's run (on ``batch``, default the
    run's tokens) on the host clock and under torch.profiler: device busy
    time per step, idle share, top kernels, the three flash kernels'
    share, the grouped-matmul kernels' (forward and dw) and K8's."""
    holder = {"state": run.state}
    batch = run.tokens if batch is None else batch

    def step():
        holder["state"], m = run.trainer.step(holder["state"], batch)
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
    gmm_ms = {kind: sum(t for k, _, t in rows if "gmm::" in k and f"{kind}_kernel" in k) / iters
              for kind in ("fwd", "dw")}
    fls_ms = sum(t for k, _, t in rows if "fls::" in k) / iters
    by_category = {}
    for k, _, t in rows:
        by_category[kernel_category(k)] = by_category.get(kernel_category(k), 0.0) + t / iters
    emit({
        "phase": phase, "steps": iters, "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
        "device_items_per_step": sum(c for _, c, _ in rows) / iters,
        "flash_ms_per_step": flash,
        "flash_share_of_busy": sum(flash.values()) / busy_ms if busy_ms else None,
        "gmm_ms_per_step": gmm_ms,
        "gmm_share_of_busy": sum(gmm_ms.values()) / busy_ms if busy_ms else None,
        "fls_ms_per_step": fls_ms, "fls_share_of_busy": fls_ms / busy_ms if busy_ms else None,
        "ms_per_step_by_category": dict(sorted(by_category.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"kernel": k[:100], "launches_per_step": c / iters,
                         "ms_per_step": t / iters,
                         "share_of_busy": t / iters / busy_ms if busy_ms else None}
                        for k, c, t in rows[:12]],
        "card": smi,
    })


@contextlib.contextmanager
def plain_kernels():
    """Route CUDA tensors of flash_attention and gmm to the plain versions
    (the Functions look their kernels up by module attribute at call
    time)."""
    saved = fa.flash_fwd_kernel, fa.flash_bwd_kernel, gm.gmm_fwd_kernel, gm.gmm_dw_kernel
    fa.flash_fwd_kernel, fa.flash_bwd_kernel = fa.flash_fwd_reference, fa.flash_bwd_reference
    gm.gmm_fwd_kernel, gm.gmm_dw_kernel = gm.gmm_fwd_reference, gm.gmm_dw_reference
    try:
        yield
    finally:
        fa.flash_fwd_kernel, fa.flash_bwd_kernel, gm.gmm_fwd_kernel, gm.gmm_dw_kernel = saved


def phase_train_parity(dev, wl=TRAIN_WL, per_layer=DENSE_PER_LAYER, phase="train_parity",
                       n_layers=2, batch=2, seq=256, steps=3, bf16_atol=PARITY_BF16_LOSS_ATOL):
    """A training path at full width, cut to 2 layers and t 256: (1) f32
    loss, metrics (the MoE router's too) and grads on the card (kernels,
    cuBLAS) against the CPU (plain versions) from the same params and
    tokens; (2) 3 bf16 AdamW steps on the card with the kernels (each
    launched per_layer[counter] x layers x steps times) against 3 with the
    plain versions called directly on the same card tensors."""
    wl = {**wl, "n_layers": n_layers, "seq_len": seq, "batch_size": batch}
    cfg16 = preset_from_workload(wl)
    cfg32 = replace(cfg16, dtype=torch.float32)
    params = init_transformer(cfg32, torch.Generator().manual_seed(0), "cpu")
    tokens = fixed_tokens(batch, seq, cfg32.vocab, "cpu")

    def loss_and_grads(where):
        p = tree_map(lambda x: x.detach().to(where).requires_grad_(True), params)
        loss, metrics = lm_loss_and_metrics(p, tokens.to(where), cfg32)
        loss.backward()
        return (float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()},
                tree_map(lambda x: x.grad.cpu(), p))

    card_loss, card_m, card_g = loss_and_grads(dev)
    t0 = time.perf_counter()
    cpu_loss, cpu_m, cpu_g = loss_and_grads("cpu")
    cpu_s = time.perf_counter() - t0
    loss_err = abs(card_loss - cpu_loss)
    check(loss_err <= PARITY_LOSS_ATOL, f"card vs CPU loss: {card_loss} vs {cpu_loss}")
    moe_err = {k: abs(card_m[k] - cpu_m[k]) for k in card_m if k.startswith("moe_")}
    check(all(e <= PARITY_MOE_METRIC_ATOL for e in moe_err.values()),
          f"card vs CPU MoE metrics: {card_m} vs {cpu_m}")
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
        with plain_kernels() if use_plain else contextlib.nullcontext():
            for _ in range(steps):
                state, m = trainer.step(state, tok)
                losses.append(m["loss"])
        return [float(x) for x in losses], read_counts()

    kern, kern_counts = train(False)
    plain, plain_counts = train(True)
    want = {name: per_layer.get(name, 0) * n_layers * steps for name in COUNTERS}
    check(kern_counts == want, f"kernel run launches {kern_counts} != {want}")
    check(not any(plain_counts.values()), f"plain run launched kernels: {plain_counts}")
    step_err = max(abs(a - b) for a, b in zip(kern, plain))
    first_err = abs(kern[0] - plain[0])
    check(all(np.isfinite(kern)) and step_err <= bf16_atol
          and first_err <= PARITY_BF16_FIRST_STEP_ATOL,
          f"bf16 steps, kernels {kern} vs plain {plain}")
    emit({"phase": phase, "preset": wl["preset"], "n_layers": n_layers, "batch": batch,
          "seq": seq, "f32_loss_card": card_loss, "f32_loss_cpu": cpu_loss,
          "f32_loss_abs_diff": loss_err, "f32_moe_metrics_card": {k: card_m[k] for k in moe_err},
          "f32_moe_metric_abs_diff": moe_err, "f32_moe_metric_atol": PARITY_MOE_METRIC_ATOL,
          "f32_loss_atol": PARITY_LOSS_ATOL, "f32_grad_rel_diff_max": max(grad_rel.values()),
          "f32_grad_rel_limit": PARITY_GRAD_REL, "f32_grad_rel_diff": grad_rel,
          "bf16_losses_kernels": kern, "bf16_losses_plain": plain,
          "bf16_loss_max_abs_diff": step_err, "bf16_loss_atol": bf16_atol,
          "bf16_first_step_abs_diff": first_err,
          "bf16_first_step_atol": PARITY_BF16_FIRST_STEP_ATOL,
          "cpu_seconds": cpu_s})


def leaves_with_names(tree, prefix=""):
    """(path, leaf) of nested dicts (sorted keys) and lists (in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves_with_names(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves_with_names(v, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]


def tree_leaves(tree):
    """Leaves of nested dicts (sorted keys) and lists, as the trainer walks them."""
    return [x for _, x in leaves_with_names(tree)]


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
    work = flash_work(b, t, h, h_kv, d)
    out = {}
    for kind, kfns in fns.items():
        ms, source, runs = timed_in_turns(kfns, iters)
        ops, nbytes = work[kind]
        out[kind] = {
            "ms": ms["kernel"], "plain_ms": ms["plain"], "library_ms": ms.get("library"),
            **bound_of(ops, nbytes), "ops": ops, "bytes": nbytes,
            "tflops": ops / ms["kernel"] / 1e9,
            "max_abs_err_bf16": max(errs[x][0] for x in FLASH_KINDS[kind]),
            "ms_source": source, "runs": {n: r for n, r in runs.items()},
        }
        if "library_bwd" in ms:  # SDPA's backward: dq, dk and dv in one call
            out["library_bwd_all_ms"] = ms["library_bwd"]
    out["fwd_build"] = tma_build_facts()
    out["bwd_build"] = tma_build_facts("flash_bwd", BWD_INSTANCES)
    out["fwd_moe_shape"] = fwd_timing_at(rng, 16, 512, 12, 12, 64, dev)
    out["bwd_moe_shape"] = bwd_timing_at(rng, 16, 512, 12, 12, 64, dev)
    emit({"phase": "flash_timing", "shape": {"b": b, "t": t, "h": h, "h_kv": h_kv, "d": d,
                                             "dtype": "bfloat16", "causal": True},
          "library": "scaled_dot_product_attention(is_causal, enable_gqa) on [b, h, t, d]; "
                     "its backward computes dq, dk and dv together",
          "library_max_abs_err_vs_plain": lib_err, "card": smi, **out})
    return out


def flash_work(b, t, h, h_kv, d):
    """{kind: (operations, bytes)} of the three flash kernels at a bf16
    causal shape: the products on the live (query, key) pairs, each input
    read once and each output written once."""
    pairs = b * h * t * (t + 1) // 2  # live (query, key) pairs under causal masking
    qb, kvb, rowb = b * t * h * d * 2, b * t * h_kv * d * 2, b * h * t * 4
    return {
        "fwd": (4 * d * pairs, qb + 2 * kvb + qb + rowb),
        "dq": (6 * d * pairs, 2 * qb + 2 * kvb + 2 * rowb + qb),
        "dkv": (8 * d * pairs, 2 * qb + 2 * kvb + 2 * rowb + 2 * kvb),
    }


def bound_of(ops, nbytes):
    """The least time for ``ops`` bf16 operations and ``nbytes`` bytes: the
    larger of the two at the card's peaks, and which it is."""
    ops_ms, bytes_ms = ops / BF16_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "ops_ms": ops_ms, "bytes_ms": bytes_ms}


def bwd_timing_at(rng, b, t, h, h_kv, d, dev="cuda"):
    """K2 and K3 at another shape (bf16, causal): checked against their
    plain versions, then timed beside their bounds and SDPA's backward
    (dq, dk and dv in one call)."""
    q, k, v, do, dlse = flash_case(rng, b, t, h, h_kv, d, torch.bfloat16, dev)
    o, lse = fa.flash_fwd_kernel(q, k, v, True)
    lse_k, delta = fa.lse_kernel_layout(lse), fa.flash_delta(o, do, dlse)
    f32 = [x.float() for x in (q, k, v, do)]
    got = {"dq": (fa.flash_bwd_dq_kernel(q, k, v, do, lse_k, delta, True),),
           "dkv": fa.flash_bwd_dkv_kernel(q, k, v, do, lse_k, delta, True)}
    want = {"dq": (fa.flash_bwd_dq_reference(*f32, lse_k, delta, True),),
            "dkv": fa.flash_bwd_dkv_reference(*f32, lse_k, delta, True)}
    err = {}
    for kind in got:
        for name, x, w in zip(FLASH_KINDS[kind], got[kind], want[kind]):
            diff = (x.float() - w).abs()
            check(bool((diff <= flash_limit(name, w, torch.bfloat16)).all()),
                  f"flash {name} at b{b} t{t} h{h}/{h_kv} d{d}: max abs err {float(diff.max())}")
            err[kind] = max(err.get(kind, 0.0), float(diff.max()))
    del got, want, f32
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    out_t = sdpa(qt, kt, vt, is_causal=True, enable_gqa=h_kv != h)
    do_t = do.transpose(1, 2).contiguous()
    ms, source, runs = timed_in_turns(
        [("dq", lambda i: fa.flash_bwd_dq_kernel(q, k, v, do, lse_k, delta, True)),
         ("dkv", lambda i: fa.flash_bwd_dkv_kernel(q, k, v, do, lse_k, delta, True)),
         ("library_bwd", lambda i: torch.autograd.grad(out_t, (qt, kt, vt), do_t,
                                                       retain_graph=True))],
        {"dq": 20, "dkv": 20, "library_bwd": 20})
    work = flash_work(b, t, h, h_kv, d)
    return {"shape": {"b": b, "t": t, "h": h, "h_kv": h_kv, "d": d},
            **{kind: {"ms": ms[kind], **bound_of(*work[kind]), "tflops": work[kind][0] / ms[kind]
                      / 1e9, "max_abs_err": err[kind]} for kind in ("dq", "dkv")},
            "library_bwd_all_ms": ms["library_bwd"], "ms_source": source, "runs": runs}


def fwd_timing_at(rng, b, t, h, h_kv, d, dev="cuda"):
    """K1 alone at another shape (bf16, causal): checked against its plain
    version, then timed beside SDPA's forward and its bound."""
    q, k, v, _, _ = flash_case(rng, b, t, h, h_kv, d, torch.bfloat16, dev)
    o, _ = fa.flash_fwd_kernel(q, k, v, True)
    o_ref = fa.flash_fwd_reference(q.float(), k.float(), v.float(), True)[0]
    err = (o.float() - o_ref).abs()
    check(bool((err <= flash_limit("o", o_ref, torch.bfloat16)).all()),
          f"flash fwd at b{b} t{t} h{h}/{h_kv} d{d}: max abs err {float(err.max())}")
    del o_ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ms, source, runs = timed_in_turns(
        [("kernel", lambda i: fa.flash_fwd_kernel(q, k, v, True)),
         ("library", lambda i: sdpa(qt, kt, vt, is_causal=True, enable_gqa=h_kv != h))],
        {"kernel": 20, "library": 20})
    ops, nbytes = flash_work(b, t, h, h_kv, d)["fwd"]
    return {"shape": {"b": b, "t": t, "h": h, "h_kv": h_kv, "d": d}, "ms": ms["kernel"],
            "library_ms": ms["library"], **bound_of(ops, nbytes),
            "tflops": ops / ms["kernel"] / 1e9, "max_abs_err": float(err.max()),
            "ms_source": source, "runs": runs}


# ---------------------------------------------------------------------------
# MoE training: the grouped-matmul kernels against their plain versions
# ---------------------------------------------------------------------------


def routed_block_map(rng, tokens, n_experts, block_rows, dev, empty=()):
    """The block map of a top-1 routing of ``tokens`` over ``n_experts``
    (uniform at random, none to the experts in ``empty``), laid out as
    _moe_single_gmm lays out its rows. Returns (block_expert int32 [nb],
    valid [nb * block_rows] bool: the row holds a routed token, not
    padding, pad_start [E])."""
    p = np.ones(n_experts)
    p[list(empty)] = 0.0
    choice = rng.choice(n_experts, size=tokens, p=p / p.sum())
    counts = torch.from_numpy(np.bincount(choice, minlength=n_experts)).to(dev)
    nb = -(-tokens // block_rows) + n_experts
    be, pad_start = block_layout(counts, block_rows, nb)
    slot = torch.arange(nb * block_rows, device=dev)
    e_s = be.long()[slot // block_rows]
    return be, slot - pad_start[e_s] < counts[e_s], pad_start


def gmm_case(gen, be, k, n, n_experts, dtype, dev, block_rows=256, valid=None, scaled=False,
             empty=()):
    """Inputs of one grouped-matmul check: x [R, k], w [E, k, n] (the
    forward's weights; the dx use reads them as w^T), dy [R, n], and for
    the scaled form row scales in (0, 1). Where ``valid`` marks padding
    rows, their dy and scales are zeros, as in the model (padding outputs
    are never gathered back). ``empty``: the experts that get no token."""
    R = be.numel() * block_rows

    def draw(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    x, w, dy = draw(R, k), draw(n_experts, k, n, scale=k**-0.5), draw(R, n)
    s = torch.rand(R, device=dev, generator=gen) if scaled else None
    if valid is not None:
        dy = dy * valid[:, None]
        s = s * valid if scaled else None
    return {"x": x.to(dtype), "w": w.to(dtype), "dy": dy.to(dtype), "s": s, "be": be,
            "E": n_experts, "B": block_rows, "empty": tuple(empty)}


def gmm_limit(want, dtype, dims):
    """Elementwise limit on |kernel - plain| (GMM_* above), ``want`` the f32
    plain result, its rms taken over ``dims``."""
    rms = want.pow(2).mean(dim=dims, keepdim=True).sqrt()
    if dtype == torch.float32:
        return GMM_F32_RTOL * want.abs() + GMM_F32_RMS_ATOL * rms
    return GMM_BF16_RTOL * want.abs() + GMM_BF16_RMS_ATOL * rms


def compare_gmm(c):
    """K5 (or K6 with the case's row scale), K5 on w^T (the dx use) and K7a
    (or K7b) against their plain versions on the same card tensors, the
    plain versions in f32. Returns {name: (max abs err, largest err /
    limit)} for y, dx and dw; an error where the limit is 0 (an all-zero
    row or expert) counts as infinitely over it."""
    x, w, dy, s, be, E, B = (c[k] for k in ("x", "w", "dy", "s", "be", "E", "B"))
    y = gm.gmm_fwd_kernel(x, w, be, s, block_rows=B)
    dx = gm.gmm_fwd_kernel(dy, w, be, block_rows=B, trans_w=True)
    dw = gm.gmm_dw_kernel(x, dy, be, E, s, block_rows=B)
    xf, wf, dyf = x.float(), w.float(), dy.float()
    want = {"y": gm.gmm_fwd_reference(xf, wf, be, s, block_rows=B),
            "dx": gm.gmm_fwd_reference(dyf, wf, be, block_rows=B, trans_w=True),
            "dw": gm.gmm_dw_reference(xf, dyf, be, E, s, block_rows=B)}
    torch.cuda.synchronize()
    out = {}
    for name, got, dims in (("y", y, (-1,)), ("dx", dx, (-1,)), ("dw", dw, (1, 2))):
        check(bool(torch.isfinite(got).all()), f"gmm {name} not finite")
        err = (got.float() - want[name]).abs()
        ratio = torch.where(err == 0, 0.0, err / gmm_limit(want[name], x.dtype, dims))
        out[name] = (float(err.max()), float(ratio.max()))
    return out


def gmm_within(errs) -> bool:
    return all(ratio <= 1.0 for _, ratio in errs.values())


# a map with sentinel blocks, experts 1, 3 and 4 without blocks, and the
# blocks of experts 0, 2 and 5 interleaved (6 experts, 16 blocks of 256)
GMM_MIXED_MAP = (0, -1, 2, 0, 2, -1, 0, 2, 5, 5, -1, 0, 2, 5, 0, -1)


def gmm_cases(dev, dtype, full=True):
    """(name, case) of gmm_check: moe-small's gate/up and down products at
    10240 rows (8192 tokens, expert 3 without any) and the mixed map at
    k 264, n 200 (off the 32-deep and 128-wide tile grid), plain and
    scaled."""
    rng = np.random.RandomState(9)
    gen = torch.Generator(dev).manual_seed(9)
    cases = []
    if full:
        be, valid, _ = routed_block_map(rng, 8192, 8, 256, dev, empty=(3,))
        cases += [
            ("moe_gate_up", gmm_case(gen, be, 768, 3072, 8, dtype, dev, valid=valid,
                                     empty=(3,))),
            ("moe_down", gmm_case(gen, be, 3072, 768, 8, dtype, dev, valid=valid, scaled=True,
                                  empty=(3,))),
        ]
    mixed = torch.tensor(GMM_MIXED_MAP, dtype=torch.int32, device=dev)
    for scaled in (False, True):
        cases.append((f"mixed{'_scaled' if scaled else ''}",
                      gmm_case(gen, mixed, 264, 200, 6, dtype, dev, scaled=scaled,
                               empty=(1, 3, 4))))
    return cases


def zeros_exact(c) -> dict:
    """Sentinel rows of y and dx, and the dw of the experts without tokens
    (without blocks, or owning only padding rows): exactly zero."""
    be, B = c["be"], c["B"]
    y = gm.gmm_fwd_kernel(c["x"], c["w"], be, c["s"], block_rows=B)
    dx = gm.gmm_fwd_kernel(c["dy"], c["w"], be, block_rows=B, trans_w=True)
    dw = gm.gmm_dw_kernel(c["x"], c["dy"], be, c["E"], c["s"], block_rows=B)
    rows = (be < 0).repeat_interleave(B)
    return {"sentinel_rows": int(rows.sum()),
            "sentinel_zero": bool((y[rows] == 0).all() and (dx[rows] == 0).all()),
            "experts_without_tokens": list(c["empty"]),
            "their_dw_zero": bool(all((dw[e] == 0).all() for e in c["empty"]))}


def phase_gmm_check(dev, full=True):
    """K5, K6, K7a, K7b and the dx use against their plain versions on the
    card (gmm_cases), in bf16 and f32, element by element (gmm_limit);
    sentinel rows and the dw of experts with no block or no token exactly
    zero."""
    worst = {dt: {k: 0.0 for k in ("y", "dx", "dw")} for dt in ("f32", "bf16")}
    ratio = {dt: {k: 0.0 for k in ("y", "dx", "dw")} for dt in ("f32", "bf16")}
    by_kernel = {dt: {k: 0.0 for k in ("k5", "k6", "k7a", "k7b")} for dt in ("f32", "bf16")}
    zeros, n = {}, 0
    for dtype in (torch.float32, torch.bfloat16):
        key = "f32" if dtype == torch.float32 else "bf16"
        for name, c in gmm_cases(dev, dtype, full):
            errs = compare_gmm(c)
            check(gmm_within(errs), f"gmm kernels vs plain, {name} {dtype}: {errs}")
            scaled = c["s"] is not None
            for part, (err, r) in errs.items():
                worst[key][part] = max(worst[key][part], err)
                ratio[key][part] = max(ratio[key][part], r)
            kf, kd = ("k6", "k7b") if scaled else ("k5", "k7a")
            by_kernel[key][kf] = max(by_kernel[key][kf], errs["y"][0])
            by_kernel[key]["k5"] = max(by_kernel[key]["k5"], errs["dx"][0])
            by_kernel[key][kd] = max(by_kernel[key][kd], errs["dw"][0])
            z = zeros_exact(c)
            check(z["sentinel_zero"] and z["their_dw_zero"], f"gmm zeros, {name}: {z}")
            zeros[f"{name}/{key}"] = z
            n += 1
    emit({"phase": "gmm_check", "cases": n,
          "limits": {"f32_rtol": GMM_F32_RTOL, "f32_rms_atol": GMM_F32_RMS_ATOL,
                     "bf16_rtol": GMM_BF16_RTOL, "bf16_rms_atol": GMM_BF16_RMS_ATOL},
          "max_abs_err": worst, "worst_err_over_limit": ratio,
          "max_abs_err_by_kernel": by_kernel, "exact_zeros": zeros})
    return by_kernel


@contextlib.contextmanager
def gmm_planted(lib):
    """Route the grouped-matmul wrappers to the planted library."""
    real = {}
    for entry in gm.GMM_ENTRIES:
        gm._gmm_fn(entry)  # bind the real one first, so it can be put back
        real[entry] = gm._fns[entry]
        gm._fns[entry] = gm.bind_gmm_entry(lib, entry)
    try:
        yield
    finally:
        gm._fns.update(real)


def phase_gmm_plant(dev):
    """Each planted fault (GMM_PLANTS) on the mixed map, plain and scaled,
    bf16 and f32: the check of phase gmm_check must fail on the faulty
    kernels' own outputs. Launches here are not the main path's."""
    libs = build_plants(tuple(GMM_PLANTS), GMM_PLANTS)
    out = {}
    for name, lib in libs.items():
        for dtype in (torch.bfloat16, torch.float32):
            cases = gmm_cases(dev, dtype, full=False)
            with gmm_planted(lib):
                errs = [compare_gmm(c) for _, c in cases]
            worst = max(r for e in errs for _, r in e.values())
            check(worst > 1.0, f"planted fault {name} ({dtype}) passed the check: {errs}")
            out[f"{name}/{str(dtype)[6:]}"] = worst
    emit({"phase": "gmm_plant", "caught": len(out), "worst_err_over_limit": out})


# ---------------------------------------------------------------------------
# MoE training: kernel timing at the moe_train shapes
# ---------------------------------------------------------------------------


def grouped_mm_yardstick(a, b, ends, want, dtype, dims, mm_args):
    """The library call of gmm_timing: torch._grouped_mm(a, b, offs=ends)
    where the card's PyTorch has it and it agrees with the plain version
    (gmm_limit), else one torch.mm of the same FLOPs. Returns (fn, label,
    max abs err against the plain version or None)."""
    why = "torch._grouped_mm missing"
    if hasattr(torch, "_grouped_mm"):
        try:
            got = torch._grouped_mm(a, b, offs=ends)
            torch.cuda.synchronize()
        except RuntimeError as exc:
            why = f"torch._grouped_mm refused: {str(exc)[:120]}"
        else:
            err = (got.float() - want).abs()
            if bool((err <= gmm_limit(want, dtype, dims)).all()):
                return (lambda i: torch._grouped_mm(a, b, offs=ends),
                        "torch._grouped_mm on the same expert groups", float(err.max()))
            why = f"torch._grouped_mm disagreed by {float(err.max())}"
    p, q = mm_args
    return (lambda i: torch.mm(p, q)), f"torch.mm of the same FLOPs ({why})", None


# The dw kernels' instantiations on the main path (bf16), by a piece of
# their mangled names: dw_kernel<__nv_bfloat16, SCALED>.
DW_INSTANCES = {"k7a": "dw_kernelI13__nv_bfloat16Lb0E", "k7b": "dw_kernelI13__nv_bfloat16Lb1E"}


def sass_counts(lib, marks=("HGMMA", "UTMALDG", "UBLKCP")):
    """{kernel (mangled): {mark: instructions}} from ``cuobjdump -sass`` of
    the built library ``lib``: HGMMA is wgmma, UTMALDG a TMA tensor load,
    UBLKCP a bulk copy, HMMA an mma.sync. cuobjdump ships with the CUDA
    toolkit; without it this raises."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    check(Path(tool).exists(), "cuobjdump not found: the SASS counts need the CUDA toolkit")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            counts[name] = dict.fromkeys(marks, 0)
        elif name is not None:
            for mark in marks:
                counts[name][mark] += mark in line
    return counts


def ptxas_usage(log):
    """{kernel (mangled): registers and spill bytes} from nvcc's -Xptxas -v
    output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
        elif name is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                out[name]["spill_stores"], out[name]["spill_loads"] = int(m[1]), int(m[2])
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[name]["registers"] = int(m[1])
    return out


def build_facts(lib, piece, marks=("HGMMA", "UTMALDG", "UBLKCP")):
    """(SASS instruction counts, ptxas registers and spills) of the one
    kernel of library ``lib`` (a name in _build.KERNELS) whose mangled name
    holds ``piece``; the build log from this process's build, or from a
    build made again for ptxas's report."""
    sass = [c for fn, c in sass_counts(_build._lib_path(lib), marks).items() if piece in fn]
    check(len(sass) == 1, f"{piece}: {len(sass)} kernels named so in the SASS of {lib}")
    log = _build.build_log.get(lib)
    if log is None:  # the library came from an earlier run: build it again for ptxas's report
        again = _build.BUILD_DIR / "ptxas_report"
        again.mkdir(parents=True, exist_ok=True)
        log = _build.build_log[lib] = _build.compile_sources(
            {lib: (_build.CSRC / f"{lib}.cu", again / f"{lib}.so")})[lib]
    usage = [u for fn, u in ptxas_usage(log[1]).items() if piece in fn]
    check(len(usage) == 1, f"{piece}: {len(usage)} kernels named so in the build log of {lib}")
    return sass[0], usage[0]


def dw_build_facts(key, rows, k, n):
    """What the dw kernel ``key`` (DW_INSTANCES) is, from its build: its
    SASS's wgmma and TMA instruction counts (each must be above zero), its
    registers and spills from the build log, its tile and the operand bytes
    a launch streams into the SMs at ``rows`` computed rows and a k x n
    dw."""
    sass, usage = build_facts("grouped_matmul", DW_INSTANCES[key])
    check(sass["HGMMA"] > 0 and sass["UTMALDG"] + sass["UBLKCP"] > 0,
          f"{key}: no wgmma or no TMA in its SASS: {sass}")
    tm, tn = gm.GMM_DW_TILE
    tiles = -(-k // tm) * -(-n // tn)
    return {"sass": sass, "ptxas": usage, "tile": [tm, tn],
            "operand_bytes": rows * tiles * (tm + tn) * 2}


# The flash kernels' instantiations, fwd_kernel<T, DP>, dq_kernel<T, DP>
# and dkv_kernel<T, DP> (DP: d padded to 64 or 128), by a piece of their
# mangled names.
FWD_INSTANCES = {"bf16_dp128": "fwd_kernelI13__nv_bfloat16Li128EE",
                 "bf16_dp64": "fwd_kernelI13__nv_bfloat16Li64EE",
                 "f32_dp128": "fwd_kernelIfLi128EE", "f32_dp64": "fwd_kernelIfLi64EE"}
BWD_INSTANCES = {f"{kind}_{key}": f"{kind}_kernel{piece}" for kind in ("dq", "dkv")
                 for key, piece in (("bf16_dp128", "I13__nv_bfloat16Li128EE"),
                                    ("bf16_dp64", "I13__nv_bfloat16Li64EE"),
                                    ("f32_dp128", "IfLi128EE"), ("f32_dp64", "IfLi64EE"))}


# The grouped-matmul forward's instantiations, fwd_kernel<T, TRANS,
# SCALED>: K5, its dx form and K6, bf16 (the path's) and f32.
GMM_FWD_INSTANCES = {"k5": "fwd_kernelI13__nv_bfloat16Lb0ELb0E",
                     "k5_dx": "fwd_kernelI13__nv_bfloat16Lb1ELb0E",
                     "k6": "fwd_kernelI13__nv_bfloat16Lb0ELb1E",
                     "k5_f32": "fwd_kernelIfLb0ELb0E", "k5_dx_f32": "fwd_kernelIfLb1ELb0E",
                     "k6_f32": "fwd_kernelIfLb0ELb1E"}


def wgmma_advisories(log, piece):
    """nvcc's advisories that ptxas serialises a kernel's wgmma (C7512,
    C7514, C7520) about the kernel whose mangled name holds ``piece``, or
    naming no kernel."""
    return [ln.strip() for ln in log.splitlines()
            if re.search(r"C75(12|14|20)", ln) and (piece in ln or "_Z" not in ln)]


def tma_build_facts(lib="flash_fwd", instances=FWD_INSTANCES):
    """The instantiations of a TMA + wgmma kernel (K1's by default; the
    backward's with BWD_INSTANCES, the grouped matmul's forward with
    GMM_FWD_INSTANCES) from their build: wgmma (HGMMA) and TMA (UTMALDG)
    instructions, each above zero, no mma.sync (HMMA), their registers and
    spill bytes, which must be 0, and no wgmma serialisation advisory."""
    out = {}
    for key, piece in instances.items():
        sass, usage = build_facts(lib, piece, ("HGMMA", "UTMALDG", "HMMA"))
        check(sass["HGMMA"] > 0 and sass["UTMALDG"] > 0 and sass["HMMA"] == 0,
              f"{lib} {key}: not a TMA + wgmma kernel by its SASS: {sass}")
        check(usage.get("spill_stores", 0) == 0 and usage.get("spill_loads", 0) == 0,
              f"{lib} {key}: spills registers: {usage}")
        advisories = wgmma_advisories(_build.build_log[lib][1], piece)
        check(not advisories, f"{lib} {key}: ptxas serialises its wgmma: {advisories}")
        out[key] = {"sass": sass, "ptxas": usage}
    return out


def phase_gmm_timing(smi, dev="cuda", tokens=8192, E=8, d=768, f=3072, B=256):
    """K5, K6, K7a and K7b, and K5's dx use at both of its shapes (f -> d
    for gate and up, d -> f for the down product's t), at the moe_train
    shapes: b 16 x t 512 = 8192 top-1 choices over 8 experts in 256-row
    blocks (10240 rows), gate/up 768 -> 3072 and down 3072 -> 768, bf16;
    padding rows carry zero cotangents and scales. Beside each: its bound
    (the larger of 2·rows·k·n operations at 989 TFLOP/s, rows = the
    non-sentinel rows the kernel computes, and its bytes at 3.35 TB/s, each
    input read once and each output written once), its plain version and
    the library yardstick (grouped_mm_yardstick); for the scaled kernels
    (K6, K7b) that call runs on the input scaled before the timing, and the
    two calls that compute the same function from the unscaled input are
    timed beside it. Then the forward's and the dw's build facts."""
    rng = np.random.RandomState(8)
    gen = torch.Generator(dev).manual_seed(8)
    be, valid, pad_start = routed_block_map(rng, tokens, E, B, dev)
    R = be.numel() * B
    ends = torch.cat([pad_start[1:], torch.tensor([R], device=dev)]).to(torch.int32)
    bf = torch.bfloat16

    def draw(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale).to(bf)

    x, h = draw(R, d), draw(R, f)
    w_up, w_down = draw(E, d, f, scale=d**-0.5), draw(E, f, d, scale=f**-0.5)
    dy_up, dy_down = draw(R, f) * valid[:, None], draw(R, d) * valid[:, None]
    s = torch.rand(R, device=dev, generator=gen) * valid
    hs = (h.float() * s[:, None]).to(bf)
    rows = int((be >= 0).sum()) * B
    e2, e4 = 2, 4
    specs = {  # name: (kernel, plain, library (a, b), mm args, ops, bytes, out dims)
        "k5": (lambda i: gm.gmm_fwd_kernel(x, w_up, be, block_rows=B),
               lambda i: gm.gmm_fwd_reference(x, w_up, be, block_rows=B),
               (x, w_up), (x, w_up[0]), 2 * rows * d * f,
               R * d * e2 + E * d * f * e2 + R * f * e2 + be.numel() * 4, (-1,)),
        "k6": (lambda i: gm.gmm_fwd_kernel(h, w_down, be, s, block_rows=B),
               lambda i: gm.gmm_fwd_reference(h, w_down, be, s, block_rows=B),
               (hs, w_down), (hs, w_down[0]), 2 * rows * f * d,
               R * f * e2 + E * f * d * e2 + R * e4 + R * d * e2 + be.numel() * 4, (-1,)),
        "k7a": (lambda i: gm.gmm_dw_kernel(x, dy_up, be, E, block_rows=B),
                lambda i: gm.gmm_dw_reference(x, dy_up, be, E, block_rows=B),
                (x.t(), dy_up), (x.t(), dy_up), 2 * rows * d * f,
                R * d * e2 + R * f * e2 + E * d * f * e4 + be.numel() * 4, (1, 2)),
        "k7b": (lambda i: gm.gmm_dw_kernel(h, dy_down, be, E, s, block_rows=B),
                lambda i: gm.gmm_dw_reference(h, dy_down, be, E, s, block_rows=B),
                (hs.t(), dy_down), (hs.t(), dy_down), 2 * rows * f * d,
                R * f * e2 + R * d * e2 + R * e4 + E * f * d * e4 + be.numel() * 4, (1, 2)),
        "k5_dx": (lambda i: gm.gmm_fwd_kernel(dy_up, w_up, be, block_rows=B, trans_w=True),
                  lambda i: gm.gmm_fwd_reference(dy_up, w_up, be, block_rows=B, trans_w=True),
                  (dy_up, w_up.transpose(1, 2)), (dy_up, w_up[0].t()), 2 * rows * f * d,
                  R * f * e2 + E * d * f * e2 + R * d * e2 + be.numel() * 4, (-1,)),
        "k5_dx_down": (lambda i: gm.gmm_fwd_kernel(dy_down, w_down, be, block_rows=B,
                                                   trans_w=True),
                       lambda i: gm.gmm_fwd_reference(dy_down, w_down, be, block_rows=B,
                                                      trans_w=True),
                       (dy_down, w_down.transpose(1, 2)), (dy_down, w_down[0].t()),
                       2 * rows * d * f,
                       R * d * e2 + E * f * d * e2 + R * f * e2 + be.numel() * 4, (-1,)),
    }
    hs_scale = s.to(bf)[:, None]
    # the scaled kernels' function in two calls: scale in bf16, then the product
    two_call = {"k6": lambda i: torch._grouped_mm(h * hs_scale, w_down, offs=ends),
                "k7b": lambda i: torch._grouped_mm((h * hs_scale).t(), dy_down, offs=ends)}
    out = {}
    for name, (kern, plain, lib_ab, mm_args, ops, nbytes, dims) in specs.items():
        got, want = kern(0), plain(0).float()
        torch.cuda.synchronize()
        err = (got.float() - want).abs()
        check(bool((err <= gmm_limit(want, bf, dims)).all()),
              f"{name} at the moe_train shape: max abs err {float(err.max())}")
        lib, label, lib_err = grouped_mm_yardstick(*lib_ab, ends, want, bf, dims, mm_args)
        fns = [("kernel", kern), ("plain", plain), ("library", lib)]
        if name in two_call and label.startswith("torch._grouped_mm"):
            label += ", on the input scaled before the timing"
            fns.append(("library_two_call", two_call[name]))
        del got, want
        ms, source, runs = timed_in_turns(
            fns, {"kernel": 20, "plain": 3, "library": 20, "library_two_call": 20})
        ops_ms, bytes_ms = ops / BF16_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = {
            "ms": ms["kernel"], "plain_ms": ms["plain"], "library_ms": ms["library"],
            "library": label, "library_max_abs_err": lib_err,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "ops": ops, "bytes": nbytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "tflops": ops / ms["kernel"] / 1e9, "max_abs_err": float(err.max()),
            "ms_source": source, "runs": runs,
        }
        if "library_two_call" in ms:
            out[name]["library_two_call_ms"] = ms["library_two_call"]
            out[name]["library_two_call"] = ("(h * s) in bf16, then torch._grouped_mm on the "
                                             "same expert groups")
        if name in DW_INSTANCES:
            out[name].update(dw_build_facts(name, rows, *((d, f) if name == "k7a" else (f, d))))
            # the call's device time: the dw kernel, and the block lists'
            # PyTorch ops (_expert_block_lists) the wrapper runs before it
            out[name]["dw_kernel_ms"], out[name]["block_lists_ms"] = device_ms_split(
                kern, 20, "dw_kernel")
    out["fwd_build"] = tma_build_facts("grouped_matmul", GMM_FWD_INSTANCES)
    emit({"phase": "gmm_timing", "shape": {"tokens": tokens, "experts": E, "block_rows": B,
                                           "rows": R, "computed_rows": rows, "d": d, "f": f,
                                           "dtype": "bfloat16"},
          "card": smi, **out})
    return out


# ---------------------------------------------------------------------------
# ResNet training: the fused matmul + BN-statistics kernel (K8)
# ---------------------------------------------------------------------------


def fused_1x1_shapes(cfg, batch, image):
    """(M, K, N) of every fused_linear_stats launch of one train-mode
    forward with fused_1x1, in launch order: per bottleneck conv1 at the
    block's input size, conv3 and (where the block has one) the projection
    at its output size."""
    h = -(-(-(-image // 2)) // 2)  # the stem (stride 2), then the max pool (stride 2)
    cin, out = 64, []
    for si, (n_blocks, width) in enumerate(zip(cfg.stage_sizes, cfg.widths)):
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            cout, ho = width * 4, -(-h // stride)
            out += [(batch * h * h, cin, width), (batch * ho * ho, width, cout)]
            if stride != 1 or cin != cout:
                out.append((batch * ho * ho, cin, cout))
            cin, h = cout, ho
    return out


# shapes off the kernel's tile grid (M not a multiple of 128, K not of 32,
# N below and between the 64 and 128 tile widths)
FLS_OFF_GRID = ((1000, 72, 40), (1000, 264, 200), (333, 8, 136))


def fls_case(gen, m, k, n, dtype, dev, prologue):
    """Inputs of one K8 check: x [m, k] (N(0, 1)), w [k, n] (N(0, 1/k)), and
    for the prologue a in [0.5, 1.5), b N(0, 0.5^2)."""
    x = torch.randn(m, k, device=dev, generator=gen)
    w = torch.randn(k, n, device=dev, generator=gen) * k**-0.5
    a = b = None
    if prologue:
        a = torch.rand(k, device=dev, generator=gen) + 0.5
        b = torch.randn(k, device=dev, generator=gen) * 0.5
    return x.to(dtype), w.to(dtype), a, b


def compare_fls(x, w, a, b):
    """K8 against its plain version on the same card tensors (f32). Returns
    {name: (max abs err, largest err / limit)} for y, sum and ssq (see
    FLS_STATS_C for the limits and the operand the statistics are held
    to)."""
    y, s, q = fls.fused_linear_stats_kernel(x, w, a, b)
    relu = a is not None
    y_ref = fls._reference(x.float(), w.float(), a, b, relu)[0]
    xin = x.float()
    if relu:
        # the operand the kernel multiplies: x*a + b rounded once to f32 (a
        # fused multiply-add; in f64 here, exact before that one rounding),
        # the ReLU, then x's dtype
        xin = torch.relu((x.double() * a.double() + b.double()).float()).to(x.dtype).float()
    y32, s_ref, q_ref = fls._reference(xin, w.float(), None, None, False)
    torch.cuda.synchronize()
    out = {}
    for name, got in (("y", y), ("sum", s), ("ssq", q)):
        check(bool(torch.isfinite(got).all()), f"fused_linear_stats {name} not finite")
    # an error where the limit is 0 (an all-zero row or column) counts as
    # infinitely over it
    err = (y.float() - y_ref).abs()
    y_limit = flash_limit("y", y_ref, x.dtype)
    if x.dtype == torch.float32:
        y_limit = y_limit + FLS_F32_RTOL * y_ref.abs()
    ratio = torch.where(err == 0, 0.0, err / y_limit)
    out["y"] = (float(err.max()), float(ratio.max()))
    for name, got, want, mag in (("sum", s, s_ref, y32.abs().sum(0)),
                                 ("ssq", q, q_ref, (y32 * y32).sum(0))):
        err = (got - want).abs()
        limit = FLS_STATS_C["f32" if x.dtype == torch.float32 else "bf16"] * F32_EPS * mag
        ratio = torch.where(err == 0, 0.0, err / limit)
        out[name] = (float(err.max()), float(ratio.max()))
    return out


def phase_fls_check(dev, shapes=None):
    """K8 against its plain version on the card (compare_fls): the distinct
    shapes of ResNet-50's 1x1 convolutions at RESNET_WL's batch and image
    size, and FLS_OFF_GRID, in bf16 and f32, with and without the
    prologue."""
    if shapes is None:
        shapes = sorted(set(fused_1x1_shapes(ResNetConfig.resnet50(), RESNET_WL["batch_size"],
                                             RESNET_WL["image_size"])))
    gen = torch.Generator(dev).manual_seed(5)
    worst = {dt: {k: 0.0 for k in ("y", "sum", "ssq")} for dt in ("f32", "bf16")}
    ratio = {dt: {k: 0.0 for k in ("y", "sum", "ssq")} for dt in ("f32", "bf16")}
    n, failures = 0, []  # checked after the line is printed
    for m, k, nn in (*shapes, *FLS_OFF_GRID):
        for dtype in (torch.float32, torch.bfloat16):
            key = "f32" if dtype == torch.float32 else "bf16"
            for prologue in (False, True):
                errs = compare_fls(*fls_case(gen, m, k, nn, dtype, dev, prologue))
                if not all(r <= 1.0 for _, r in errs.values()):
                    failures.append(f"M {m} K {k} N {nn} {dtype} prologue={prologue}: {errs}")
                for part, (e, r) in errs.items():
                    worst[key][part] = max(worst[key][part], e)
                    ratio[key][part] = max(ratio[key][part], r)
                n += 1
    emit({"phase": "fls_check", "cases": n, "path_shapes": [list(t) for t in shapes],
          "off_grid_shapes": [list(t) for t in FLS_OFF_GRID],
          "limits": {"y_f32_atol": FLASH_F32_ATOL, "y_f32_rtol": FLS_F32_RTOL,
                     "y_bf16_rtol": FLASH_BF16_RTOL, "y_bf16_row_rms_atol": FLASH_BF16_ROW_ATOL,
                     "stats_eps_multiple": FLS_STATS_C,
                     "stats": "multiple x eps_f32 x sum|y| (sum), x sum y^2 (ssq)"},
          "max_abs_err": worst, "worst_err_over_limit": ratio, "failures": failures})
    check(not failures, f"fused_linear_stats vs plain: {failures}")
    return worst, ratio


FLS_PLANTS = {
    # the last row tile's rows never reach the statistics
    "stats_skip_last_tile": ("fls", "fused_linear_stats.cu",
                             "const float keep = row < M ? 1.f : 0.f;",
                             "const float keep = (row < M && blockIdx.y + 1 < gridDim.y) ? 1.f "
                             ": 0.f;"),
    # the statistics of the bf16-rounded y instead of the f32 accumulator
    "stats_from_rounded_y": ("fls", "fused_linear_stats.cu",
                             "const float v = acc[mi][ni][2 * half + j] * keep;",
                             "const float v = __bfloat162float(__float2bfloat16("
                             "acc[mi][ni][2 * half + j])) * keep;"),
    # the prologue applies the affine without the ReLU
    "prologue_no_relu": ("fls", "fused_linear_stats.cu",
                         "for (int j = 0; j < 8; ++j) v[j] = fmaxf(__fmaf_rn(v[j], av[j], bv[j]), 0.f);",
                         "for (int j = 0; j < 8; ++j) v[j] = __fmaf_rn(v[j], av[j], bv[j]);"),
}
# (M, K, N) of fls_plant: off the tile grid, and M at ~10^3 (FLS_STATS_C)
FLS_PLANT_SHAPES = ((1000, 72, 40), (1000, 256, 128))


@contextlib.contextmanager
def fls_planted(lib):
    """Route the K8 wrapper to the planted library."""
    fls._fls_fn()  # bind the real one first, so it can be put back
    real = fls._fns[fls.FLS_ENTRY]
    fls._fns[fls.FLS_ENTRY] = fls.bind_fls_entry(lib)
    try:
        yield
    finally:
        fls._fns[fls.FLS_ENTRY] = real


def phase_fls_plant(dev):
    """Each planted fault (FLS_PLANTS) at FLS_PLANT_SHAPES, bf16 and f32,
    with and without the prologue: the check of phase fls_check must fail
    on the faulty kernel's outputs by 10x its limit or more (the worst
    case of each plant). Launches here are not the main path's."""
    libs = build_plants(tuple(FLS_PLANTS), FLS_PLANTS)
    gen = torch.Generator(dev).manual_seed(6)
    cases = [fls_case(gen, m, k, n, dtype, dev, prologue) for m, k, n in FLS_PLANT_SHAPES
             for dtype in (torch.bfloat16, torch.float32) for prologue in (False, True)]
    out = {}
    for name, lib in libs.items():
        with fls_planted(lib):
            errs = [compare_fls(*c) for c in cases]
        worst = {part: max(e[part][1] for e in errs) for part in ("y", "sum", "ssq")}
        check(max(worst.values()) >= 10.0,
              f"planted fault {name} not caught at 10x its limit: {worst}")
        out[name] = worst
    emit({"phase": "fls_plant", "caught": len(out), "shapes": [list(t) for t in FLS_PLANT_SHAPES],
          "worst_err_over_limit": out})


# ---------------------------------------------------------------------------
# ResNet training: the main path
# ---------------------------------------------------------------------------


def phase_resnet_train(smi, dev="cuda", wl=RESNET_WL, fused=True, phase="resnet_train"):
    """ResNet-50 at full width and depth through run_resnet, fused_1x1 as
    given: one warmup and wl["steps"] timed steps; K8 launched exactly once
    per fused 1x1 convolution of every step (36 at ResNet-50) and no other
    kernel; the loss finite, and falling with fused_1x1. (At lr 0.1 on one
    random batch the loss swings: the first H100 run's unfused yardstick
    rose from 7.06 to 12.59 at its ninth step, the fused run to 6.39.)"""
    cfg = replace(ResNetConfig.resnet50(int(wl["num_classes"])), fused_1x1=fused)
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    run = run_resnet(wl, device=dev, cfg=cfg)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    n = len(run.losses)
    per_step = len(fused_1x1_shapes(cfg, wl["batch_size"], wl["image_size"])) if fused else 0
    want = {name: 0 for name in COUNTERS}
    want["fused_linear_stats_launches"] = per_step * n
    check(counts == want, f"{phase} launches {counts} != {want}")
    check(all(np.isfinite(run.losses)), f"non-finite loss: {run.losses}")
    if fused:  # the path under test; the unfused run is its yardstick
        check(run.losses[-1] < run.losses[0], f"loss did not fall: {run.losses}")
    emit({
        "phase": phase, "variant": wl["variant"], "fused_1x1": fused,
        "params": sum(p.numel() for p in tree_leaves(run.state.params)),
        "batch": wl["batch_size"], "image": wl["image_size"], "dtype": str(cfg.dtype),
        "optimizer": "sgd momentum 0.9", "lr": wl["lr"],
        "bn_stats_stop_gradient": cfg.bn_stats_stop_gradient,
        "steps": n, "timed_steps": run.timed, "losses": run.losses,
        "launches": counts, "fls_launches_per_step": counts["fused_linear_stats_launches"] / n,
        "step_ms": run.step_s * 1e3, "images_per_s": run.images_per_s,
        "model_flops_per_step": run.flops, "mfu": run.mfu(),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9 if on_card else None,
        "run_resnet_wall_s": wall, "card": smi,
    })
    return run, counts


def phase_resnet_breakdown(run, smi, iters=2):
    """ResNet training steps (fused_1x1) on the host clock and under
    torch.profiler, as train_breakdown, K8 a family of its own; then the
    SGD update alone under the profiler (on grads of one more backward),
    which the elementwise family of a step includes."""
    phase_train_breakdown(run, smi, iters=iters, phase="resnet_breakdown", batch=run.batch)
    loss, _ = resnet_loss(run.state.params, run.batch, run.state.extra, run.cfg)
    loss.backward()
    rows = profile_kernels(lambda: run.trainer._apply(run.state))
    emit({"phase": "resnet_breakdown_sgd", "sgd_update_device_ms": sum(r[2] for r in rows),
          "sgd_update_device_items": sum(r[1] for r in rows),
          "top_kernels": [{"kernel": k[:100], "launches": c, "ms": t} for k, c, t in rows[:4]],
          "card": smi})


@contextlib.contextmanager
def plain_fls():
    """Route CUDA tensors of fused_linear_stats to its plain version."""
    saved = fls.fused_linear_stats_kernel
    fls.fused_linear_stats_kernel = lambda x, w, a=None, b=None: fls._reference(
        x, w, a, b, a is not None)
    try:
        yield
    finally:
        fls.fused_linear_stats_kernel = saved


def phase_resnet_parity(dev, batch=8, image=64, steps=3):
    """ResNet-50 widths at one block a stage, image 64, b 8: (1) f32 loss, BN
    state and grads on the card (K8, cuDNN, cuBLAS) against the CPU (plain
    versions) from the same params and batch, fused_1x1 on and off; (2) 3
    bf16 SGD steps (lr 0.1) on the card with K8 against 3 with its plain
    version on the same card tensors."""
    base = replace(ResNetConfig.resnet50(), stage_sizes=(1, 1, 1, 1))
    params, state = init_resnet(base, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.RandomState(7)
    images = torch.from_numpy(rng.standard_normal((batch, image, image, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 1000, batch))
    out = {"phase": "resnet_parity", "stage_sizes": list(base.stage_sizes),
           "widths": list(base.widths), "batch": batch, "image": image}
    failures = []  # checked after the line is printed, so a failure shows its numbers
    for fused in (False, True):
        cfg = replace(base, dtype=torch.float32, fused_1x1=fused)

        def loss_and_grads(where, imgs=images):
            p = tree_map(lambda x: x.detach().to(where).requires_grad_(True), params)
            loss, new_state = resnet_loss(p, (imgs.to(where), labels.to(where)),
                                          tree_map(lambda x: x.to(where), state), cfg)
            loss.backward()
            return (float(loss.detach()), tree_map(lambda x: x.cpu(), new_state),
                    tree_map(lambda x: x.grad.cpu(), p))

        reset_counts()
        card_loss, card_state, card_g = loss_and_grads(dev)
        k8 = read_counts()["fused_linear_stats_launches"]
        check(k8 == (len(fused_1x1_shapes(cfg, batch, image)) if fused else 0),
              f"resnet_parity fused={fused}: {k8} K8 launches")
        cpu_loss, cpu_state, cpu_g = loss_and_grads("cpu")
        ulp = torch.from_numpy(np.random.RandomState(8).choice([-1.0, 1.0], images.shape))
        _, _, nudged_g = loss_and_grads("cpu", images * (1 + 2.0**-23 * ulp).float())
        loss_err = abs(card_loss - cpu_loss)
        state_err = max(float((a - b).abs().max()) for a, b in
                        zip(tree_leaves(card_state), tree_leaves(cpu_state)))
        g_max = max(float(g.abs().max()) for g in tree_leaves(cpu_g))
        g_err = max(float((a - b).abs().max()) for a, b in
                    zip(tree_leaves(card_g), tree_leaves(cpu_g)))
        g_norm = float(torch.cat([g.flatten() for g in tree_leaves(cpu_g)]).norm())

        def rel(other):
            return float(torch.cat([(a - b).flatten() for a, b in
                                    zip(tree_leaves(other), tree_leaves(cpu_g))]).norm()) / g_norm

        g_rel, noise = rel(card_g), rel(nudged_g)
        g_limit = max(RESNET_PARITY_NOISE_X * noise, RESNET_PARITY_GRAD_FLOOR)
        own = {name: float((gc - gp).abs().max()) / max(float(gp.abs().max()), 1e-30)
               for (name, gc), (_, gp) in zip(leaves_with_names(card_g),
                                              leaves_with_names(cpu_g))}
        failures += [what for ok, what in (
            (loss_err <= RESNET_PARITY_ATOL, f"fused={fused} loss {card_loss} vs {cpu_loss}"),
            (state_err <= RESNET_PARITY_ATOL, f"fused={fused} BN state {state_err}"),
            (g_rel <= g_limit, f"fused={fused} grads {g_rel} norm-wise > {g_limit}"))
            if not ok]
        worst_own = sorted(own.items(), key=lambda kv: -kv[1])[:5]
        out[f"f32_fused_1x1={fused}"] = {
            "loss_card": card_loss, "loss_cpu": cpu_loss, "loss_abs_diff": loss_err,
            "bn_state_max_abs_diff": state_err, "grad_max_abs_diff": g_err,
            "grad_largest_magnitude": g_max, "grad_diff_over_largest": g_err / g_max,
            "grad_norm_rel_diff": g_rel, "grad_norm_rel_one_ulp_images": noise,
            "grad_norm_rel_limit": g_limit,
            "grad_leaf_rel_diff_worst5": dict(worst_own)}
    out["f32_limits"] = {"loss_atol": RESNET_PARITY_ATOL, "bn_state_atol": RESNET_PARITY_ATOL,
                         "grad_norm_rel": f"max({RESNET_PARITY_NOISE_X} x the one-ulp-images "
                                          f"change, {RESNET_PARITY_GRAD_FLOOR})"}

    cfg16 = replace(base, fused_1x1=True)
    data = (images.to(dev), labels.to(dev))

    def train(use_plain):
        trainer = Trainer(loss_fn=lambda p, b, e: resnet_loss(p, b, e, cfg16), init_fn=None,
                          config=TrainerConfig(optimizer="sgd", learning_rate=0.1,
                                               grad_clip=None), device=dev)
        st = trainer.state_from_params(tree_map(lambda x: x.clone().to(dev), params),
                                       tree_map(lambda x: x.clone().to(dev), state))
        reset_counts()
        losses = []
        with plain_fls() if use_plain else contextlib.nullcontext():
            for _ in range(steps):
                st, m = trainer.step(st, data)
                losses.append(m["loss"])
        return [float(x) for x in losses], read_counts()["fused_linear_stats_launches"]

    kern, kern_n = train(False)
    plain, plain_n = train(True)
    check(kern_n == len(fused_1x1_shapes(cfg16, batch, image)) * steps and plain_n == 0,
          f"bf16 steps: K8 launches {kern_n} (kernel run), {plain_n} (plain run)")
    step_err = max(abs(a - b) for a, b in zip(kern, plain))
    first_err = abs(kern[0] - plain[0])
    if not (all(np.isfinite(kern)) and step_err <= PARITY_BF16_LOSS_ATOL
            and first_err <= PARITY_BF16_FIRST_STEP_ATOL):
        failures.append(f"bf16 steps, K8 {kern} vs plain {plain}")
    out.update({"bf16_losses_kernel": kern, "bf16_losses_plain": plain,
                "bf16_loss_max_abs_diff": step_err, "bf16_loss_atol": PARITY_BF16_LOSS_ATOL,
                "bf16_first_step_abs_diff": first_err,
                "bf16_first_step_atol": PARITY_BF16_FIRST_STEP_ATOL})
    emit(out)
    check(not failures, f"resnet_parity: {failures}")


def phase_fls_timing(smi, dev="cuda"):
    """K8 at every distinct shape of resnet_train (bf16, no prologue, as the
    path runs it) beside its bound (the larger of 2MKN operations at 989
    TFLOP/s and its bytes at 3.35 TB/s: x and w read once, y and the two
    f32 [N] statistics written once), its plain version, torch.mm alone
    (the product, no statistics) and torch.mm with an f32 result plus the
    two column reductions and the cast of y (the unfused sequence). No one
    PyTorch call computes K8's function. Per-step sums weight each shape
    by its launches a step."""
    cfg = ResNetConfig.resnet50()
    launches = fused_1x1_shapes(cfg, RESNET_WL["batch_size"], RESNET_WL["image_size"])
    gen = torch.Generator(dev).manual_seed(8)
    bf = torch.bfloat16
    per_shape = []
    for shape in sorted(set(launches), key=lambda t: -t[0] * t[1] * t[2]):
        m, k, n = shape
        x, w, _, _ = fls_case(gen, m, k, n, bf, dev, False)

        def unfused(i):
            y32 = torch.mm(x, w, out_dtype=torch.float32)
            return y32.to(bf), y32.sum(0), (y32 * y32).sum(0)

        errs = compare_fls(x, w, None, None)
        check(all(r <= 1.0 for _, r in errs.values()), f"K8 at {shape}: {errs}")
        ms, source, runs = timed_in_turns(
            [("kernel", lambda i: fls.fused_linear_stats_kernel(x, w)),
             ("plain", lambda i: fls._reference(x, w, None, None, False)),
             ("mm", lambda i: torch.mm(x, w)), ("unfused", unfused)],
            {"kernel": 20, "plain": 3, "mm": 20, "unfused": 10})
        ops, nbytes = 2 * m * k * n, 2 * (m * k + k * n + m * n) + 2 * 4 * n
        ops_ms, bytes_ms = ops / BF16_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        count = launches.count(shape)
        per_shape.append({
            "m": m, "k": k, "n": n, "launches_per_step": count, "ms": ms["kernel"],
            "plain_ms": ms["plain"], "mm_ms": ms["mm"], "mm_plus_reductions_ms": ms["unfused"],
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "ops_ms": ops_ms, "bytes_ms": bytes_ms, "tflops": ops / ms["kernel"] / 1e9,
            "ms_per_step": ms["kernel"] * count, "max_abs_err": errs["y"][0],
            "ms_source": source, "runs": runs})
        del x, w
    per_shape.sort(key=lambda r: -r["ms_per_step"])
    step = {key: sum(r[key] * r["launches_per_step"] for r in per_shape)
            for key in ("ms", "plain_ms", "mm_ms", "mm_plus_reductions_ms", "bound_ms",
                        "ops_ms", "bytes_ms")}
    step["bound_by"] = "operations" if step["ops_ms"] >= step["bytes_ms"] else "bytes"
    step["launches"] = len(launches)
    step["max_abs_err"] = max(r["max_abs_err"] for r in per_shape)
    emit({"phase": "fls_timing", "dtype": "bfloat16", "batch": RESNET_WL["batch_size"],
          "image": RESNET_WL["image_size"],
          "yardsticks": "mm: torch.mm(x, w), the product alone; mm_plus_reductions: "
                        "torch.mm(out_dtype=f32), its column sum and sum of squares and the "
                        "bf16 cast of y; no one PyTorch call computes K8's function",
          "per_step": step, "top3_by_step_time": per_shape[:3], "shapes": per_shape,
          "card": smi})
    return step


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    smi = nvidia_smi()
    phase_s = {}

    def run_phase(name, fn, *args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        phase_s[name] = time.perf_counter() - t
        return out

    run_phase("build", build_all)
    ptxas = [f"{name}: {ln.strip()}" for name, (_, out) in _build.build_log.items()
             if name in _build.KERNELS
             for ln in out.splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "device", "card": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_build_s": phase_s["build"],
          "builds_s": {name: secs for name, (secs, _) in _build.build_log.items()},
          "ptxas": ptxas})

    # serving path
    check_err = run_phase("kernel_check", phase_kernel_check, dev)
    engine, res, launches = run_phase("serve", phase_serve, smi)
    run_phase("whole_path", phase_whole_path, engine)
    run_phase("breakdown", phase_breakdown, engine, smi)
    cfg = engine.cfg
    del engine, res
    torch.cuda.empty_cache()
    timing = run_phase("kernel_timing", phase_kernel_timing, cfg)

    # training path: gqa-2048
    flash_err = run_phase("flash_check", phase_flash_check, dev)
    run_phase("flash_plant", phase_flash_plant, dev)
    run, train_counts = run_phase("train", phase_train, smi)
    run_phase("train_breakdown", phase_train_breakdown, run, smi)
    del run
    torch.cuda.empty_cache()
    run_phase("train_parity", phase_train_parity, dev)
    ft = run_phase("flash_timing", phase_flash_timing, smi)

    # MoE training path: moe-small
    gmm_err = run_phase("gmm_check", phase_gmm_check, dev)
    run_phase("gmm_plant", phase_gmm_plant, dev)
    torch.cuda.empty_cache()
    moe_run, moe_counts = run_phase("moe_train", phase_train, smi, MOE_WL,
                                    per_layer=MOE_PER_LAYER, phase="moe_train")
    run_phase("moe_train_breakdown", phase_train_breakdown, moe_run, smi,
              phase="moe_train_breakdown")
    del moe_run
    torch.cuda.empty_cache()
    run_phase("moe_parity", phase_train_parity, dev, MOE_WL, per_layer=MOE_PER_LAYER,
              phase="moe_parity", bf16_atol=PARITY_MOE_BF16_LOSS_ATOL)
    gt = run_phase("gmm_timing", phase_gmm_timing, smi)

    # ResNet training path: ResNet-50
    torch.cuda.empty_cache()
    fls_err, fls_ratio = run_phase("fls_check", phase_fls_check, dev)
    run_phase("fls_plant", phase_fls_plant, dev)
    torch.cuda.empty_cache()
    resnet_run, resnet_counts = run_phase("resnet_train", phase_resnet_train, smi)
    run_phase("resnet_breakdown", phase_resnet_breakdown, resnet_run, smi)
    del resnet_run
    torch.cuda.empty_cache()
    unfused_run, _ = run_phase("resnet_train_unfused", phase_resnet_train, smi, fused=False,
                               phase="resnet_train_unfused")
    # the yardstick's device time: the host clock moves with the host
    run_phase("resnet_breakdown_unfused", phase_train_breakdown, unfused_run, smi,
              phase="resnet_breakdown_unfused", batch=unfused_run.batch)
    del unfused_run
    torch.cuda.empty_cache()
    run_phase("resnet_parity", phase_resnet_parity, dev)
    torch.cuda.empty_cache()
    flt = run_phase("fls_timing", phase_fls_timing, smi)

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
        # moe-small's attention shape, which its path launches 24 (forward)
        # or 12 (backward) times a step too
        if kind != "fwd":
            # no library call computes dq (or dk, dv) alone; SDPA's backward
            # computes all three in one call, timed here as a yardstick
            kernels[-1]["library_bwd_all_ms"] = ft["library_bwd_all_ms"]
            m = ft["bwd_moe_shape"]
            kernels[-1]["moe_shape"] = {"shape": m["shape"], "ms": m[kind]["ms"],
                                        "bound_ms": m[kind]["bound_ms"],
                                        "library_bwd_all_ms": m["library_bwd_all_ms"]}
        else:
            m = ft["fwd_moe_shape"]
            kernels[-1]["moe_shape"] = {x: m[x] for x in ("shape", "ms", "library_ms", "bound_ms")}
    for key, name, line, counter in (
            ("k5", "gmm_fwd", 122, "gmm_fwd_launches"),
            ("k6", "gmm_fwd_scaled", 144, "gmm_fwd_scaled_launches"),
            ("k7a", "gmm_dw", 222, "gmm_dw_launches"),
            ("k7b", "gmm_dw_scaled", 244, "gmm_dw_scaled_launches")):
        t = gt[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "tf_operator_tpu_torch/ops/csrc/grouped_matmul.cu",
            "replaces": f"tf_operator_tpu/ops/grouped_matmul.py:{line}",
            "launches": moe_counts[counter],
            # bf16 (the path's type) against the f32 plain version on the same
            # inputs, over every gmm_check case and the moe_train shape; the
            # f32 instantiation's error beside it
            "max_abs_err": max(gmm_err["bf16"][key], t["max_abs_err"]),
            "max_abs_err_f32": gmm_err["f32"][key],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"], "library": t["library"],
        })
        if key == "k5":
            # the dx form at the path's two shapes: gate and up's (f -> d,
            # 24 launches a step) and the down product's t (d -> f, 12)
            kernels[-1]["dx"] = {
                shape: {x: gt[dx][x] for x in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                "bound_by", "max_abs_err")}
                for shape, dx in (("f_to_d", "k5_dx"), ("d_to_f", "k5_dx_down"))}
        if "library_two_call_ms" in t:
            kernels[-1]["library_two_call_ms"] = t["library_two_call_ms"]
    kernels.append({
        "name": "fused_linear_stats", "route": "cuda",
        "source": "tf_operator_tpu_torch/ops/csrc/fused_linear_stats.cu",
        "replaces": "tf_operator_tpu/ops/fused_linear_stats.py:69",
        "launches": resnet_counts["fused_linear_stats_launches"],
        # y in bf16 (the path's type) against the f32 plain version on the
        # same inputs, over every fls_check case and the timing shapes
        "max_abs_err": max(fls_err["bf16"]["y"], flt["max_abs_err"]),
        "max_abs_err_f32": fls_err["f32"]["y"],
        # the sum and sum of squares: worst error over its limit (FLS_STATS_C)
        "stats_worst_err_over_limit": max(fls_ratio[d][p] for d in fls_ratio
                                          for p in ("sum", "ssq")),
        # times, bound and plain time summed over the 36 launches of one
        # ResNet-50 step (b 128, 224^2); per shape in the fls_timing line
        "ms": flt["ms"], "plain_ms": flt["plain_ms"], "bound_ms": flt["bound_ms"],
        "bound_by": flt["bound_by"], "library_ms": None,
        "per": "one ResNet-50 step (36 launches)",
        "mm_ms": flt["mm_ms"], "mm_plus_reductions_ms": flt["mm_plus_reductions_ms"],
    })
    emit({"phase": "wall", "total_s": time.perf_counter() - t_start, "phase_s": phase_s})
    emit({"kernels": kernels})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
