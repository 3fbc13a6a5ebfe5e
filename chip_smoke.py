#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths (dense, masked-LM,
every remat policy, MoE under every dispatch, and ResNet; one process and
ranks sharing the card under fsdp, tp, cp, ep and pp meshes), its input
pipeline and its Evaluator on one NVIDIA GPU and check them.

Usage, from the root of a checkout, on a host with one CUDA card:

    python3 chip_smoke.py

Builds the port's CUDA kernels from the checkout's sources, and the
planted-fault copies of phases 2, 8, 14 and 20, all at once (one ``nvcc`` per
source), then prints one JSON line per phase. Serving path:

1. ``device``: the card's name and power limit (nvidia-smi) and the
   kernels' build time and registers.
2. ``kernel_check``: the paged-decode kernel against its plain PyTorch
   version on the card (GQA and MHA at gqa-2048's head shape, ragged
   lengths with empty rows, scrambled page ids, large finite garbage in
   stale positions; a sweep of the supported head_dim/page/group sizes;
   a prefill-style table with a row stride of 0). Then ``decode_plant``:
   copies of the paged-decode source, each with one planted fault (a
   row's last split left out of the merge, the in-page mask off by one,
   the merge adding a split at its own max's scale, a row's last live
   page skipped), run on the same cases: each must fail the check.
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
   beside the bytes bound; then the same at a long context (8 sequences
   at 1024-4096 positions, the full 256-page table).

Training path:

7. ``flash_check``: the flash forward, dQ and dK/dV kernels against their
   plain versions, element by element (gqa-2048's heads and MHA, causal
   and not, t of 128, 200 and 2048; moe-small's heads, 12 / 12 at d 64,
   causal, t 512 and 2048; bert-base's, the same heads non-causal at t
   512; f32 and bf16, a nonzero lse cotangent).
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
12a. ``ckpt_roundtrip``: the trained state of phase 9 (params and AdamW
    moments, 9.5 GB) saved through the async npy pipeline at full size
    with a training step queued right behind the save, then restored into
    a fresh template: every leaf bitwise equal to the state as saved. The
    caller's stall, the staging's device time, the drain and restore
    times, the bytes written and the peak memory with the staging copy
    beside a step. Then a writer process killed where the drain reaches
    its manifest: no step becomes discoverable, and the next manager
    sweeps the orphan.
12b. ``operator_resume``: the north-star job
    (``examples/gqa_2048_northstar_h100.json``: steps 7, a checkpoint
    every 4 kept one deep, a retryable failure at step 6) launched with the
    operator's ``TPUJOB_*`` environment through the real harness
    (``python -m tf_operator_tpu.rendezvous.harness``, a subprocess): the
    first incarnation exits 138, the relaunch (the controller's gang
    restart) logs ``resumed from checkpoint at step 4``, runs the flash
    kernels exactly 2·L / L / L times for each of its 4 steps, ends at step
    8 and exits 0; its ``lm done`` line gives step time, tokens/s and MFU,
    and its final loss is held to the uninterrupted run of the same job:
    phase 9's loss at step 8 (the same workload, seed and batch).
12c. ``elastic_resize``: an elastic job (``workloads/elastic.py``, the
    device-state mode: the reshard model's params and momentum on the
    card) of three members through the harness, the reconciler played by
    a process of its own hosting the operator's store and API server:
    worker 2 SIGKILLed after the first committed checkpoint, the shrink
    directive, the chief's barrier, worker 2 relaunched with
    ``TPUJOB_RESIZE_EPOCH`` and the grow directive. Every member exits 0;
    the eval digest is the uninterrupted order's, the params digest the
    port's ``expected_params`` on the CPU; the chief's plan re-laid,
    re-fetched and inited rows; the re-grown member restored from disk;
    every member's rows lived on the card. ``expected_params`` on the card
    gives the CPU's digest; through a planted fused multiply-add it must
    not.
12b'. The gang phases, each rank the real harness with the operator's
    ``TPUJOB_*`` environment of an N-process gang, two ranks sharing the
    card over gloo (``TPUJOB_DIST_BACKEND=gloo``; NCCL refuses two ranks
    on one device): ``dist_smoke`` (``examples/smoke_h100.json``, dim 256:
    both ranks' checksums exact; beside it one process as an NCCL group
    of one and a ring shift on two ranks, staged through the host: values,
    transpose and bytes exact); ``nccl_world1`` (in this process: gqa-2048
    of phase 9 through the sharded trainer as an NCCL group of one, mesh
    fsdp 1 x tp 1, 1 + 3 steps: losses and gradient norms bitwise equal to
    phase 9's); ``mesh_train``
    (gqa-2048 at full width on two ranks under fsdp 2, cut to 6 layers,
    and, at once, tp 2 at full depth, 1 + 3 steps: losses and gradient
    norms within the mesh limits of one process's at the same depth
    (phase 9's, or the cut's, made while the gangs run), the replicated
    leaves equal on both ranks,
    K1-K3 2·L / L / L a rank and step, K1 at 8 and 2 heads under tp; step
    ms, host seconds in collectives, bytes staged through the host, peak
    GB a rank; beside them a planted fault of each mesh's gradient path at
    2 layers, which must fail those limits against one process at that
    cut, and a sound run of each mesh at the cut, which must pass them,
    the six gangs at once); ``cp_train`` (gqa-2048 cut to 6 layers on two
    ranks under cp 2, each holding 1,024 positions of every row, a gang
    with ring and one with Ulysses attention at once, 1 + 2 steps: the
    same limits against the cut's one process, K1-K3 as the hop schedule says: under ring rank r runs r + 1
    hops a layer at 16 and 4 heads, under Ulysses one whole-sequence
    attention on 8 and 2 heads; bytes staged and sent through all_to_all);
    ``gang_peer_loss`` (beside cp_train: tiny LM on two ranks,
    rank 1 killed: rank 0 exits 138 within the gang's timeout). Two ranks
    on one card are a path check, not a scaling figure.
12c. ``jax_trajectory``: gqa-2048 at full width and depth in f32 (TF32
    off) through K1-K3, from the numpy-seeded init and batch of
    ``artifacts/torch_vs_jax_gqa2048.json`` (b 1, t 2048): 1 + 3 AdamW
    steps, each loss within the artifact's limit of the JAX package's.
    ``jax_trajectory_bert``: the same for bert-base's masked LM (b 1, t
    512, flash non-causal, full remat) from
    ``artifacts/torch_vs_jax_bert_base.json``, with JAX's fixed mask.
12c'. ``remat_policies``: gqa-2048 (b 6, t 2048, flash, bf16) from one
    init and batch under remat none, full, save_mid, dots and
    save_qkv_mid_mlp, 1 + 3 steps each: K1 1 a layer and step under none
    and 2 under the others (K2, K3 1), step 0's loss bitwise equal across
    the policies and the later ones within REMAT_LOSS_ATOL of none's, peak
    memory full < save_mid, dots, save_qkv_mid_mlp < none; step ms and peak
    GB each. Then ``train_parity_dots`` and ``train_parity_save``: phase
    11's checks on ``tiny`` under dots and save_qkv_mid_up.
12c''. ``bert_train``: ``examples/bert_base_h100.json`` (bert-base's
    masked LM, b 32, t 512, flash non-causal at d 64, full remat, bf16,
    AdamW) at full width and depth, 1 + 8 steps through ``run_lm``: K1 24,
    K2 12, K3 12 a step, finite and falling loss, the fixed mask covering
    0.15 ± 0.01 of the batch; step time, tokens/s, MFU, peak memory, and
    2 steps profiled (``bert_train_breakdown``). Then
    ``train_parity_bert``: phase 11's checks at bert-base width.
12d. ``data_memmap``: gqa-2048 at full width and depth through ``run_lm``
    with ``data: memmap`` on a corpus of 2^27 uint16 tokens (256 MB,
    written by ``write_token_corpus`` from seed 0, its last 64 windows held
    out), 1 + 8 steps: the first 3 batches that arrive on the card equal
    ``TokenMemmapDataset``'s own windows byte for byte (sha256), the flash
    kernels run 2·L / L / L times a step, the loss stays finite, and the
    host-to-device copies ran on the loader's stream, not the step's; step
    time, tokens/s, MFU, and device busy and idle share over 2 steps
    profiled on loader batches. Then ``data_stream``: ``data: stream``
    for 1 + 2 steps with the same launch check.
12e. ``eval_live``: the north-star spec on that corpus (10 steps, a
    checkpoint every 4 kept 3 deep), the Evaluator
    (``tf_operator_tpu_torch.workloads.eval:main``) launched through the
    real harness as the operator's Evaluator replica before the trainer
    and before any checkpoint exists, then the trainer through the
    harness: both exit 0, the report holds every saved step (4, 8, 11)
    oldest first with finite CEs, the evaluator launched K1 n_layers x 4
    times a checkpoint and no K2 or K3, and the last step's CE is held to
    a recompute in this process through K1's plain version on the same
    holdout batches within 1e-4 (EVAL_CE_ATOL); restore and score seconds a checkpoint.

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
17a. ``moe_dispatch``: moe-small as phase 15 under the sort, einsum and
    ragged dispatches (capacity factor 2.0), 1 + 4 steps each: the flash
    kernels 2 / 1 / 1 a layer and step and no grouped-matmul launch,
    finite and falling loss, the drop fraction; step time, device busy
    over 2 profiled steps and peak memory beside phase 15's gmm run.
    ``moe_layer_check``: one layer's forward at moe-small's width (8192
    tokens): sort and einsum at capacity factor 0.5 (choices drop) keep
    the same choices and agree within KERNEL_ATOL in f32; ragged against
    gmm (K5, K6) in bf16 within gmm_check's bf16 limit. Then
    ``train_parity_{sort,einsum,ragged}``: phase 11's checks on
    ``tiny-moe`` (top-2, capacity factor 0.5) under each dispatch.
17b. ``ep_train``: moe-small on two ranks sharing the card under ep 2
    (4 experts and half of the tokens a rank; the gmm and sort gangs at
    once, four ranks on the card), gmm for 1 + 3 steps: losses
    and gradient norms within the mesh limits of phase 15's first four,
    the replicated leaves equal on both ranks, each rank's K1-K3 and
    K5/K6/K7a/K7b launches a step equal to one process's; the occupied
    share of a rank's received blocks and its all_to_all bytes. Then sort
    at capacity factor 0.5 (choices drop) for 1 + 2 steps: each rank's
    layer-0 output of the first step against a plain f32 recompute of its
    per-shard queues (EP_LAYER_*), the same drop fraction, above 0, no
    grouped-matmul launch.
    ``gang_resume``: checkpoints of a gang, two gangs at once through the
    harness with the controller's warm-restart environment. ep_resume:
    ep_train's gmm job saving every 2 steps, rank 1 exiting 138 at step 3
    after the step-2 save committed, rank 0 on the lost peer; the
    relaunch resumes both ranks from step 2 and its losses and gradient
    norms at steps 3 and 4 must be ep_train's (bitwise expected, the mesh
    limits held). tp_recut: gqa-2048 under tp 2 for 1 + 2 steps, each
    rank logging each written block's sha256; this process restores step
    2 at world 1 (a re-cut): the blocks cut from it must have the ranks'
    digests and its step 3 the gang's loss (MESH_FIRST_LOSS_ATOL) and
    gradient norm; the same restore with the two ranks' block files
    swapped must fail both. Each rank's save stall, blocks, bytes, drain
    and commit seconds, restore seconds and peak GB are logged.
    ``gang_plants`` (after ``pp_train``), ``ep_cp_plants`` line: at 2
    layers against one process's run of the same cut, the gmm receiver's
    block map built from its own counts (ep 2) and the ring's causal skip
    inverted (cp 2): each must fail the mesh limits, and the same two
    runs without the fault must pass them.
17c. ``pp_train``: the pipeline on four ranks a gang, two gangs at once
    (eight ranks on the card): gqa-2048 of phase 9 over pp 2 x tp 2 and
    moe-small (gmm) over pp 2 x ep 2, both 1F1B, 1 + 3 steps; the dense
    gang held to phase 9 by the mesh limits, the MoE gang's CE terms to
    one process whose load-balance loss is the pipeline's (per
    microbatch), its first router terms to that process's; K1-K3 and
    K5/K6/K7a/K7b a rank and step as the schedule says (one forward more
    a layer and microbatch than one process). Then ``gang_plants``,
    ``pp_plants`` line (its gangs at once with ``ep_cp_plants``'), at 2
    layers of the MoE gang (pp 2 x ep 2): the 1F1B backward recomputing
    from the unmirrored microbatch's saved input and the expert gradients
    summed over ep: each must fail the limits beside a sound run of that
    cut, which must pass them. Each
    rank's step ms, bubble fraction, host seconds in collectives, bytes
    staged and sent through all_to_all, and peak GB.
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
    from the bf16-rounded y, the prologue's ReLU dropped, x's K-major
    wgmma descriptors stepped wrong): the check of phase 19 must fail on
    each by 10x its limit or more.
21. ``resnet_train``: ResNet-50 at full width and depth (b 128, 224^2,
    bf16, ``fused_1x1``, SGD momentum 0.9, lr 0.1, "var" statistics
    gradient, fixed data), one warmup and 8 timed steps through
    ``run_resnet``: exactly 36 K8 launches a step, finite loss, lower
    after the first update; step time, images/s, MFU and peak memory.
    Then the same with ``fused_1x1`` off (cuDNN 1x1 convolutions, the
    plain BN path), and ``resnet_agreement``: the fused run's losses over
    the first 4 steps within 1% of the unfused run's. ``resnet_dp``: the
    fused job on two ranks sharing the card under dp 2 (64 images a rank,
    synced batch norm, K8's column sums summed over the ranks), 1 + 3
    steps: the losses within 1% of the fused run's, the BN running
    statistics bitwise equal across the ranks, K8 36 a step a rank.
    ``resnet_forward_check`` (after phase 22's fused breakdown): the first
    step's forward through K8 against the same through its plain version,
    the loss and every batch norm's new running statistics.
22. ``resnet_breakdown``: as phase 10, with K8, cuDNN convolutions, the
    elementwise work and the SGD update as families of their own; then the
    same for the unfused run (its device time, which the host clock of a
    shared host does not give).
22a. ``resnet_real``: the real-image path (``train_real``) at ResNet-50
    width and depth with the workload of
    ``examples/resnet_real_idx_h100.json`` (224^2, b 256, crop padding 16,
    no flip, 10 classes, lr 0.1, augmented) on a seeded idx fixture of
    2,048 train and 512 test 28x28 images upsampled x8, 1 epoch (8 steps),
    ``fused_1x1`` through cfg: K8 exactly 36 times a step, the native
    augmenter served every batch the loader staged, finite losses, the
    test accuracy in [0, 1] and identical when rescored with eval_b 64 and
    100; images/s, idle share over 2 steps profiled on loader batches, and
    the stager's host ms a batch beside the step's.
22b. ``mnist_train``: ``workloads/mnist.py`` in process: 30 synthetic
    steps at hidden 128 and batch 256, the first 3 losses within 1e-4 of
    the port's CPU run, the loss falling; then the idx path on a seeded
    idx fixture (accuracy logged, not gated).
23. ``resnet_parity``: ResNet-50 widths at one block a stage, 64^2, b 8:
    f32 loss, BN state and grads on the card against the CPU with
    ``fused_1x1`` on and off, and 3 bf16 steps with K8 against 3 with its
    plain version.
24. ``fls_timing``: K8 at each distinct shape of phase 21 beside its
    bound, its plain version, ``torch.mm`` alone (the product without the
    statistics) and ``torch.mm`` plus the two column reductions (the
    unfused sequence); then each K8 instantiation's wgmma and TMA
    instructions (which must be there), mma.sync (which must not),
    registers and spills (which must be none) and nvcc's wgmma
    serialisation advisories (which must be none).

Then a ``wall`` line (seconds per phase), the ``kernels`` line, the
nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises: the script
then exits non-zero and prints no result. Without a CUDA device it exits
1 at once.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from tf_operator_tpu_torch.compat import tree_map
from tf_operator_tpu_torch.device import resolve_device
from tf_operator_tpu_torch.models.resnet import ResNetConfig, init_resnet
from tf_operator_tpu_torch.models.transformer import (
    _swiglu_experts,
    init_transformer,
    init_transformer_numpy,
    lm_loss,
    lm_loss_and_metrics,
    mlm_mask,
    preset_from_workload,
)
from tf_operator_tpu_torch.ops import _build
from tf_operator_tpu_torch.ops import flash_attention as fa
from tf_operator_tpu_torch.ops import fused_linear_stats as fls
from tf_operator_tpu_torch.ops import grouped_matmul as gm
from tf_operator_tpu_torch.parallel import collectives as coll
from tf_operator_tpu_torch.parallel import moe as moe_mod
from tf_operator_tpu_torch.parallel.mesh import build_mesh as build_rank_mesh
from tf_operator_tpu_torch.parallel.moe import block_layout
from tf_operator_tpu_torch.parallel.sharding import block_counts, block_slices
from tf_operator_tpu_torch.rendezvous.context import DIST_TIMEOUT_S
from tf_operator_tpu_torch.serve.engine import (
    ServeConfig,
    ServeEngine,
    decode_step,
    prefill_chunk,
)
from tf_operator_tpu_torch.serve.kvcache import PagePool, SequencePages, pages_needed
from tf_operator_tpu_torch.train import checkpoint as ckpt_mod
from tf_operator_tpu_torch.train import data as data_mod
from tf_operator_tpu_torch.train import reshard, trajectory
from tf_operator_tpu_torch.train.trainer import Trainer, TrainerConfig
from tf_operator_tpu_torch.workloads import elastic as elastic_mod
from tf_operator_tpu_torch.workloads import mnist as mnist_mod
from tf_operator_tpu_torch.workloads.lm import fixed_tokens, lm_trainer, router_metrics, run_lm
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
REPO = Path(__file__).resolve().parent
# The checkpoint phases write under the checkout, in a directory that
# .gitignore lists, and each removes what it wrote.
CKPT_ROOT = REPO / "build" / "ckpt_smoke"
# operator_resume: the north-star job's H100 spec, its workload cut to 7
# steps with a checkpoint every 4 kept one deep, and a retryable failure at
# step 6: the relaunch resumes from step 4 and ends at step 8 (7 steps
# and the warmup; the final save is the periodic one, one 9.5 GB drain).
# The uninterrupted run it is held to is the train phase's (TRAIN_WL is
# the spec's workload; its loss at step 8), where it was a third process
# of its own, 10 steps long, until the elastic and MNIST phases joined the
# script.
NORTHSTAR_SPEC = REPO / "examples" / "gqa_2048_northstar_h100.json"
RESUME_OVERRIDES = {"steps": 7, "checkpoint_every": 4, "checkpoint_keep": 1,
                    "fail_at_step": 6}
RESUME_FROM, RESUME_LAST = 4, 8
# The resumed run's final loss against the uninterrupted run of the same
# job. The relaunch restores step 4's state bit for bit (ckpt_roundtrip
# checks that at full size) and trains the same fixed batch through the
# same kernels, so where every kernel of a step is deterministic the two
# final losses are equal. What can part them is a sum whose order depends
# on scheduling (a library kernel's atomics), a few bf16 ulps of a step's
# grads: less than two sum orders through every op of a first bf16 step,
# which the kernels-vs-plain check holds to PARITY_BF16_FIRST_STEP_ATOL
# (2e-3). That is the limit; the line says whether the losses were equal.
OPERATOR_RESUME_LOSS_ATOL = 2e-3
# data_memmap: the corpus (2^27 uint16 tokens, 256 MB, from DATA_SEED) with
# its last HOLDOUT_WINDOWS windows held out; the first DATA_CHECKED batches
# on the card are held to the dataset's own.
CORPUS_TOKENS = 1 << 27
HOLDOUT_WINDOWS = 64
DATA_CHECKED = 3
DATA_SEED = 0
# eval_live: the north-star spec on that corpus, 10 steps, a checkpoint
# every 4 kept 3 deep (steps 4, 8 and the final 11, all kept), and the
# evaluator's keys (4 batches of 8 x 2048 holdout tokens a checkpoint).
EVAL_LIVE_OVERRIDES = {"data": "memmap", "steps": 10, "checkpoint_every": 4,
                       "checkpoint_keep": 3, "train_steps": 10, "eval_batch_size": 8,
                       "eval_seq_len": 2048, "eval_batches": 4, "poll_interval_s": 0.5,
                       "max_wait_s": 600}
EVAL_LIVE_STEPS = (4, 8, 11)
# The evaluator's CE (bf16, K1) against the same checkpoint and batches
# through K1's plain version: K1's rounding of P against the plain
# version's. On an H100 80GB HBM3 (700 W) the two differ by 6.7e-6 on the
# last checkpoint's CE of ~10.61; the limit is 15x that, and 1/480 of the
# 4.8e-2 the CE moves between the last two saved checkpoints (steps 8 and
# 11), so scoring the wrong checkpoint fails it.
EVAL_CE_ATOL = 1e-4
# resnet_real: examples/resnet_real_idx_h100.json's workload on a seeded
# idx fixture at MNIST's geometry, cut to REAL_TRAIN / REAL_TEST images
# (of 60,000 / 10,000: at 224^2 prepare_classification_images would hold
# 36 GB of f32 on the host) and one epoch; random labels, so no accuracy
# target.
REAL_SPEC = REPO / "examples" / "resnet_real_idx_h100.json"
REAL_TRAIN, REAL_TEST = 2048, 512
RESNET_REAL_OVERRIDES = {"epochs": 1, "target_accuracy": 0.0}
# The BERT-base masked-LM job (examples/bert_base_h100.json: b 32, t 512,
# flash non-causal at d 64, the preset's full remat) at full width and
# depth, 1 warmup + 8 timed steps, random weights (seed 0); the loss's
# fixed mask must mask MLM_MASK_RATE of the batch within MLM_SHARE_ATOL.
BERT_SPEC = REPO / "examples" / "bert_base_h100.json"
BERT_OVERRIDES = {"steps": 8, "remat": "full", "lr": 3e-4, "data": "fixed"}
MLM_MASK_RATE, MLM_SHARE_ATOL = 0.15, 0.01
# remat_policies: gqa-2048 (b 6, t 2048, flash, bf16) from one init and
# batch under each policy, 1 + 3 steps. The policies change what the
# backward stores and recomputes, never a forward value: step 0's loss is
# bitwise equal across them. Later steps part by rounding alone: a
# region boundary changes the order in which the backward adds the same
# bf16 activation grads (a few bf16 ulps of some grads), less than the
# kernels against their plain versions, which also round P and dS
# elsewhere and whose 3 bf16 steps train_parity holds to
# PARITY_BF16_LOSS_ATOL (2e-2, 0.2% of the loss); the same limit here.
REMAT_POLICIES = ("none", "full", "save_mid", "dots", "save_qkv_mid_mlp")
REMAT_STEPS = 4
REMAT_LOSS_ATOL = 2e-2
# moe_dispatch: moe-small (examples/moe_small_h100.json) under the capacity
# dispatches at its capacity factor (2.0) and under ragged, 1 + 4 steps
# each; the one-layer check at full width runs sort and einsum at
# MOE_CHECK_CF, where choices drop.
MOE_DISPATCHES = ("sort", "einsum", "ragged")
MOE_DISPATCH_STEPS = 4
MOE_CHECK_CF = 0.5
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
# resnet_train's fused run against its unfused yardstick (cuDNN 1x1
# convolutions and the plain BN path, no K8; same weights, same batch): the
# losses of the first RESNET_AGREE_STEPS steps (the initial loss and three
# updates) agree within RESNET_AGREE_RTOL of the yardstick's. Later steps
# part on rounding alone (phase_resnet_train's docstring). On an H100 every
# recorded run of the fused path (K8 designs and K8's plain version) was
# within 0.43% of the unfused path there (tools/fls_decode_variants.py
# --resnet, PERF.md).
RESNET_AGREE_STEPS = 4
RESNET_AGREE_RTOL = 1e-2
# resnet_forward_check: resnet_train's first forward (train mode, the
# initial params, the run's batch) through K8 against the same through
# K8's plain version, on the same card tensors. The loss is held to
# PARITY_BF16_FIRST_STEP_ATOL (resnet_parity's limit for K8 against its
# plain version at the first bf16 step); every batch norm's new running
# statistics (0.9 of the initial ones plus 0.1 of the batch's) to
# RESNET_FWD_STATE_RTOL of the leaf's largest magnitude. Both paths round
# y to bf16 and differ only in the order of the f32 sums, which moves a
# bf16 y by an ulp here and there, and that spreads through 53 batch
# norms. On an H100 (tools/fls_decode_variants.py --resnet, PERF.md) K8
# measured 5.0e-4 on the loss and 5.1e-3 on the statistics; K8 with x's
# depth steps wrong 5.7e-3 and 0.14, and with the last row tile left out
# of the statistics 1.5e-2 and 0.07.
RESNET_FWD_STATE_RTOL = 1e-2
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


_EMIT_LOCK = threading.Lock()


def emit(obj) -> None:
    line = json.dumps(obj) + "\n"
    with _EMIT_LOCK:  # whole lines, when a phase runs beside another
        sys.stdout.write(line)
        sys.stdout.flush()


def beside(fn, *args):
    """Start ``fn(*args)`` on a thread; returns the join, which re-raises
    what the thread raised."""
    failed = []

    def run():
        try:
            fn(*args)
        except BaseException as exc:  # noqa: BLE001 - re-raised by the join
            failed.append(exc)

    thread = threading.Thread(target=run)
    thread.start()

    def join():
        thread.join()
        if failed:
            raise failed[0]

    return join


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
    """Kernel vs plain version on the same card tensors: max abs error
    (inf where the kernel's output is not finite), and whether every
    seq_len == 0 row is exactly zero."""
    got = fa.paged_decode_kernel(q, k, v, table, lens)
    want = fa.paged_decode_reference(q, k, v, table, lens)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        return float("inf"), False
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


def kernel_check_cases(rng, dev):
    """(name, paged-decode inputs) of kernel_check: GQA and MHA at
    gqa-2048's head shape over ragged lengths (several splits a walk), the
    supported head_dim/page/group sizes, and a prefill-style table with a
    row stride of 0."""
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
    return cases


def phase_kernel_check(dev):
    cases = kernel_check_cases(np.random.RandomState(0), dev)
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


# Faults planted in copies of the paged-decode source (phase decode_plant;
# the format of FLASH_PLANTS below). Each must fail kernel_check's
# comparison at KERNEL_ATOL.
DECODE_PLANTS = {
    # the merge leaves out each row's last live split
    "merge_drops_split": ("decode", "paged_decode.cu", "for (int sp = 0; sp < live; ++sp) {",
                          "for (int sp = 0; sp < live - 1; ++sp) {"),
    # the in-page mask lets the stale position at seq_len in
    "mask_off_by_one": ("decode", "paged_decode.cu", "const bool lv = pos0 + t < len;",
                        "const bool lv = pos0 + t <= len;"),
    # the merge adds each split's output at its own max's scale, not the
    # row's
    "merge_wrong_max": ("decode", "paged_decode.cu", "o += po[(size_t)sp * d] * c;",
                        "o += po[(size_t)sp * d];"),
    # each row's last live page is never read
    "last_page_skipped": ("decode", "paged_decode.cu", "const int n = min(run, n_live - p0);",
                          "const int n = min(run, n_live - 1 - p0);"),
}


@contextlib.contextmanager
def decode_planted(lib):
    """Route the paged-decode wrapper to the planted library."""
    real = fa._kernel_fn()  # bind the real one first, so it can be put back
    fa._fn = fa.bind_decode_entry(lib)
    try:
        yield
    finally:
        fa._fn = real


def phase_decode_plant(dev):
    """Each planted fault (DECODE_PLANTS) on kernel_check's cases: some case
    must come out more than KERNEL_ATOL off the plain version, not finite,
    or with a seq_len == 0 row not exactly zero. Launches here are not the
    main path's."""
    libs = build_plants(tuple(DECODE_PLANTS), DECODE_PLANTS)
    cases = kernel_check_cases(np.random.RandomState(7), dev)
    out = {}
    for name, lib in libs.items():
        with decode_planted(lib):
            errs = [compare_kernel(*args) for _, args in cases]
        worst = max(e for e, _ in errs)
        zeros = all(z for _, z in errs)
        check(worst > KERNEL_ATOL or not zeros,
              f"planted fault {name} passed kernel_check: max abs err {worst}")
        out[name] = {"max_abs_err": worst if np.isfinite(worst) else "not finite",
                     "zero_rows_exact": zeros}
    emit({"phase": "decode_plant", "caught": len(out), "cases": len(cases),
          "atol": KERNEL_ATOL, "plants": out})


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


def decode_timing(q, kp, vp, table_d, lens_d, ps):
    """The paged-decode kernel, its plain version and SDPA at one decode
    shape, in turns on one card (kernel, plain, library, kernel). Call i
    reads layer i % L of the pools kp, vp [L, n_pages, page, h_kv, d], as
    consecutive layers do. Beside them the bound: the live K/V bytes read
    once, q in, o out, the live table entries and lengths, at 3.35 TB/s,
    against q.k and p.v at the f32 peak."""
    dev = q.device
    L, s, (h, d), h_kv = kp.shape[0], q.shape[0], q.shape[1:], kp.shape[3]
    got = fa.paged_decode_kernel(q, kp[0], vp[0], table_d, lens_d)
    want = fa.paged_decode_reference(q, kp[0], vp[0], table_d, lens_d)
    err = float((got - want).abs().max())
    check(err <= KERNEL_ATOL, f"kernel vs plain at decode shape: {err}")

    # library yardstick: SDPA over K/V already gathered into contiguous
    # [s, h_kv, T, d] per layer (excludes the page gather), lengths masked
    lens = lens_d.tolist()
    T = max(lens)
    kc = torch.stack([kp[i][table_d.long()].reshape(s, -1, h_kv, d)[:, :T] for i in range(L)])
    vc = torch.stack([vp[i][table_d.long()].reshape(s, -1, h_kv, d)[:, :T] for i in range(L)])
    kc = kc.permute(0, 1, 3, 2, 4).contiguous()  # [L, s, h_kv, T, d]
    vc = vc.permute(0, 1, 3, 2, 4).contiguous()
    mask = (torch.arange(T, device=dev)[None, :] < lens_d[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]  # [s, h, 1, d]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def lib(i):
        return sdpa(q4, kc[i % L], vc[i % L], attn_mask=mask, enable_gqa=True)

    lib_err = float((lib(0)[:, :, 0] - want).abs().max())
    check(lib_err <= 1e-4, f"SDPA yardstick disagrees with the plain version: {lib_err}")
    del got, want

    kernel = lambda i: fa.paged_decode_kernel(q, kp[i % L], vp[i % L], table_d, lens_d)  # noqa: E731
    plain = lambda i: fa.paged_decode_reference(q, kp[i % L], vp[i % L], table_d, lens_d)  # noqa: E731
    runs = {"kernel": [], "plain": [], "library": []}
    for name, fn, iters in (("kernel", kernel, 300), ("plain", plain, 50),
                            ("library", lib, 300), ("kernel", kernel, 300)):
        runs[name].append((device_ms(fn, iters), call_ms(fn, iters)))
    dev_ok = all(x is not None for rs in runs.values() for x, _ in rs)
    # "ms" is device time where the profiler saw the card, else per-call time
    pick = (lambda rs: min(x for x, _ in rs)) if dev_ok else (lambda rs: min(c for _, c in rs))

    live_tokens = sum(lens)
    live_pages = sum(pages_needed(n, ps) for n in lens)
    bytes_moved = (2 * live_tokens * h_kv * d * 4   # live K and V, read once
                   + 2 * s * h * d * 4              # q in, o out
                   + live_pages * 4 + s * 4)        # live table entries, lengths
    ops = 4 * live_tokens * h * d                   # q.k and p.v, 2 ops per multiply-add
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return {
        "shape": {"s": s, "h": h, "h_kv": h_kv, "d": d, "page": ps,
                  "table_width": table_d.shape[1], "seq_lens": lens, "layers": L,
                  "splits": fa.decode_splits(s, h_kv, table_d.shape[1],
                                            fa.decode_target_blocks(dev))},
        "ms": pick(runs["kernel"]), "plain_ms": pick(runs["plain"]),
        "library_ms": pick(runs["library"]), "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "max_abs_err": err, "bytes": bytes_moved, "ops": ops, "bytes_ms": bytes_ms,
        "ops_ms": ops_ms, "library_max_abs_err": lib_err,
        "ms_source": "device time (torch.profiler)" if dev_ok else "CUDA events per call",
        "device_ms_runs": {k: [x for x, _ in v] for k, v in runs.items()},
        "call_ms_runs": {k: [c for _, c in v] for k, v in runs.items()},
    }


def decode_shapes(cfg, dev, long_pool_pages=2100):
    """name -> (q, kp, vp, table, lens) of the paged-decode kernel at two
    decode shapes of ``cfg`` (f32, SERVE_WL's page, the engine's
    full-width table of pages_needed(max_seq) pages):

    - "serve": one decode step's attention call, max_slots sequences
      mid-way through phase 3's requests (prompt + half the generation
      budget), pages from the engine's allocator, every layer's pools
      [L, n_pages, page, h_kv, d] (decode_timing reads another layer each
      call, so the live K/V, several MB a layer, is not served from L2);
    - "long_context": 8 sequences at ragged lengths from 1024 to max_seq
      (the table's last page), scrambled page ids over one layer's pools
      of ``long_pool_pages`` pages (~69 MB a side at gqa-2048, past the 50
      MB L2)."""
    ps, s = SERVE_WL["kv_page_size"], SERVE_WL["max_slots"]
    h, h_kv, d, L = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    width = pages_needed(cfg.max_seq, ps)
    reqs = synthesize_requests(SERVE_WL, cfg.vocab)[:s]
    lens = [len(r.prompt) + r.max_new // 2 for r in reqs]
    pool = PagePool(SERVE_WL["kv_pool_pages"])
    table = np.full((s, width), pool.trash_page - 1, np.int32)
    for i, r in enumerate(reqs):
        sp = SequencePages(ps)
        sp.ensure(len(r.prompt) + r.max_new, pool)
        table[i, : len(sp.pages)] = sp.pages
    g = torch.Generator(dev).manual_seed(0)
    to = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)  # noqa: E731
    shape = (L, pool.num_pages + 1, ps, h_kv, d)
    out = {"serve": (torch.randn(s, h, d, device=dev, generator=g),
                     torch.randn(shape, device=dev, generator=g),
                     torch.randn(shape, device=dev, generator=g), to(table), to(lens))}
    rng = np.random.RandomState(3)
    long_lens = [int(n) for n in rng.permutation(np.linspace(1024, cfg.max_seq, 8).astype(int))]
    ids = rng.permutation(long_pool_pages)
    table = np.full((len(long_lens), width), long_pool_pages - 1, np.int32)
    nxt = 0
    for i, n in enumerate(pages_needed(n, ps) for n in long_lens):
        table[i, :n] = ids[nxt: nxt + n]
        nxt += n
    shape = (1, long_pool_pages, ps, h_kv, d)
    out["long_context"] = (torch.randn(len(long_lens), h, d, device=dev, generator=g),
                           torch.randn(shape, device=dev, generator=g),
                           torch.randn(shape, device=dev, generator=g), to(table), to(long_lens))
    return out


def phase_kernel_timing(cfg):
    """The paged-decode kernel at decode_shapes' two shapes of gqa-2048
    beside its plain version, SDPA and the bound (decode_timing)."""
    ps = SERVE_WL["kv_page_size"]
    shapes = decode_shapes(cfg, torch.device("cuda"))
    timing = decode_timing(*shapes.pop("serve"), ps)
    long = decode_timing(*shapes.pop("long_context"), ps)
    emit({"phase": "kernel_timing",
          "library": "scaled_dot_product_attention on contiguous K/V, page gather excluded",
          **timing, "long_context": long})
    timing["long_context"] = long
    return timing


# ---------------------------------------------------------------------------
# training: the flash kernels against their plain versions
# ---------------------------------------------------------------------------


# (h, h_kv, d, ts, causal modes) of flash_check: gqa-2048's heads and MHA
# on and off the tile grid, moe-small's (d 64) at its t and at 2048, and
# bert-base's (the same heads, non-causal) at its t
FLASH_CHECK_CASES = (
    (16, 4, 128, (128, 200, 2048), (True, False)),
    (16, 16, 128, (128, 200, 2048), (True, False)),
    (12, 12, 64, (512, 2048), (True,)),
    (12, 12, 64, (512,), (False,)),  # bert-base's masked LM
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
    for plants in (DECODE_PLANTS, FLASH_PLANTS, GMM_PLANTS, FLS_PLANTS):
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


def phase_train_breakdown(run, smi, iters=2, phase="train_breakdown", batch=None, pull=None):
    """Training steps of a train phase's run (on ``batch``, default the
    run's tokens, or on a batch from ``pull()`` each step: a loader's) on
    the host clock and under torch.profiler: device busy time per step,
    idle share, top kernels, the three flash kernels' share, the
    grouped-matmul kernels' (forward and dw) and K8's."""
    holder = {"state": run.state}
    if batch is None and pull is None:
        batch = run.tokens

    def step():
        holder["state"], m = run.trainer.step(holder["state"],
                                              batch if pull is None else pull())
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
    # host-to-device copies (a loader's, on its own stream) overlap the
    # step's kernels: the compute streams' idle share leaves them out
    htod_ms = sum(t for k, _, t in rows if "htod" in k.lower()) / iters
    out = {
        "phase": phase, "steps": iters, "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
        "htod_copy_ms_per_step": htod_ms,
        "device_idle_share_without_htod": (1.0 - (busy_ms - htod_ms) / wall_ms
                                           if busy_ms else None),
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
    }
    emit(out)
    return out


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


# train_parity on the paths this slice added: the masked LM at bert-base
# width, and on tiny configs a remat mode without a names split (dots), a
# save: set, and the three MoE dispatches (top-2 at capacity factor 0.5,
# where choices drop; the MoE bf16 limit, as moe_parity's).
TINY_PARITY_WL = {"preset": "tiny", "attn": "flash", "lr": 3e-4, "data": "fixed"}
TINY_MOE_PARITY_WL = {**TINY_PARITY_WL, "preset": "tiny-moe", "remat": "full",
                      "moe_top_k": 2, "capacity_factor": MOE_CHECK_CF}
REMAT_PARITY = (("train_parity_dots", {**TINY_PARITY_WL, "remat": "dots"}),
                ("train_parity_save", {**TINY_PARITY_WL, "remat": "save_qkv_mid_up"}))
DISPATCH_PARITY = tuple((f"train_parity_{impl}", {**TINY_MOE_PARITY_WL, "moe_dispatch": impl})
                        for impl in MOE_DISPATCHES)


def bert_wl() -> dict:
    """examples/bert_base_h100.json's workload with BERT_OVERRIDES."""
    return {**json.loads(BERT_SPEC.read_text())["spec"]["workload"], **BERT_OVERRIDES}


def phase_bert_train(smi, dev="cuda"):
    """bert-base's masked LM at full width and depth through run_lm (the
    train phase's checks: K1 2·L, K2 and K3 L a step under full remat,
    finite and falling loss), the fixed mask's share of the batch within
    MLM_SHARE_ATOL of MLM_MASK_RATE, then 2 steps profiled."""
    wl = bert_wl()
    check(not preset_from_workload(wl).causal, "bert_train: the spec is not bidirectional")
    share = float(mlm_mask((wl["batch_size"], wl["seq_len"]), MLM_MASK_RATE,
                           torch.device(dev)).float().mean())
    check(abs(share - MLM_MASK_RATE) <= MLM_SHARE_ATOL,
          f"bert_train: the fixed mask covers {share} of the batch")
    run, counts = phase_train(smi, wl, dev, phase="bert_train")
    emit({"phase": "bert_mask", "masked_share": share, "mask_rate": MLM_MASK_RATE,
          "share_atol": MLM_SHARE_ATOL, "masked_positions": round(
              share * wl["batch_size"] * wl["seq_len"])})
    phase_train_breakdown(run, smi, phase="bert_train_breakdown")
    return counts


def phase_remat_policies(smi, dev="cuda"):
    """gqa-2048 (TRAIN_WL's shape) from one init and batch under each of
    REMAT_POLICIES, 1 + 3 steps through the Trainer: step ms (the 3 after
    the first, host clock with a sync), peak GB, K1-K3 launches a step,
    and the device busy time of one more step under torch.profiler.
    Checks: K1 L a step under none and 2·L under the others, K2 and K3 L;
    step 0's loss bitwise equal across the policies and the later ones
    within REMAT_LOSS_ATOL of none's; peak memory full < every other
    policy but none < none."""
    cfg0 = preset_from_workload(TRAIN_WL)
    params = init_transformer(cfg0, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = fixed_tokens(TRAIN_WL["batch_size"], TRAIN_WL["seq_len"], cfg0.vocab, dev)
    L = cfg0.n_layers
    out = {}
    for remat in REMAT_POLICIES:
        cfg = replace(cfg0, remat=remat)
        trainer = Trainer(loss_fn=lambda p, b, e, cfg=cfg: lm_loss(p, b, cfg), init_fn=None,
                          config=TrainerConfig(learning_rate=TRAIN_WL["lr"]), device=dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = trainer.state_from_params(tree_map(lambda x: x.clone(), params))
        reset_counts()
        losses, step_s = [], []
        for _ in range(REMAT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = trainer.step(state, tokens)
            losses.append(float(m["loss"]))
            step_s.append(time.perf_counter() - t0)
        counts = read_counts()
        holder = {"state": state}

        def one_step():
            holder["state"] = trainer.step(holder["state"], tokens)[0]

        busy_ms = sum(r[2] for r in profile_kernels(one_step))
        state = holder.pop("state")
        fwd_per_layer = 1 if remat == "none" else 2
        want = {name: 0 for name in COUNTERS}
        want.update(flash_fwd_launches=fwd_per_layer * L * REMAT_STEPS,
                    flash_bwd_dq_launches=L * REMAT_STEPS, flash_bwd_dkv_launches=L * REMAT_STEPS)
        check(counts == want, f"remat_policies {remat}: launches {counts} != {want}")
        step_ms = statistics.mean(step_s[1:]) * 1e3
        out[remat] = {"losses": losses, "step_ms": step_ms,
                      "tokens_per_s": TRAIN_WL["batch_size"] * TRAIN_WL["seq_len"] / step_ms * 1e3,
                      "device_busy_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / step_ms,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "k1_per_layer_step": counts["flash_fwd_launches"] / L / REMAT_STEPS,
                      "launches": counts}
        del state, trainer
    base = out["none"]["losses"]
    for remat, r in out.items():
        check(r["losses"][0] == base[0], f"remat_policies: step 0 loss under {remat} "
                                         f"{r['losses'][0]!r} != none's {base[0]!r}")
        r["max_abs_diff_vs_none"] = max(abs(a - b) for a, b in zip(r["losses"], base))
        check(all(np.isfinite(r["losses"])) and r["max_abs_diff_vs_none"] <= REMAT_LOSS_ATOL,
              f"remat_policies: {remat} losses {r['losses']} vs none {base}")
    peak = {k: r["peak_mem_gb"] for k, r in out.items()}
    middle = [k for k in REMAT_POLICIES if k not in ("none", "full")]
    check(all(peak["full"] < peak[k] < peak["none"] for k in middle),
          f"remat_policies: peak GB not ordered full < {middle} < none: {peak}")
    emit({"phase": "remat_policies", "preset": TRAIN_WL["preset"],
          "batch": TRAIN_WL["batch_size"], "seq": TRAIN_WL["seq_len"], "attn": "flash",
          "dtype": str(cfg0.dtype), "steps": REMAT_STEPS, "loss_atol": REMAT_LOSS_ATOL,
          "policies": out, "card": smi})
    return out


def moe_layer_case(dev, tokens=8192, d=768, f=3072, n_experts=8, dtype=torch.float32):
    """One MoE layer's inputs at moe-small's width: x [T, d], router logits
    [T, E] from a random router, SwiGLU experts at init scale."""
    gen = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    x = randn(tokens, d)
    logits = (x.float() @ randn(d, n_experts, scale=d ** -0.5).float()).to(dtype)
    experts = {"w_gate": randn(n_experts, d, f, scale=d ** -0.5),
               "w_up": randn(n_experts, d, f, scale=d ** -0.5),
               "w_down": randn(n_experts, f, d, scale=f ** -0.5)}
    return x, logits, experts


def phase_moe_layer_check(dev="cuda"):
    """One MoE layer's forward at moe-small's width (8192 tokens, top-1):
    sort and einsum at capacity factor MOE_CHECK_CF in f32 (TF32 off) keep
    the same choices and give outputs within KERNEL_ATOL (the same
    products on the same inboxes; only zeros are summed in other orders);
    ragged (cuBLAS a product per expert) against gmm (K5, K6) in bf16
    within gmm_check's bf16 limit (each rounds to bf16 at other points)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x, logits, experts = moe_layer_case(dev)
    cap = moe_mod.expert_capacity(MOE_CHECK_CF, 1, x.shape[0], logits.shape[1])
    slot = moe_mod._route_sparse(x, logits, cap)[0]
    dispatch = moe_mod._route(x, logits, cap)[0] != 0
    e, c = slot[:, 0] // cap, slot[:, 0] % cap
    kept = slot[:, 0] < logits.shape[1] * cap
    from_slot = torch.zeros_like(dispatch)
    from_slot[kept.nonzero()[:, 0], e[kept], c[kept]] = True
    check(torch.equal(from_slot, dispatch), "moe_layer_check: sort and einsum keep other choices")
    outs = {impl: moe_mod.moe_apply(x, logits, experts, _swiglu_experts,
                                    capacity_factor=MOE_CHECK_CF, dropped="zero",
                                    dispatch_impl=impl, return_stats=True)
            for impl in ("sort", "einsum")}
    se_err = float((outs["sort"][0] - outs["einsum"][0]).abs().max())
    drop = float(outs["sort"][1]["drop_frac"])
    check(drop > 0 and drop == float(outs["einsum"][1]["drop_frac"]),
          f"moe_layer_check: drop fractions {drop} vs {float(outs['einsum'][1]['drop_frac'])}")
    check(se_err <= KERNEL_ATOL, f"moe_layer_check: sort vs einsum max abs err {se_err}")
    del outs, dispatch, from_slot
    x16, logits16 = x.to(torch.bfloat16), logits.to(torch.bfloat16)
    want = moe_mod.moe_apply(x16, logits16, experts, dispatch_impl="gmm").float()
    got = moe_mod.moe_apply(x16, logits16, experts, dispatch_impl="ragged",
                            ragged_expert_fn=moe_mod.ragged_swiglu).float()
    diff = (got - want).abs()
    limit = gmm_limit(want, torch.bfloat16, (-1,))
    check(bool((diff <= limit).all()), f"moe_layer_check: ragged vs gmm max abs err "
                                       f"{float(diff.max())}")
    out = {"phase": "moe_layer_check", "tokens": x.shape[0], "d": x.shape[1],
           "experts": logits.shape[1], "capacity_factor": MOE_CHECK_CF, "capacity": cap,
           "drop_frac": drop, "sort_vs_einsum_max_abs_err": se_err,
           "sort_vs_einsum_atol": KERNEL_ATOL, "ragged_vs_gmm_max_abs_err": float(diff.max()),
           "ragged_vs_gmm_worst_err_over_limit": float((diff / limit).max())}
    emit(out)
    return out


def phase_moe_dispatch(smi, yardstick, dev="cuda"):
    """moe-small at full width and depth (b 16, t 512, full remat) through
    run_lm under each of MOE_DISPATCHES, 1 + 4 steps: the train phase's
    checks (K1 2·L, K2 and K3 L a step, no grouped-matmul launch, finite
    and falling loss) and the router line (drop_frac), then 2 steps
    profiled; ``yardstick`` is moe_train's gmm run (step ms, busy, peak)."""
    out = {"gmm": yardstick}
    for impl in MOE_DISPATCHES:
        torch.cuda.empty_cache()
        wl = {**MOE_WL, "steps": MOE_DISPATCH_STEPS, "moe_dispatch": impl}
        run, counts = phase_train(smi, wl, dev, phase=f"moe_dispatch_{impl}")
        bd = phase_train_breakdown(run, smi, phase=f"moe_dispatch_{impl}_breakdown")
        out[impl] = {"step_ms": run.step_s * 1e3, "tokens_per_s": run.tokens_per_s,
                     "busy_ms": bd["device_busy_ms_per_step"],
                     "idle_share": bd["device_idle_share"],
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "drop_frac": router_metrics(run)["drop_frac"], "launches": counts}
        del run
    emit({"phase": "moe_dispatch", "preset": MOE_WL["preset"], "batch": MOE_WL["batch_size"],
          "seq": MOE_WL["seq_len"], "remat": MOE_WL["remat"], "steps": MOE_DISPATCH_STEPS,
          "dispatches": out, "card": smi})
    return out


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


def flash_work(b, t, h, h_kv, d, causal=True):
    """{kind: (operations, bytes)} of the three flash kernels at a bf16
    shape: the products on the live (query, key) pairs, each input read
    once and each output written once."""
    # live (query, key) pairs: under causal masking the lower triangle
    pairs = b * h * t * (t + 1) // 2 if causal else b * h * t * t
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


def bwd_timing_at(rng, b, t, h, h_kv, d, dev="cuda", causal=True):
    """K2 and K3 at another shape (bf16, a nonzero lse cotangent in delta):
    checked against their plain versions, then timed beside their bounds
    and SDPA's backward (dq, dk and dv in one call)."""
    q, k, v, do, dlse = flash_case(rng, b, t, h, h_kv, d, torch.bfloat16, dev)
    o, lse = fa.flash_fwd_kernel(q, k, v, causal)
    lse_k, delta = fa.lse_kernel_layout(lse), fa.flash_delta(o, do, dlse)
    f32 = [x.float() for x in (q, k, v, do)]
    got = {"dq": (fa.flash_bwd_dq_kernel(q, k, v, do, lse_k, delta, causal),),
           "dkv": fa.flash_bwd_dkv_kernel(q, k, v, do, lse_k, delta, causal)}
    want = {"dq": (fa.flash_bwd_dq_reference(*f32, lse_k, delta, causal),),
            "dkv": fa.flash_bwd_dkv_reference(*f32, lse_k, delta, causal)}
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
    out_t = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=h_kv != h)
    do_t = do.transpose(1, 2).contiguous()
    ms, source, runs = timed_in_turns(
        [("dq", lambda i: fa.flash_bwd_dq_kernel(q, k, v, do, lse_k, delta, causal)),
         ("dkv", lambda i: fa.flash_bwd_dkv_kernel(q, k, v, do, lse_k, delta, causal)),
         ("library_bwd", lambda i: torch.autograd.grad(out_t, (qt, kt, vt), do_t,
                                                       retain_graph=True))],
        {"dq": 20, "dkv": 20, "library_bwd": 20})
    work = flash_work(b, t, h, h_kv, d, causal)
    return {"shape": {"b": b, "t": t, "h": h, "h_kv": h_kv, "d": d, "causal": causal},
            **{kind: {"ms": ms[kind], **bound_of(*work[kind]), "tflops": work[kind][0] / ms[kind]
                      / 1e9, "max_abs_err": err[kind]} for kind in ("dq", "dkv")},
            "library_bwd_all_ms": ms["library_bwd"], "ms_source": source, "runs": runs}


def fwd_timing_at(rng, b, t, h, h_kv, d, dev="cuda", causal=True):
    """K1 alone at another shape (bf16): checked against its plain version,
    then timed beside SDPA's forward and its bound."""
    q, k, v, _, _ = flash_case(rng, b, t, h, h_kv, d, torch.bfloat16, dev)
    o, _ = fa.flash_fwd_kernel(q, k, v, causal)
    o_ref = fa.flash_fwd_reference(q.float(), k.float(), v.float(), causal)[0]
    err = (o.float() - o_ref).abs()
    check(bool((err <= flash_limit("o", o_ref, torch.bfloat16)).all()),
          f"flash fwd at b{b} t{t} h{h}/{h_kv} d{d}: max abs err {float(err.max())}")
    del o_ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ms, source, runs = timed_in_turns(
        [("kernel", lambda i: fa.flash_fwd_kernel(q, k, v, causal)),
         ("library", lambda i: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=h_kv != h))],
        {"kernel": 20, "library": 20})
    ops, nbytes = flash_work(b, t, h, h_kv, d, causal)["fwd"]
    return {"shape": {"b": b, "t": t, "h": h, "h_kv": h_kv, "d": d, "causal": causal},
            "ms": ms["kernel"],
            "library_ms": ms["library"], **bound_of(ops, nbytes),
            "tflops": ops / ms["kernel"] / 1e9, "max_abs_err": float(err.max()),
            "ms_source": source, "runs": runs}

# ---------------------------------------------------------------------------
# checkpoints, the operator-launched job, the JAX trajectory
# ---------------------------------------------------------------------------


def state_nbytes(state) -> int:
    leaves = ckpt_mod._flatten(ckpt_mod._to_tree(state))
    return sum(x.numel() * x.element_size() for _, x in leaves if isinstance(x, torch.Tensor))


def ckpt_dir_with_room(name: str, need: int) -> Path:
    """A fresh directory under CKPT_ROOT; raises when its disk has less
    than ``need`` bytes free (the phase never runs short, nor skips)."""
    CKPT_ROOT.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(CKPT_ROOT).free
    check(free >= need, f"{name}: {free / 1e9:.1f} GB free under {CKPT_ROOT}, "
                        f"the phase needs {need / 1e9:.1f} GB")
    return Path(tempfile.mkdtemp(prefix=f"{name}_", dir=CKPT_ROOT))


def orphans(d: Path) -> list:
    return sorted(n for n in os.listdir(d) if n.startswith(".tmp_step_"))


def timed_step(trainer, state, tokens):
    """One training step on the host clock, to its loss on the host."""
    t = time.perf_counter()
    state, m = trainer.step(state, tokens)
    float(m["loss"])
    return state, time.perf_counter() - t


def save_beside_steps(mgr, step, state, trainer, tokens):
    """An async save at ``step`` with training going on, in place, right
    behind it: the caller's stall, the staging copy's device time, each
    step's host time and cudaMalloc count while the drain runs (at most 8
    steps), and the time from the save's start to the commit."""
    def mallocs():
        return torch.cuda.memory_stats().get("num_device_alloc", 0)

    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    check(mgr.save(step, state), f"ckpt_roundtrip: save of step {step} refused")
    e1.record()
    stall_ms = mgr.last_save_stall_s * 1e3
    beside, allocs = [], []
    while len(beside) < 8 and (not beside or mgr._drain.is_alive()):
        n = mallocs()
        state, secs = timed_step(trainer, state, tokens)
        beside.append(secs * 1e3)
        allocs.append(mallocs() - n)
    mgr.wait_until_finished()
    return state, {"step": step, "save_stall_ms": stall_ms,
                   "stage_device_ms": e0.elapsed_time(e1),
                   "drain_s": time.perf_counter() - t0, "step_ms_beside_drain": beside,
                   "cuda_mallocs_beside_drain": allocs}


def phase_ckpt_roundtrip(run, smi):
    """The trained gqa-2048 state from ``train``, at full size: an async
    save with training steps queued right behind it while it drains
    (their in-place updates must not reach the checkpoint), three steps
    after it, and a restore into a fresh template with every leaf bitwise
    equal to the state as saved. Then a second save beside steps (the
    first one's staging blocks now cached), and a writer process killed at
    the drain's ``manifest`` phase: no step becomes discoverable, and the
    next manager sweeps its orphan."""
    # train_breakdown steps run.state's tensors and optimizer count in
    # place after run_lm returned it: its step is the count
    trainer = run.trainer
    state = replace(run.state, step=run.state.opt_state["count"])
    step = state.step
    nbytes = state_nbytes(state)
    d = ckpt_dir_with_room("ckpt_roundtrip", 2 * nbytes + (1 << 30))
    try:
        leaves = ckpt_mod._flatten(ckpt_mod._to_tree(state))
        paths = [p for p, _ in leaves]
        snap = [x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else np.array(x)
                for _, x in leaves]
        mgr = ckpt_mod.CheckpointManager(d, keep=1)
        torch.cuda.reset_peak_memory_stats()
        state, first = save_beside_steps(mgr, step, state, trainer, run.tokens)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        alone = []
        for _ in range(3):
            state, secs = timed_step(trainer, state, run.tokens)
            alone.append(secs * 1e3)
        written = sum(f.stat().st_size for f in (d / f"step_{step}").iterdir())
        moved = not torch.equal(state.params["embed"].detach().cpu(),
                                snap[paths.index("['params']['embed']")])
        check(moved, "ckpt_roundtrip: the steps after the save changed nothing")
        template = trainer.state_template()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        back = ckpt_mod.CheckpointManager(d).restore(template, device=run.device)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
        check(back.step == step and back.opt_state["count"] == step,
              f"ckpt_roundtrip: restored step {back.step}, count {back.opt_state['count']}")
        got = [x for _, x in ckpt_mod._flatten(ckpt_mod._to_tree(back))]
        differ = [p for p, s, g in zip(paths, snap, got)
                  if not (torch.equal(g.cpu(), s) if isinstance(g, torch.Tensor)
                          else int(g) == int(s))]
        check(not differ, f"ckpt_roundtrip: leaves differ after the restore: {differ[:6]}")
        del back, got, snap
        # the first drain's staging blocks stay cached for the second save
        state, second = save_beside_steps(mgr, state.step, state, trainer, run.tokens)
        last = second["step"]
        torch.cuda.empty_cache()  # room for the crash writer's process
        # a writer killed between its last leaf and its manifest
        crash = subprocess.run([sys.executable, "-c", CRASH_WRITER, str(d), str(last)],
                               cwd=REPO, capture_output=True, text=True, timeout=600)
        check(crash.returncode == 0, f"ckpt_roundtrip: crash writer exit {crash.returncode}: "
                                     f"{crash.stderr[-2000:]}")
        left = orphans(d)
        check(len(left) == 1 and ckpt_mod.latest_checkpoint_step(str(d)) == last,
              f"ckpt_roundtrip: after the crash {left}, latest "
              f"{ckpt_mod.latest_checkpoint_step(str(d))}")
        orphan_gb = sum(f.stat().st_size for f in (d / left[0]).iterdir()) / 1e9
        ckpt_mod.CheckpointManager(d)
        check(orphans(d) == [], f"ckpt_roundtrip: orphan not swept: {orphans(d)}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    emit({"phase": "ckpt_roundtrip", "step": step, "leaves": len(leaves),
          "state_gb": nbytes / 1e9, "written_gb": written / 1e9,
          # drain_s: from the save's start to the commit, steps running meanwhile
          "first_save": first, "step_ms_after_drain": alone,
          "drain_gb_per_s": written / 1e9 / first["drain_s"], "restore_s": restore_s,
          "restore_gb_per_s": written / 1e9 / restore_s,
          "peak_mem_gb_staging_beside_a_step": peak_gb, "bitwise_equal": True,
          "second_save": second,
          "crash_at_manifest": {"orphan_gb": orphan_gb, "discoverable": False,
                                "swept": True}, "card": smi})


# Loads a committed step's leaves onto the card, saves them at the next
# step through the async pipeline and dies (no cleanup) when the drain
# reaches its manifest: the orphan a crashed writer leaves.
CRASH_WRITER = """
import json, os, sys
import torch
from tf_operator_tpu_torch.train.checkpoint import CheckpointManager, _load_leaf
d, step = sys.argv[1], int(sys.argv[2])
src = os.path.join(d, f"step_{step}")
with open(os.path.join(src, "manifest.json")) as f:
    records = json.load(f)["leaves"]
tree = {r["path"]: torch.from_numpy(_load_leaf(os.path.join(src, f"leaf_{r['index']}.npy"),
                                               r)).cuda() for r in records}
mgr = CheckpointManager(d, keep=1)
mgr._fault_hook = lambda phase, s: os._exit(0) if phase == "manifest" else None
mgr.save(step + 1, tree, wait=True)
os._exit(1)
"""

HARNESS_DONE = re.compile(r"lm done: preset=(\S+) loss=(\S+) step=([\d.]+)ms tok/s=(\d+) "
                          r"mfu_attn=(\S+) mfu_6nd=(\S+)")
HARNESS_KERNELS = re.compile(r"lm kernels: flash_fwd_launches=(\d+) flash_bwd_dq_launches=(\d+) "
                             r"flash_bwd_dkv_launches=(\d+) final_loss=(\S+)")


def harness_env(spec: dict, wl: dict, ckpt_dir, replica_type: str = "Worker",
                entrypoint: str = "") -> dict:
    """The TPUJOB_* environment the operator's local backend gives the
    job's one worker (identity, gang, workload, and with ``ckpt_dir`` the
    warm-restart contract: the directory and the latest complete step in
    it), or its replica of ``replica_type`` running ``entrypoint``."""
    tmpl = spec["spec"]["replica_specs"]["Worker"]["template"]
    env = dict(os.environ)
    env.update({
        "PYTHONPATH": str(REPO) + os.pathsep + env.get("PYTHONPATH", ""),
        "TPUJOB_ENTRYPOINT": entrypoint or tmpl["entrypoint"],
        "TPUJOB_NAME": spec["metadata"]["name"],
        "TPUJOB_NAMESPACE": spec["metadata"].get("namespace", "default"),
        "TPUJOB_REPLICA_TYPE": replica_type, "TPUJOB_REPLICA_INDEX": "0", "TPUJOB_PORT": "0",
        "TPUJOB_CHIPS": str(tmpl.get("chips_per_process", 1)),
        "TPUJOB_NUM_PROCESSES": "1", "TPUJOB_PROCESS_ID": "0",
        "TPUJOB_MESH_AXES": json.dumps(spec["spec"]["topology"].get("mesh_axes", {})),
        "TPUJOB_WORKLOAD": json.dumps(wl),
    })
    if ckpt_dir is not None:
        env.update({
            "TPUJOB_CHECKPOINT_DIR": str(ckpt_dir),
            "TPUJOB_RESUME_STEP": str(ckpt_mod.latest_checkpoint_step(str(ckpt_dir))),
        })
    return env


def run_harness(spec, wl, ckpt_dir, log_path) -> tuple:
    """One incarnation of the job's worker: the real harness as a
    subprocess, its log appended to ``log_path``. (exit code, seconds)."""
    t0 = time.perf_counter()
    with open(log_path, "a") as log:
        proc = subprocess.run([sys.executable, "-m", "tf_operator_tpu.rendezvous.harness"],
                              env=harness_env(spec, wl, ckpt_dir), cwd=REPO, stdout=log,
                              stderr=subprocess.STDOUT, timeout=900)
    return proc.returncode, time.perf_counter() - t0


def harness_result(text: str, phase: str) -> dict:
    """The last ``lm done`` and ``lm kernels`` lines of a worker log."""
    done, kern = HARNESS_DONE.findall(text), HARNESS_KERNELS.findall(text)
    check(bool(done) and bool(kern), f"{phase}: no lm done / lm kernels line:\n{text[-3000:]}")
    _, loss, step_ms, tok_s, mfu_attn, mfu_6nd = done[-1]
    fwd, dq, dkv, final = kern[-1]
    def num(x):
        return None if x == "n/a" else float(x)

    return {"loss_4dp": float(loss), "step_ms": float(step_ms), "tokens_per_s": float(tok_s),
            "mfu_exact": num(mfu_attn), "mfu_6nd": num(mfu_6nd),
            "launches": {"flash_fwd_launches": int(fwd), "flash_bwd_dq_launches": int(dq),
                         "flash_bwd_dkv_launches": int(dkv)}, "final_loss": float(final)}


def phase_operator_resume(smi, base_losses):
    """The north-star job as the operator runs it, through the real
    harness: the first incarnation dies retryably (138) at step 6, the
    relaunch (the controller's gang restart) resumes from step 4's
    checkpoint and finishes the budget (step 8) through K1-K3; its final
    loss is held to the uninterrupted run of the same job, the train
    phase's (``base_losses``: the spec's workload and TRAIN_WL agree on
    every key that sets a value, checked here)."""
    spec = json.loads(NORTHSTAR_SPEC.read_text())
    cfg = preset_from_workload(spec["spec"]["workload"])
    spec_wl = spec["spec"]["workload"]
    same = {k: (spec_wl.get(k, default), TRAIN_WL[k]) for k, default in (
        ("preset", None), ("batch_size", None), ("seq_len", None), ("attn", None),
        ("remat", None), ("lr", 3e-4), ("data", "fixed"))}
    check(all(a == b for a, b in same.values()) and len(base_losses) >= RESUME_LAST,
          f"operator_resume: the spec's job is not the train phase's: {same}")
    need = 2 * 12 * cfg.n_params() + (1 << 30)  # two step dirs: f32 params and moments
    d = ckpt_dir_with_room("operator_resume", need)
    marker = d / "died-once"
    wl = {**spec_wl, **RESUME_OVERRIDES, "checkpoint_dir": str(d / "ckpt"),
          "fail_marker": str(marker)}
    torch.cuda.empty_cache()
    try:
        log1 = d / "worker-0.log"
        log1.write_text("")
        rc1, s1 = run_harness(spec, wl, d / "ckpt", log1)
        check(rc1 == 138 and marker.exists(),
              f"operator_resume: first incarnation exit {rc1}:\n{log1.read_text()[-3000:]}")
        at_restart = ckpt_mod.latest_checkpoint_step(wl["checkpoint_dir"])
        check(at_restart == RESUME_FROM, f"operator_resume: latest step {at_restart} at restart")
        rc2, s2 = run_harness(spec, wl, d / "ckpt", log1)
        text = log1.read_text()
        check(rc2 == 0, f"operator_resume: relaunch exit {rc2}:\n{text[-3000:]}")
        check(f"resumed from checkpoint at step {RESUME_FROM}" in text,
              f"operator_resume: no resume line:\n{text[-3000:]}")
        resumed = harness_result(text, "operator_resume")
        check(resumed["mfu_exact"] is not None and resumed["tokens_per_s"] > 0,
              f"operator_resume: lm done line without MFU: {resumed}")
        last = ckpt_mod.latest_checkpoint_step(wl["checkpoint_dir"])
        check(last == RESUME_LAST, f"operator_resume: latest step {last}")
        steps_run = RESUME_LAST - RESUME_FROM
        want = {k: v * cfg.n_layers * steps_run for k, v in DENSE_PER_LAYER.items()}
        check(resumed["launches"] == want,
              f"operator_resume: launches {resumed['launches']} != {want}")
        full = float(base_losses[RESUME_LAST - 1])
        diff = abs(resumed["final_loss"] - full)
        check(diff <= OPERATOR_RESUME_LOSS_ATOL,
              f"operator_resume: final loss {resumed['final_loss']} vs uninterrupted "
              f"{full} (limit {OPERATOR_RESUME_LOSS_ATOL})")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    emit({"phase": "operator_resume", "spec": str(NORTHSTAR_SPEC.relative_to(REPO)),
          "overrides": RESUME_OVERRIDES, "exit_codes": [rc1, rc2], "resumed_from": at_restart,
          "latest_step": last, "resumed": resumed, "uninterrupted_final_loss": full,
          "uninterrupted": "the train phase's run (same job, seed and batch)",
          "final_loss_diff": diff, "limit": OPERATOR_RESUME_LOSS_ATOL,
          # the harness logs the final loss with %.9g, which round-trips f32
          "bitwise_equal_final_loss": bool(np.float32(resumed["final_loss"])
                                           == np.float32(full)),
          "incarnation_s": [s1, s2], "card": smi})


# ---------------------------------------------------------------------------
# multi-process training: ranks of one gang through the real harness
# ---------------------------------------------------------------------------

# dist_smoke: the port's smoke job as examples/smoke_h100.json ships it (two
# workers sharing the card over gloo, dim 256), then as an NCCL group of one.
SMOKE_SPEC = REPO / "examples" / "smoke_h100.json"
RESNET_SPEC = REPO / "examples" / "resnet50_h100.json"
# Two ranks on one card run gloo: NCCL refuses two ranks on one device.
GLOO_ENV = {"TPUJOB_DIST_BACKEND": "gloo"}
# mesh_train: the train phase's job (gqa-2048 at full width and depth,
# global batch 6, t 2048, flash, save_mid, bf16) for 1 + 3 steps on two
# ranks under each mesh, from the same seed's init and the same fixed
# batch (each fsdp rank keeps its 3 rows; tp ranks read all 6).
MESH_TRAIN_AXES = ({"fsdp": 2}, {"tp": 2})
MESH_WL = {**TRAIN_WL, "steps": 3}
# Since pp_train joined the script, the fsdp 2 gang of mesh_train and the
# cp_train gangs run the train job cut to 6 of its 12 layers (depth
# only), held to one process's run of that cut (made while the gangs
# run): the script took 1,219 s of its 1,200 s limit on a slow host with
# both at full depth (PERF.md). tp 2 stays at full depth: at 6
# layers its third update read 5.5e-3 against MESH_LOSS_ATOL, where fsdp
# 2's passed.
MESH_CUT_WL = {**MESH_WL, "n_layers": 6}
MESH_TRAIN_WL = {"fsdp2": MESH_CUT_WL, "tp2": MESH_WL}
# The sharded run against the train phase's first four steps. Only where
# bf16 values are rounded differs: fsdp runs every product on 3 rows
# instead of 6 (cuBLAS may pick another split of the f32 sums) and sums
# the loss over two ranks; tp rounds each row-parallel partial (wo,
# w_down) to bf16 before the two are summed. Each limit sits ~5x or more
# above the sound runs' largest reading and ~10x or more below the
# smallest gap of the planted faults (MESH_PLANTS, run at this phase's
# shape), on "NVIDIA H100 80GB HBM3, 700.00 W" (readings repeated bitwise
# across runs, PERF.md):
# - the first loss (forward only): sound fsdp 0, tp 8.7e-5; the plants
#   leave it alone (a gradient fault), a forward fault moves it by far more;
# - the later losses: sound at most 2.4e-4 (fsdp) and 1.07e-3 (tp, step
#   3); plants 6.3e-2 (fsdp) and 0.65 (tp) at step 1;
# - every step's gradient norm before the clip, relative: sound at most
#   3.5e-4 (fsdp) and 1.12e-3 (tp); plants 0.29 and 0.52 at step 0.
MESH_FIRST_LOSS_ATOL = 5e-4
MESH_LOSS_ATOL = 5e-3
MESH_GRAD_NORM_RTOL = 1e-2
# Faults planted in the sharded path for mesh_train: name -> (mesh, the
# code each rank runs before the harness). Each must fail mesh_verdict.
# fsdp: the param gather's transpose keeps the rank's block of its own
# cotangent instead of reduce-scattering (a data-axis gradient left
# unreduced); tp: tp_region_enter's backward passes the rank's partial
# cotangent on unsummed (Megatron's f without its all-reduce).
_COLL = "import tf_operator_tpu_torch.parallel.collectives as c\n"
MESH_PLANTS = {
    "fsdp_gather_grad_not_reduced": ({"fsdp": 2}, _COLL + (
        "c._AllGather.backward = staticmethod(lambda ctx, g: "
        "(c._block(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None, None))\n")),
    "tp_enter_grad_not_summed": ({"tp": 2}, _COLL + (
        "c._TpEnter.backward = staticmethod(lambda ctx, g: (g, None, None))\n")),
}
# a plant's run: 1 + 2 steps (the first gradient and two updates) at 2
# layers, against one process's run of the same cut (cut from full
# depth when ep_train and cp_train joined the script, to keep its wall
# under ~1100 s of the 1200 s limit); a sound run of each mesh at the cut
# beside them must pass the same limits
MESH_PLANT_WL = {**MESH_WL, "steps": 2, "n_layers": 2}
# resnet_dp: resnet_train's job (ResNet-50, fused_1x1, global batch 128,
# 224^2) for 1 + 3 steps on two ranks under dp 2, 64 images each, batch
# norm synced; its first RESNET_AGREE_STEPS losses within RESNET_AGREE_RTOL
# of the single-process fused run's (resnet_agreement's limit: the same
# math with the statistics summed over two ranks).
RESNET_DP_WL = {**RESNET_WL, "steps": 3, "fused_1x1": True}
# gang_peer_loss: two ranks of tiny LM on the card under dp 2; rank 1 is
# killed (SIGKILL) once both train; rank 0 must exit 138 within the gang's
# collective timeout (rendezvous.context.DIST_TIMEOUT_S).
PEER_LOSS_WL = {"preset": "tiny", "steps": 100000, "batch_size": 4, "seq_len": 64,
                "attn": "flash", "remat": "save_mid", "lr": 3e-4, "data": "fixed"}
RANK_LINE = re.compile(r"(?:lm|resnet) rank: (\{.*\})")
SMOKE_OK = re.compile(r"smoke ok: (\d+) devices, checksum (\d+) \(rank (\d+) at .*, (\w+)\)")


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def gang_env(spec: dict, wl: dict, rank: int, n: int, coordinator: str, mesh_axes: dict,
             extra: dict, ckpt_dir=None) -> dict:
    """harness_env for rank ``rank`` of an ``n``-process gang (with
    ``ckpt_dir``, the warm-restart contract the controller stamps)."""
    env = harness_env(spec, wl, ckpt_dir)
    env.update({"TPUJOB_NUM_PROCESSES": str(n), "TPUJOB_PROCESS_ID": str(rank),
                "TPUJOB_REPLICA_INDEX": str(rank), "TPUJOB_COORDINATOR_ADDRESS": coordinator,
                "TPUJOB_MESH_AXES": json.dumps(mesh_axes)})
    env.update(extra)
    return env


def start_gang(spec, wl, n, mesh_axes, log_dir: Path, extra: dict, prelude: str = "",
               ckpt_dir=None) -> tuple:
    """The gang's ranks, each the real harness as a subprocess logging to
    ``log_dir/rank<r>.log`` (after ``prelude``, code each rank runs first:
    a planted fault; with ``ckpt_dir``, the controller's warm-restart
    environment): (processes, log paths)."""
    coordinator = f"localhost:{free_port()}"
    cmd = [sys.executable, "-m", "tf_operator_tpu.rendezvous.harness"]
    if prelude:
        cmd = [sys.executable, "-c", prelude + "import runpy\nrunpy.run_module("
               "'tf_operator_tpu.rendezvous.harness', run_name='__main__', alter_sys=True)\n"]
    procs, paths = [], []
    try:
        for r in range(n):
            paths.append(log_dir / f"rank{r}.log")
            with open(paths[-1], "w") as log:
                procs.append(subprocess.Popen(
                    cmd, env=gang_env(spec, wl, r, n, coordinator, mesh_axes, extra, ckpt_dir),
                    cwd=REPO,
                    stdout=log, stderr=subprocess.STDOUT))
    except BaseException:
        stop_gang(procs)
        raise
    return procs, paths


def stop_gang(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def run_gang(spec, wl, n, mesh_axes, log_dir: Path, extra: dict, timeout: float,
             prelude: str = "") -> tuple:
    """Run a gang to its end: (exit codes, seconds, log texts). A rank still
    running at ``timeout`` fails the phase; no process outlives the call."""
    log_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs, paths = start_gang(spec, wl, n, mesh_axes, log_dir, extra, prelude)
    try:
        rcs = [p.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0))) for p in procs]
    except subprocess.TimeoutExpired:
        stop_gang(procs)
        texts = "\n".join(p.read_text()[-2000:] for p in paths)
        check(False, f"gang of {n} did not end within {timeout} s:\n{texts}")
    finally:
        stop_gang(procs)
    return rcs, time.perf_counter() - t0, [p.read_text() for p in paths]


def rank_lines(texts, phase: str) -> list:
    """Each rank's ``lm rank`` / ``resnet rank`` JSON line."""
    out = []
    for r, text in enumerate(texts):
        found = RANK_LINE.findall(text)
        check(bool(found), f"{phase}: rank {r} logged no rank line:\n{text[-3000:]}")
        out.append(json.loads(found[-1]))
    return out


def gang_dir(name: str) -> Path:
    d = CKPT_ROOT / "gang" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


# Two ranks on the card over gloo: collectives.ring_shift of a CUDA tensor
# and its transpose, through the pinned host buffers (gloo's send/recv
# cannot take a device pointer). Each rank prints a ``ring`` JSON line.
RING_SHIFT = """
import json, sys
from datetime import timedelta
import torch
import torch.distributed as dist
from tf_operator_tpu_torch.parallel import collectives as coll
from tf_operator_tpu_torch.parallel.mesh import build_mesh
rank, port = int(sys.argv[1]), sys.argv[2]
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                        world_size=2, timeout=timedelta(seconds=120))
mesh = build_mesh({"tp": 2}, ranks=[0, 1], device_type="cuda")
x = torch.full((1024, 256), float(rank + 1), device="cuda", requires_grad=True)
y = coll.ring_shift(x, mesh, "tp")
y.backward(torch.full_like(y, float(10 * (rank + 1))))
torch.cuda.synchronize()
print("ring " + json.dumps({"rank": rank, "on_card": y.is_cuda and x.grad.is_cuda,
                            "y": sorted(set(y.detach().flatten().tolist())),
                            "grad": sorted(set(x.grad.flatten().tolist())),
                            "staged_bytes": coll.staged_bytes, "calls": coll.collective_calls}))
dist.destroy_process_group()
"""
RING_LINE = re.compile(r"^ring (\{.*\})$", re.M)


def ring_shift_on_card() -> dict:
    """RING_SHIFT on two ranks: rank r receives rank 1 - r's block (value
    2 - r) and gets back the cotangent rank 1 - r gave (10 (2 - r)); each
    rank stages its 1 MiB block and the 1 MiB it receives, both ways
    (4 MiB in two calls)."""
    port = str(free_port())
    env = {**os.environ, "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, "-c", RING_SHIFT, str(r), port], env=env,
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    try:
        texts = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        stop_gang(procs)
    block = 1024 * 256 * 4
    out = []
    for r, (p, text) in enumerate(zip(procs, texts)):
        found = RING_LINE.findall(text)
        check(p.returncode == 0 and bool(found), f"ring_shift rank {r}: exit {p.returncode}:\n"
              f"{text[-3000:]}")
        x = json.loads(found[-1])
        want = {"rank": r, "on_card": True, "y": [2.0 - r], "grad": [10.0 * (2 - r)],
                "staged_bytes": 4 * block, "calls": 2}
        check(x == want, f"ring_shift rank {r}: {x}, want {want}")
        out.append(x)
    return {"ranks": out, "staged_bytes_per_rank": 4 * block}


def phase_dist_smoke(smi):
    """The port's smoke entrypoint through the harness: two ranks on the
    card over gloo (examples/smoke_h100.json), every rank's checksum
    n_dev * dim^3 within rel 1e-5 (the workload raises otherwise); beside
    it one process as an NCCL group of one, whose all-reduce runs on
    NCCL, and the ring shift on two ranks over gloo
    (ring_shift_on_card), the one collective that stages through the
    host."""
    spec = json.loads(SMOKE_SPEC.read_text())
    wl = spec["spec"]["workload"]
    env = spec["spec"]["replica_specs"]["Worker"]["template"].get("env", {})
    d = gang_dir("dist_smoke")
    out = {}
    gangs = (("gloo_2", 2, env, "gloo"), ("nccl_1", 1, {"TPUJOB_DIST_BACKEND": "nccl"}, "nccl"))
    started = {}
    try:
        # the two gangs and the ring shift's two ranks at once
        for label, n, extra, _ in gangs:
            (d / label).mkdir(parents=True)
            started[label] = (time.perf_counter(), *start_gang(spec, wl, n, {}, d / label, extra))
        out["ring_shift_gloo_2"] = ring_shift_on_card()
        for label, n, extra, backend in gangs:
            t0, procs, paths = started[label]
            try:
                rcs = [p.wait(timeout=max(1.0, 300 - (time.perf_counter() - t0))) for p in procs]
            except subprocess.TimeoutExpired:
                check(False, f"dist_smoke {label}: a rank did not end within 300 s")
            secs, texts = time.perf_counter() - t0, [p.read_text() for p in paths]
            check(rcs == [0] * n, f"dist_smoke {label}: exit codes {rcs}:\n{texts[0][-3000:]}")
            want = n * int(wl["dim"]) ** 3
            seen = []
            for r, text in enumerate(texts):
                found = SMOKE_OK.findall(text)
                check(bool(found), f"dist_smoke {label}: rank {r} logged no smoke ok:\n"
                      f"{text[-3000:]}")
                devices, total, rank, used = found[-1]
                check(int(devices) == n and int(rank) == r and used == backend
                      and math.isclose(float(total), want, rel_tol=1e-5),
                      f"dist_smoke {label}: rank {r} logged {found[-1]}, want {want} on {backend}")
                seen.append(float(total))
            out[label] = {"ranks": n, "backend": backend, "checksums": seen, "want": want,
                          "seconds": secs}
    finally:
        for _, procs, _ in started.values():
            stop_gang(procs)
        shutil.rmtree(d, ignore_errors=True)
    emit({"phase": "dist_smoke", "spec": str(SMOKE_SPEC.relative_to(REPO)), "dim": wl["dim"],
          **out, "card": smi})


def phase_nccl_world1(smi, base_losses, base_norms, base_step_ms, dev="cuda"):
    """gqa-2048 at full width through the sharded trainer as an NCCL group
    of one, mesh {"fsdp": 1, "tp": 1}, 1 + 3 steps from train's seed and
    fixed batch: every collective of the sharded path is on an axis of size
    1, so the losses and gradient norms must equal train's first four
    bitwise (failing that, within the mesh limits, and the line says so);
    K1-K3 launched as there."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = build_rank_mesh({"fsdp": 1, "tp": 1}, ranks=[0], device_type="cuda")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        coll.reset_counters()
        run = run_lm(MESH_WL, device=dev, mesh=mesh)
        torch.cuda.synchronize()
        counts = read_counts()
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    n, L = len(run.losses), run.cfg.n_layers
    want = {name: DENSE_PER_LAYER.get(name, 0) * L * n for name in COUNTERS}
    check(counts == want, f"nccl_world1 launches {counts} != {want}")
    base = base_losses[:n]
    diffs = [abs(a - b) for a, b in zip(run.losses, base)]
    norm_rel = [abs(a - b) / b for a, b in zip(run.grad_norms, base_norms)]
    bitwise = run.losses == base and run.grad_norms == base_norms[:n]
    check(bitwise or (diffs[0] <= MESH_FIRST_LOSS_ATOL and max(diffs) <= MESH_LOSS_ATOL
                      and max(norm_rel) <= MESH_GRAD_NORM_RTOL),
          f"nccl_world1 losses {run.losses} and grad norms {run.grad_norms} vs train's "
          f"{base} and {base_norms[:n]}")
    emit({"phase": "nccl_world1", "backend": backend, "mesh": {"fsdp": 1, "tp": 1},
          "steps": n, "losses": run.losses, "train_losses": base, "bitwise_equal": bitwise,
          "loss_abs_diff": diffs, "grad_norms": run.grad_norms,
          "train_grad_norms": base_norms[:n], "launches": counts, "step_ms": run.step_s * 1e3,
          "train_step_ms": base_step_ms, "collective_calls": coll.collective_calls,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": smi})


def mesh_verdict(lines, base_losses, base_norms) -> tuple:
    """(failed checks, readings) of a two-rank run's rank lines against the
    one-process run's first losses and gradient norms: the first loss,
    the later ones and every gradient norm within the mesh limits, and the
    replicated leaves (tp's norms) one digest on both ranks."""
    losses, norms = lines[0]["losses"], lines[0]["grad_norms"]
    loss_diff = [abs(a - b) for a, b in zip(losses, base_losses)]
    norm_rel = [abs(a - b) / b for a, b in zip(norms, base_norms)]
    same = len({x["replicated_sha256"] for x in lines}) == 1
    failed = []
    if loss_diff[0] > MESH_FIRST_LOSS_ATOL:
        failed.append(f"first loss {loss_diff[0]:.3g} > {MESH_FIRST_LOSS_ATOL}")
    if max(loss_diff[1:]) > MESH_LOSS_ATOL:
        failed.append(f"later loss {max(loss_diff[1:]):.3g} > {MESH_LOSS_ATOL}")
    if max(norm_rel) > MESH_GRAD_NORM_RTOL:
        failed.append(f"grad norm rel {max(norm_rel):.3g} > {MESH_GRAD_NORM_RTOL}")
    if not same:
        failed.append("the ranks' replicated leaves differ")
    return failed, {"losses": losses, "loss_abs_diff": loss_diff, "grad_norms": norms,
                    "grad_norm_rel_diff": norm_rel, "replicated_equal": same}


def phase_mesh_train(smi, base_losses, base_norms, base_step_ms):
    """Two ranks share the card over gloo and train gqa-2048 at full width
    through the harness under {"fsdp": 2} (6 layers, MESH_CUT_WL) and
    {"tp": 2} (full depth), 1 + 3 steps: mesh_verdict passes (losses and
    gradient norms within the mesh limits of one process's run of the
    same depth: train's first four, or the cut's, made here while the
    gangs run; the replicated leaves equal on both ranks); each rank
    launches K1/K2/K3 as many times a step as one process does (2·L / L /
    L), under tp 2 at 8 query and 2 KV heads. Each planted fault of
    MESH_PLANTS at the same width and 2 layers, 1 + 2 steps, must fail
    mesh_verdict against one process's run of that cut, and a sound run
    of each mesh at that cut must pass it (the six gangs at once). Logs
    each rank's step ms, host ms in collectives, bytes staged through the
    host and peak GB (two ranks on one card: no scaling figure). Returns
    (a rank's launches a step by mesh, the 6-layer cut's losses and
    gradient norms: cp_train's yardstick)."""
    n_steps = MESH_WL["steps"] + 1
    d = gang_dir("mesh_train")
    out, plants = [], {}
    try:
        labels = {"_".join(f"{k}{v}" for k, v in axes.items()): axes for axes in MESH_TRAIN_AXES}
        sound = {"sound_" + "_".join(f"{k}{v}" for k, v in axes.items()): (axes, "")
                 for axes in MESH_TRAIN_AXES}
        bases = {"tp2": (base_losses, base_norms)}

        def one_process_cuts():
            for key, wl in (("fsdp2", MESH_CUT_WL), ("plants", MESH_PLANT_WL)):
                run = run_lm(wl, device="cuda")
                bases[key] = run.losses, run.grad_norms
                del run

        runs = gangs_checked(d, "mesh_train", [(label, axes, MESH_TRAIN_WL[label], "")
                                               for label, axes in labels.items()] + [
            (name, axes, MESH_PLANT_WL, prelude)
            for name, (axes, prelude) in {**MESH_PLANTS, **sound}.items()],
            meanwhile=one_process_cuts)
        cut_losses, cut_norms = bases["plants"]
        for label, axes in labels.items():
            lines, secs, texts = runs[label]
            cfg = preset_from_workload(MESH_TRAIN_WL[label])
            want = {k: v * cfg.n_layers * n_steps for k, v in DENSE_PER_LAYER.items()}
            failed, seen = mesh_verdict(lines, *bases[label])
            check(not failed, f"mesh_train {label}: {failed}: {seen} vs one process's "
                  f"{bases[label]}")
            tp = axes.get("tp", 1)
            heads = [cfg.n_heads // tp, cfg.n_kv_heads // tp]
            for x in lines:
                check(x["launches"] == want, f"mesh_train {label}: rank {x['rank']} launches "
                      f"{x['launches']} != {want}")
                check(x["flash_fwd_heads"] == heads, f"mesh_train {label}: K1 ran at heads "
                      f"{x['flash_fwd_heads']}, want {heads}")
            done = harness_result_done(texts[0], f"mesh_train {label}")
            out.append({"mesh": axes, "n_layers": cfg.n_layers, **seen,
                        "base_losses": bases[label][0], "base_grad_norms": bases[label][1],
                        "step_ms": done["step_ms"], "tokens_per_s": done["tokens_per_s"],
                        "per_rank": [{k: x[k] for k in ("rank", "step_ms", "collective_s",
                                                        "collective_calls", "staged_bytes",
                                                        "peak_gb", "flash_fwd_heads")}
                                     for x in lines],
                        "launches_per_rank_per_step": {k: v / n_steps
                                                       for k, v in lines[0]["launches"].items()},
                        "seconds": secs})
        for name, (axes, prelude) in {**MESH_PLANTS, **sound}.items():
            lines, secs, _ = runs[name]
            failed, seen = mesh_verdict(lines, cut_losses, cut_norms)
            if name in sound:
                check(not failed, f"mesh_train: sound run {name} at the plants' cut: {failed}: "
                      f"{seen} vs {cut_losses}, {cut_norms}")
            else:
                check(bool(failed), f"mesh_train: planted fault {name} passed: {seen}")
            plants[name] = {"mesh": axes, "n_layers": MESH_PLANT_WL["n_layers"],
                            "caught_by": failed, **seen, "base_losses": cut_losses,
                            "seconds": secs}
    finally:
        shutil.rmtree(d, ignore_errors=True)
    emit({"phase": "mesh_train", "preset": MESH_WL["preset"], "batch": MESH_WL["batch_size"],
          "seq": MESH_WL["seq_len"], "backend": "gloo", "ranks": 2, "runs": out,
          "plants": plants, "train_losses": base_losses[:n_steps],
          "train_grad_norms": base_norms[:n_steps], "train_step_ms": base_step_ms,
          "first_loss_atol": MESH_FIRST_LOSS_ATOL, "loss_atol": MESH_LOSS_ATOL,
          "grad_norm_rtol": MESH_GRAD_NORM_RTOL,
          "note": "two ranks share one card over gloo: a path check, not a scaling figure",
          "card": smi})
    return ({"_".join(f"{k}{v}" for k, v in r["mesh"].items()): r["launches_per_rank_per_step"]
             for r in out}, bases["fsdp2"])


# ep_train, cp_train and gang_plants start their independent gangs at
# once (gangs_checked: four or more ranks on the card), as mesh_train does
# its: one after another the script took 1160 s of its 1200 s limit on
# a slow host ("NVIDIA H100 80GB HBM3, 700.00 W", PERF.md). Their step ms
# are then those of two gangs sharing the card.
# ep_train: moe_train's job (moe-small at full width and depth, 8 experts,
# top-1, gmm, b 16, t 512, full remat, bf16) for 1 + 3 steps on two ranks
# under ep 2, each rank holding 4 experts and, through the ep region, half
# of the tokens; held to moe_train's first four losses and gradient norms
# by mesh_verdict (gmm drops nothing: one process and the gang compute one
# function), K5/K6/K7a/K7b launched a rank and step as one process does.
EP_WL = {**MOE_WL, "steps": 3}
# Then sort at MOE_CHECK_CF for 1 + 2 steps, where choices drop (at cf 2.0
# moe-small's random router drops none, and a capacity from the global
# token count or a wrong queue order would pass): the per-shard queues (of
# 4,096 tokens a rank, 256 slots an expert) drop other choices than one
# process's queues of 8,192, so the losses are not held to moe_train's;
# instead the first step's layer-0 MoE output on each rank's tokens
# against a plain f32 recompute of its queues (EP_LAYER_CHECK), with the
# same drop fraction, above 0.
EP_SORT_WL = {**MOE_WL, "steps": 2, "moe_dispatch": "sort", "capacity_factor": MOE_CHECK_CF}
# The recompute's limit on |port - plain|, elementwise: the port runs the
# three expert products in bf16 (two roundings more than one gmm product,
# GMM_BF16_*), so twice gmm's bf16 limit: 2^-6 of the value plus 2^-5 of
# the row's rms. A wrong expert or slot moves an output by O(1) of the rms.
EP_LAYER_RTOL = 2.0**-6
EP_LAYER_RMS_ATOL = 2.0**-5
# Each rank of the sort run checks layer 0 of the first step's forward
# (the first call of _moe_mlp) on its block of the tokens: the port's
# output against _moe_single's einsum dispatch in f32 on the same tokens
# and router logits, at the per-shard capacity, with every expert gathered
# over ep; logs an ``ep layer`` JSON line.
EP_LAYER_CHECK = """
import json, logging
import torch
import tf_operator_tpu_torch.models.transformer as T
from tf_operator_tpu_torch.parallel import collectives as C, moe as M
_sound, _seen = T._moe_mlp, []
def _checked(h, lp, cfg):
    out, aux = _sound(h, lp, cfg)
    if _seen:
        return out, aux
    _seen.append(1)
    with torch.no_grad():
        mesh = lp.spmd.mesh
        flat = h.detach().reshape(-1, h.shape[-1])
        logits = flat @ lp["w_router"].detach().to(h.dtype)
        n, i = C.axis_size(mesh, "ep"), C.axis_index(mesh, "ep")
        rows = flat.shape[0] // n
        mine = slice(i * rows, (i + 1) * rows)
        experts = {k: C._gather(lp[k].detach().float(), mesh, "ep", 0)
                   for k in ("w_gate", "w_up", "w_down")}
        cap = M.expert_capacity(cfg.capacity_factor, cfg.moe_top_k, rows, cfg.n_experts)
        want, stats = M._moe_single(flat[mine].float(), logits[mine].float(), experts,
                                    T._swiglu_experts, cap, "zero", cfg.moe_top_k, "einsum")
        got = out.detach().reshape(-1, h.shape[-1])[mine].float()
        rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
        limit = %r * want.abs() + %r * rms
        err = (got - want).abs()
        # a token whose choices all dropped is 0 in both: any error there is unbounded
        over = torch.where(limit > 0, err / limit.clamp_min(1e-30),
                           torch.where(err > 0, float("inf"), 0.0))
        drop = C.sum_no_grad(stats["drop_frac"].reshape(1), mesh, ("ep",)) / n
        logging.getLogger("tpujob.lm").info("ep layer: %%s", json.dumps({
            "rank": i, "tokens": rows, "capacity": cap,
            "max_abs_err": float(err.max()), "worst_err_over_limit": float(over.max()),
            "plain_drop_frac": float(drop), "drop_frac": float(aux["drop_frac"])}))
    return out, aux
T._moe_mlp = _checked
""" % (EP_LAYER_RTOL, EP_LAYER_RMS_ATOL)
EP_LAYER_LINE = re.compile(r"ep layer: (\{.*\})")
# cp_train: the train phase's job (gqa-2048, b 6, t 2048, flash, save_mid,
# bf16) for 1 + 2 steps on two ranks under cp 2, each holding its 1,024
# positions of every row, with ring and then Ulysses attention; held to
# train's first three losses and gradient norms by mesh_verdict.
CP_WL = {**MESH_CUT_WL, "steps": 2}
CP_IMPLS = ("ring", "ulysses")
# Faults planted in the ep and cp paths, at a cut depth (2 layers, 1 + 2
# steps) against a one-process run of the same cut: name -> (mesh, the
# workload, the code each rank runs first). Each must fail mesh_verdict.
# ep: the gmm receiver builds its block -> expert map from its own counts
# instead of the exchanged ones; cp: the ring's causal skip inverted (the
# blocks of earlier ranks skipped, the later ones attended).
EP_CP_PLANTS = {
    "ep_own_counts": ({"ep": 2}, {**EP_WL, "steps": 2, "n_layers": 2}, _COLL + (
        "c.exchange_counts = lambda counts, mesh, axis: counts\n")),
    "cp_skip_inverted": ({"cp": 2}, {**CP_WL, "attn": "ring", "n_layers": 2}, (
        "import tf_operator_tpu_torch.parallel.ring_attention as r\n"
        "r._in_future = lambda src, my: src < my\n")),
}
GMM_COUNTERS = ("gmm_fwd_launches", "gmm_fwd_scaled_launches", "gmm_dw_launches",
                "gmm_dw_scaled_launches")


def gangs_checked(d: Path, phase: str, runs, timeout: float = 900, meanwhile=None) -> dict:
    """Gangs through the harness (gloo), one rank for each device of their
    mesh, all started at once on the card: ``runs`` is (label, axes, wl,
    prelude) each; ``meanwhile()``, this process's own work, runs while
    they do. {label: (rank lines, seconds from its start until it was
    reaped, log texts)}; exit 0 on every rank and one loss and gradient
    norm a step on each, or the phase fails. No process outlives the
    call."""
    torch.cuda.empty_cache()
    spec = json.loads(NORTHSTAR_SPEC.read_text())
    started, out = [], {}
    try:
        for label, axes, wl, prelude in runs:
            (d / label).mkdir(parents=True, exist_ok=True)
            started.append((label, wl, time.perf_counter(),
                            *start_gang(spec, wl, math.prod(axes.values()), axes, d / label,
                                        GLOO_ENV, prelude)))
        if meanwhile is not None:
            meanwhile()
        for label, wl, t0, procs, paths in started:
            try:
                rcs = [p.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
                       for p in procs]
            except subprocess.TimeoutExpired:
                check(False, f"{phase} {label}: a rank did not end within {timeout} s:\n"
                      + "\n".join(p.read_text()[-2000:] for p in paths))
            secs, texts = time.perf_counter() - t0, [p.read_text() for p in paths]
            check(rcs == [0] * len(procs), f"{phase} {label}: exit codes {rcs}:\n"
                  + "\n".join(t[-3000:] for t in texts))
            lines = rank_lines(texts, f"{phase} {label}")
            n = wl["steps"] + 1
            check(all(len(x["losses"]) == len(x["grad_norms"]) == n for x in lines),
                  f"{phase} {label}: not {n} losses and grad norms a rank")
            out[label] = (lines, secs, texts)
    finally:
        for run in started:
            stop_gang(run[3])
    return out


def per_rank(lines) -> list:
    return [{k: x.get(k) for k in ("rank", "step_ms", "collective_s", "collective_calls",
                                  "staged_bytes", "all_to_all_bytes",
                                  "received_blocks_occupied", "peak_gb", "flash_fwd_heads")}
            for x in lines]


def cp_kernel_timing(cfg, b: int, t: int, dev="cuda") -> dict:
    """K1, K2 and K3 (with a nonzero lse cotangent) at cp_train's shapes on
    two ranks, each checked against its plain version and timed beside its
    bound and SDPA: a ring hop of t/2 positions at all heads, causal (the
    diagonal) and not (a block of an earlier rank); Ulysses' whole sequence
    on half of the heads, causal."""
    rng = np.random.RandomState(15)
    h, h_kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {"ring_diagonal": (b, t // 2, h, h_kv, True),
              "ring_earlier_block": (b, t // 2, h, h_kv, False),
              "ulysses": (b, t, h // 2, h_kv // 2, True)}
    out = {}
    for name, (b_, t_, h_, hkv_, causal) in shapes.items():
        fwd = fwd_timing_at(rng, b_, t_, h_, hkv_, d, dev, causal)
        bwd = bwd_timing_at(rng, b_, t_, h_, hkv_, d, dev, causal)
        out[name] = {"shape": fwd["shape"],
                     "k1": {k: fwd[k] for k in ("ms", "library_ms", "bound_ms", "bound_by",
                                                "max_abs_err")},
                     "k2": {k: bwd["dq"][k] for k in ("ms", "bound_ms", "bound_by",
                                                      "max_abs_err")},
                     "k3": {k: bwd["dkv"][k] for k in ("ms", "bound_ms", "bound_by",
                                                       "max_abs_err")},
                     "library_bwd_all_ms": bwd["library_bwd_all_ms"],
                     "ms_source": fwd["ms_source"]}
    return out


def ep_gmm_timing(dev="cuda", tokens=4096, E=8, S=2, d=768, f=3072, B=256) -> dict:
    """K5 (gate/up, d -> f), K6 (down, f -> d, row-scaled), K7a and K7b on the
    buffer an ep rank receives in ep_train (S segments of ceil(tokens/B) +
    E/S blocks, each source's top-1 choices over E experts in its expert
    regions, the rest -1), checked against their plain versions and timed
    beside them and the bound of the occupied rows. bf16."""
    rng = np.random.RandomState(16)
    gen = torch.Generator(dev).manual_seed(16)
    e_local = E // S
    counts = torch.from_numpy(rng.multinomial(tokens, [1.0 / E] * E, size=S)[:, :e_local])
    seg_blocks = -(-tokens // B) + e_local
    be = moe_mod.receiver_block_expert(counts.to(dev), B, seg_blocks)
    R = be.numel() * B
    rows = int((be >= 0).sum()) * B
    bf = torch.bfloat16

    def draw(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale).to(bf)

    x, h = draw(R, d), draw(R, f)
    w_up, w_down = draw(e_local, d, f, scale=d**-0.5), draw(e_local, f, d, scale=f**-0.5)
    dy_up, dy_down = draw(R, f), draw(R, d)
    s = torch.rand(R, device=dev, generator=gen)
    e2, e4 = 2, 4
    specs = {  # name: (kernel, plain, ops, bytes, out dims)
        "k5": (lambda i: gm.gmm_fwd_kernel(x, w_up, be, block_rows=B),
               lambda i: gm.gmm_fwd_reference(x, w_up, be, block_rows=B), 2 * rows * d * f,
               rows * d * e2 + e_local * d * f * e2 + R * f * e2, (-1,)),
        "k6": (lambda i: gm.gmm_fwd_kernel(h, w_down, be, s, block_rows=B),
               lambda i: gm.gmm_fwd_reference(h, w_down, be, s, block_rows=B),
               2 * rows * f * d, rows * f * e2 + e_local * f * d * e2 + rows * e4 + R * d * e2,
               (-1,)),
        "k7a": (lambda i: gm.gmm_dw_kernel(x, dy_up, be, e_local, block_rows=B),
                lambda i: gm.gmm_dw_reference(x, dy_up, be, e_local, block_rows=B),
                2 * rows * d * f, rows * d * e2 + rows * f * e2 + e_local * d * f * e4, (1, 2)),
        "k7b": (lambda i: gm.gmm_dw_kernel(h, dy_down, be, e_local, s, block_rows=B),
                lambda i: gm.gmm_dw_reference(h, dy_down, be, e_local, s, block_rows=B),
                2 * rows * f * d,
                rows * f * e2 + rows * d * e2 + rows * e4 + e_local * f * d * e4, (1, 2)),
    }
    out = {"rows": R, "computed_rows": rows, "occupied_share": rows / R,
           "blocks": be.numel(), "experts_local": e_local}
    for name, (kern, plain, ops, nbytes, dims) in specs.items():
        got, want = kern(0).float(), plain(0).float()
        err = (got - want).abs()
        check(bool((err <= gmm_limit(want, bf, dims)).all()),
              f"ep_gmm_timing {name}: max abs err {float(err.max())}")
        del got, want
        ms, source, _ = timed_in_turns([("kernel", kern), ("plain", plain)],
                                       {"kernel": 20, "plain": 3})
        out[name] = {"ms": ms["kernel"], "plain_ms": ms["plain"], **bound_of(ops, nbytes),
                     "max_abs_err": float(err.max()), "ms_source": source}
    return out


def phase_ep_train(smi, base_losses, base_norms):
    """Two gangs of two ranks, started at once, share the card over gloo
    and train moe-small at full width through the harness under {"ep": 2}:
    gmm for 1 + 3 steps, mesh_verdict
    against moe_train's first four losses and gradient norms, and each
    rank's K1-K3 and K5/K6/K7a/K7b launches a step equal to one process's
    (MOE_PER_LAYER); then sort (cf MOE_CHECK_CF) for 1 + 2 steps, each
    rank's layer-0 output of the first step within EP_LAYER_* of the plain
    f32 recompute of its queues, with the same drop fraction, above 0, the loss finite
    and falling, no gmm launch. Logs a rank's occupied share of its received
    blocks, its all_to_all bytes, host seconds in collectives and peak GB;
    then K5/K6/K7a/K7b timed on such a received buffer (ep_gmm_timing)."""
    cfg = preset_from_workload(EP_WL)
    d = gang_dir("ep_train")
    try:
        runs = gangs_checked(d, "ep_train", [("gmm", {"ep": 2}, EP_WL, ""),
                                             ("sort", {"ep": 2}, EP_SORT_WL, EP_LAYER_CHECK)])
        lines, secs, texts = runs["gmm"]
        failed, seen = mesh_verdict(lines, base_losses, base_norms)
        check(not failed, f"ep_train gmm: {failed}: {seen} vs moe_train's losses "
              f"{base_losses[:4]}, grad norms {base_norms[:4]}")
        n = EP_WL["steps"] + 1
        want = {k: v * cfg.n_layers * n for k, v in MOE_PER_LAYER.items()}
        for x in lines:
            check(x["launches"] == want, f"ep_train gmm: rank {x['rank']} launches "
                  f"{x['launches']} != {want}")
            check(0 < x["received_blocks_occupied"] < 1, f"ep_train gmm: rank {x['rank']} "
                  f"occupied share {x['received_blocks_occupied']}")
        done = harness_result_done(texts[0], "ep_train gmm")
        gmm = {**seen, "step_ms": done["step_ms"], "tokens_per_s": done["tokens_per_s"],
               "per_rank": per_rank(lines),
               "launches_per_rank_per_step": {k: v / n for k, v in lines[0]["launches"].items()},
               "seconds": secs}
        lines, secs, texts = runs["sort"]
        n = EP_SORT_WL["steps"] + 1
        layer = []
        for r, text in enumerate(texts):
            found = EP_LAYER_LINE.findall(text)
            check(bool(found), f"ep_train sort: rank {r} logged no ep layer line")
            layer.append(json.loads(found[0]))
        for x in layer:
            check(x["worst_err_over_limit"] <= 1.0, f"ep_train sort: layer 0 vs plain {x}")
            check(x["plain_drop_frac"] > 0 and x["plain_drop_frac"] == x["drop_frac"],
                  f"ep_train sort: drop fractions {x}")
        want = {k: v * cfg.n_layers * n for k, v in DENSE_PER_LAYER.items()}
        want.update({k: 0 for k in GMM_COUNTERS})
        for x in lines:
            check(x["launches"] == want, f"ep_train sort: rank {x['rank']} launches "
                  f"{x['launches']} != {want}")
            check(all(np.isfinite(x["losses"])) and x["losses"][-1] < x["losses"][0],
                  f"ep_train sort: rank {x['rank']} losses {x['losses']}")
        done = harness_result_done(texts[0], "ep_train sort")
        sort = {"losses": lines[0]["losses"], "grad_norms": lines[0]["grad_norms"],
                "layer0": layer, "rtol": EP_LAYER_RTOL, "rms_atol": EP_LAYER_RMS_ATOL,
                "step_ms": done["step_ms"], "tokens_per_s": done["tokens_per_s"],
                "per_rank": per_rank(lines), "seconds": secs}
    finally:
        shutil.rmtree(d, ignore_errors=True)
    kernel_ms = ep_gmm_timing(tokens=EP_WL["batch_size"] * EP_WL["seq_len"] // 2,
                              E=cfg.n_experts, d=cfg.d_model, f=cfg.d_ff)
    gmm_losses, gmm_norms = gmm["losses"], gmm["grad_norms"]
    emit({"phase": "ep_train", "preset": EP_WL["preset"], "batch": EP_WL["batch_size"],
          "seq": EP_WL["seq_len"], "backend": "gloo", "ranks": 2, "mesh": {"ep": 2},
          "gmm": gmm, "sort": sort, "kernel_ms_received_buffer": kernel_ms,
          "moe_train_losses": base_losses[:4],
          "moe_train_grad_norms": base_norms[:4],
          "note": "two ranks share one card over gloo: a path check, not a scaling figure",
          "card": smi})
    return gmm["launches_per_rank_per_step"], gmm_losses, gmm_norms


def phase_cp_train(smi, base_losses, base_norms):
    """Two gangs of two ranks, started at once, share the card over gloo
    and train gqa-2048 at full width and 6 layers (MESH_CUT_WL) through
    the harness under {"cp": 2}, 1 + 2 steps, one with ring and one with
    Ulysses attention: mesh_verdict against one process's first three
    losses and gradient norms at that cut (mesh_train's);
    K1-K3 launches a rank and step as the hop schedule says
    (ring: rank r runs r + 1 hops a layer, each twice under save_mid, K1 at
    16 and 4 heads; Ulysses: one attention over the whole sequence on 8 and
    2 heads a layer, 2·L / L / L); then K1-K3 timed at those shapes
    (cp_kernel_timing)."""
    cfg = preset_from_workload(CP_WL)
    L, n = cfg.n_layers, CP_WL["steps"] + 1
    d = gang_dir("cp_train")
    out = {}
    try:
        runs = gangs_checked(d, "cp_train", [(impl, {"cp": 2}, {**CP_WL, "attn": impl}, "")
                                             for impl in CP_IMPLS])
        for impl in CP_IMPLS:
            lines, secs, texts = runs[impl]
            failed, seen = mesh_verdict(lines, base_losses, base_norms)
            check(not failed, f"cp_train {impl}: {failed}: {seen} vs the cut's losses "
                  f"{base_losses[:n]}, grad norms {base_norms[:n]}")
            for x in lines:
                hops = x["rank"] + 1 if impl == "ring" else 1
                want = {k: v * L * n * hops for k, v in DENSE_PER_LAYER.items()}
                check(x["launches"] == want, f"cp_train {impl}: rank {x['rank']} launches "
                      f"{x['launches']} != {want}")
                heads = ([cfg.n_heads, cfg.n_kv_heads] if impl == "ring"
                         else [cfg.n_heads // 2, cfg.n_kv_heads // 2])
                check(x["flash_fwd_heads"] == heads, f"cp_train {impl}: K1 ran at heads "
                      f"{x['flash_fwd_heads']}, want {heads}")
            done = harness_result_done(texts[0], f"cp_train {impl}")
            out[impl] = {**seen, "step_ms": done["step_ms"],
                         "tokens_per_s": done["tokens_per_s"], "per_rank": per_rank(lines),
                         "launches_per_step": {x["rank"]: {k: v / n for k, v in
                                                           x["launches"].items()}
                                               for x in lines},
                         "seconds": secs}
    finally:
        shutil.rmtree(d, ignore_errors=True)
    kernel_ms = cp_kernel_timing(cfg, CP_WL["batch_size"], CP_WL["seq_len"])
    emit({"phase": "cp_train", "preset": CP_WL["preset"], "batch": CP_WL["batch_size"],
          "seq": CP_WL["seq_len"], "backend": "gloo", "ranks": 2, "mesh": {"cp": 2},
          "n_layers": cfg.n_layers, "runs": out, "kernel_ms": kernel_ms,
          "base_losses": base_losses[:n], "base_grad_norms": base_norms[:n],
          "note": "two ranks share one card over gloo: a path check, not a scaling figure",
          "card": smi})
    return out


def phase_gang_plants(smi):
    """The planted faults of the ep, cp and pp paths (EP_CP_PLANTS; and
    PP_PLANTS, both on the MoE pipeline's cut beside one sound gang), each
    on its mesh at its cut depth beside a sound gang of that mesh at the
    cut, all the gangs at once (at 2 layers a gang's
    start-up is most of its time): each plant must fail mesh_verdict
    against one process's run of the cut (run_lm here while the gangs run,
    same seed and batch, flash attention; the pp MoE pair's CE terms against one
    process with the pipeline's lb, over its first PP_MOE_CUT_STEPS
    steps), and each sound gang must pass it. Prints the ep_cp_plants and
    pp_plants lines before its checks fail it."""
    d = gang_dir("gang_plants")
    bases, runs_of = {}, {}
    for name, (axes, wl, prelude) in EP_CP_PLANTS.items():
        runs_of[name], runs_of["sound_" + name] = (axes, wl, prelude), (axes, wl, "")
    for name, prelude in PP_PLANTS.items():
        runs_of[name] = (PP_MOE_AXES, PP_MOE_CUT_WL, prelude)
    runs_of["sound_pp"] = (PP_MOE_AXES, PP_MOE_CUT_WL, PP_TERMS)

    def one_process_bases():
        for name, (axes, wl, _) in EP_CP_PLANTS.items():
            base = run_lm({**wl, "attn": "flash"}, device="cuda")  # ring is flash off cp
            bases[name] = bases["sound_" + name] = base.losses, base.grad_norms
            del base
        # the CE terms: the router losses are per microbatch
        _, norms, terms = pp_one_process(PP_MOE_CUT_WL, PP_MOE_AXES)
        pp = [t["ce_loss"] for t in terms][:PP_MOE_CUT_STEPS], norms[:PP_MOE_CUT_STEPS]
        bases.update({name: pp for name in [*PP_PLANTS, "sound_pp"]})

    plants, problems = {"ep_cp_plants": {}, "pp_plants": {}}, []
    try:
        runs = gangs_checked(d, "gang_plants", [(name, axes, wl, prelude) for name, (
            axes, wl, prelude) in runs_of.items()], meanwhile=one_process_bases)
        for name, (axes, wl, _) in runs_of.items():
            lines, secs, texts = runs[name]
            pipeline = name in PP_PLANTS or name == "sound_pp"
            if pipeline:
                lines = [{**x, "losses": [t["ce_loss"] for t in tr]}
                         for x, tr in zip(lines, pp_terms_of(texts, f"gang_plants {name}"))]
            failed, seen = mesh_verdict(lines, *bases[name])
            if not name.startswith("sound_") and not failed:
                problems.append(f"planted fault {name} passed: {seen}")
            elif name.startswith("sound_") and failed:
                problems.append(f"sound run {name} at the plants' cut: {failed}: {seen} vs "
                                f"{bases[name]}")
            plants["pp_plants" if pipeline else "ep_cp_plants"][name] = {
                "mesh": axes, "n_layers": wl["n_layers"], "caught_by": failed, **seen,
                "base_losses": bases[name][0], "base_grad_norms": bases[name][1],
                "seconds": secs}
    finally:
        shutil.rmtree(d, ignore_errors=True)
    for phase, found in plants.items():
        emit({"phase": phase, "plants": found, "card": smi})
    check(not problems, f"gang_plants: {problems}")


# pp_train: the pipeline (parallel/pipeline.py) on four ranks sharing the
# card over gloo, two gangs at once (eight ranks on the card), each 1 + 3
# steps of 1F1B:
# - dense: the train phase's job (gqa-2048 at full width and depth, b 6,
#   t 2048, flash, save_mid, bf16, AdamW, fixed data) over pp 2 x tp 2, 3
#   microbatches of 2 rows, 6 layers a stage: held to train's first four
#   losses and gradient norms by mesh_verdict. Cut from
#   examples/llama2_70b_pp_tp_v5p256.json (pp 8 x dp 4 x tp 8, 8
#   microbatches): a 70B state does not fit one card.
# - MoE: moe_train's job (moe-small, gmm, top-1, full remat, b 16, t 512)
#   over pp 2 x ep 2, 4 microbatches, each ep rank pipelining its 8 rows.
#   Its load-balance loss is the pipeline's, per microbatch (the JAX
#   package's definition), not moe_train's over the whole batch; through
#   AdamW that moves the router, and the CE of one process with the
#   batch's loss drifts from the gang's by ~2e-3 a step (6.7e-3 at step
#   3 on "NVIDIA H100 80GB HBM3, 700.00 W", PERF.md). So the yardstick is
#   one process of the same job whose lb is recomputed from its router
#   logits by that definition, over the same strided microbatches and ep
#   slices (pp_microbatch_lb; the z-loss's mean is the same either way):
#   the gang's CE terms held to its CE by mesh_verdict (gmm drops
#   nothing), the first step's lb and z to its within
#   MESH_FIRST_LOSS_ATOL. Cut from examples/mixtral_8x7b_pp_ep_v5p256.json
#   (pp 4 x dp 8 x ep 8, gmm, 8 microbatches).
PP_DENSE_AXES = {"pp": 2, "tp": 2}
PP_DENSE_WL = {**TRAIN_WL, "steps": 3, "pp_microbatches": 3, "pp_schedule": "1f1b"}
PP_MOE_AXES = {"pp": 2, "ep": 2}
PP_MOE_WL = {**MOE_WL, "steps": 3, "moe_dispatch": "gmm", "pp_microbatches": 4,
             "pp_schedule": "1f1b"}
# Launches a layer and microbatch under 1F1B: one process's a layer (whose
# step runs the layer once over the whole batch) plus the forward once
# more, the backward's recompute from the saved stage input before
# remat's own replay: K1, and in an MoE layer two K5 and a K6.
PP_1F1B_EXTRA = {"flash_fwd_launches": 1, "gmm_fwd_launches": 2, "gmm_fwd_scaled_launches": 1}
# Every rank of an MoE gang logs each training call's loss terms.
PP_TERMS = """
import json, logging
import torch
import tf_operator_tpu_torch.models.transformer as T
_sound_terms = T.lm_loss_and_metrics
def _terms(*args, **kwargs):
    total, m = _sound_terms(*args, **kwargs)
    if torch.is_grad_enabled():
        logging.getLogger("tpujob.lm").info("pp terms: %s", json.dumps(
            {k: float(m[k]) for k in ("ce_loss", "moe_lb_loss", "moe_z_loss")}))
    return total, m
T.lm_loss_and_metrics = _terms
"""
PP_TERMS_LINE = re.compile(r"pp terms: (\{.*\})")
# Faults planted in the pipeline, on the MoE gang cut to 2 layers (one a
# stage), 1 + 2 steps, beside one sound gang of that cut, run with
# EP_CP_PLANTS (phase_gang_plants): the CE terms of each must fail
# mesh_verdict against one process's run of the cut (with the pipeline's
# lb), and the sound gang's must pass it. The 1F1B backward recomputes
# each tick from the input saved for the unmirrored microbatch (the
# forward's order: with 4 microbatches 0 and 3, 1 and 2 swap); the expert
# leaves' gradients summed over ep, which pp x ep makes a data axis (each
# ep rank holds other experts, so the sum mixes them). The pair is held
# over its first two steps (the first gradient and one update): at 2
# layers the sound gang's bf16 top-1 routing parts from one process's on
# rounding, and its third step reached 5.3e-3 and rel 1.2e-2 against the
# limits' 5e-3 and 1e-2, where its first two sat at 1.3e-3 and 3.5e-4 and
# the expert plant's at 8.6e-2 (loss, step 1) and 7.6e-2 (grad norm, step
# 0), on "NVIDIA H100 80GB HBM3, 700.00 W" (readings repeated bitwise
# across runs, PERF.md).
PP_MOE_CUT_STEPS = 2
PP_MOE_CUT_WL = {**PP_MOE_WL, "steps": 2, "n_layers": 2}
PP_PLANTS = {
    "pp_bwd_unmirrored_input": PP_TERMS + (
        "import tf_operator_tpu_torch.parallel.pipeline as P\n"
        "P._bwd_slot = lambda t, stage, S, M, v: t - (S - 1 - stage)\n"),
    "pp_ep_expert_grads_summed": PP_TERMS + (
        "import tf_operator_tpu_torch.train.trainer as TR\n"
        "_sound_reduce = TR.Trainer._reduce_grads\n"
        "def _planted_reduce(self, params):\n"
        "    _sound_reduce(self, params)\n"
        "    for p, place in zip(params, self._placements_cache):\n"
        "        if 'ep' in [a for part in place for a in TR.split_axes(part)]:\n"
        "            p.grad.copy_(TR.coll.sum_no_grad(p.grad, self.mesh, ('ep',)))\n"
        "TR.Trainer._reduce_grads = _planted_reduce\n"),
}


def pp_microbatch_lb(logits, cfg, batch: int, n_micro: int, n_ep: int):
    """The pipeline's load-balance loss of one layer from its router logits
    [batch·t, E] (f32, differentiable), by the JAX package's definition
    (transformer_hidden_pp, _reduce_aux_rows): for each microbatch (rows
    i, i + M, ... of each ep rank's block of the batch) the load and mean
    gate probability of each ep slice averaged over ep, E·Σ load·gate,
    averaged over the microbatches."""
    rows = batch // n_ep
    lg = logits.reshape(batch, -1, cfg.n_experts)
    total = 0.0
    for i in range(n_micro):
        loads, gates = [], []
        for e in range(n_ep):
            x = lg[e * rows + i:(e + 1) * rows:n_micro].reshape(-1, cfg.n_experts)
            probs, _, top_i = moe_mod._routing(x, cfg.moe_top_k)
            loads.append(torch.bincount(top_i.reshape(-1), minlength=cfg.n_experts).float()
                         / top_i.numel())
            gates.append(probs.mean(dim=0))
        total = total + cfg.n_experts * (torch.stack(loads).mean(0)
                                         * torch.stack(gates).mean(0)).sum()
    return total / n_micro


@contextlib.contextmanager
def recorded_terms(micro=None):
    """Within: each grad-enabled loss's (ce, lb, z) recorded in this
    process; with ``micro`` = (batch, M, ep) every MoE layer's
    load-balance loss is pp_microbatch_lb's (the gang's objective)."""
    import tf_operator_tpu_torch.models.transformer as T

    terms = []
    sound_terms, sound_mlp = T.lm_loss_and_metrics, T._moe_mlp

    def rec_terms(*args, **kwargs):
        total, m = sound_terms(*args, **kwargs)
        if torch.is_grad_enabled():
            terms.append({k: float(m[k]) for k in ("ce_loss", "moe_lb_loss", "moe_z_loss")
                          if k in m})
        return total, m

    def rec_mlp(h, lp, cfg):
        out, aux = sound_mlp(h, lp, cfg)
        logits = (h.reshape(-1, h.shape[-1]) @ lp["w_router"].to(h.dtype)).float()
        return out, {**aux, "lb_loss": pp_microbatch_lb(logits, cfg, *micro)}

    T.lm_loss_and_metrics = rec_terms
    if micro is not None:
        T._moe_mlp = rec_mlp
    try:
        yield terms
    finally:
        T.lm_loss_and_metrics, T._moe_mlp = sound_terms, sound_mlp


def pp_terms_of(texts, phase: str) -> list:
    """Each rank's ``pp terms`` lines: [{ce_loss, moe_lb_loss, moe_z_loss}] a step."""
    out = []
    for r, text in enumerate(texts):
        found = [json.loads(x) for x in PP_TERMS_LINE.findall(text)]
        check(bool(found), f"{phase}: rank {r} logged no pp terms line")
        out.append(found)
    return out


def pp_one_process(wl, axes) -> tuple:
    """One process's run of ``wl`` (its pp keys ignored without a mesh; an
    MoE model with the pipeline's lb over ``axes``' ep slices): (losses,
    grad norms, the recorded terms a step)."""
    torch.cuda.empty_cache()
    micro = (wl["batch_size"], wl["pp_microbatches"], axes.get("ep", 1))
    with recorded_terms(micro if "moe" in wl["preset"] else None) as terms:
        run = run_lm(wl, device="cuda")
    out = run.losses, run.grad_norms, terms
    del run
    torch.cuda.empty_cache()
    return out


def pp_expected(cfg, wl, axes, per_layer) -> dict:
    """A rank's kernel launches a step under 1F1B: per_layer plus
    PP_1F1B_EXTRA, for each of its stage's layers and each microbatch."""
    stage_layers = cfg.n_layers // axes["pp"] // cfg.pp_chunks * cfg.pp_chunks
    return {k: (v + PP_1F1B_EXTRA.get(k, 0)) * stage_layers * wl["pp_microbatches"]
            for k, v in per_layer.items()}


def pp_gang_summary(lines, texts, secs, label, per_step_want, problems: list) -> dict:
    """A gang's figures; a rank whose launches a step are not
    ``per_step_want`` adds to ``problems``."""
    for x in lines:
        got = x["launches_per_step"]
        if got != {k: float(v) for k, v in per_step_want.items()}:
            problems.append(f"{label}: rank {x['rank']} launches a step {got} != "
                            f"{per_step_want}")
    done = harness_result_done(texts[0], f"pp_train {label}")
    return {"step_ms": done["step_ms"], "tokens_per_s": done["tokens_per_s"],
            "pipeline": lines[0]["pipeline"], "per_rank": per_rank(lines),
            "launches_per_rank_per_step": lines[0]["launches_per_step"], "seconds": secs}


def phase_pp_train(smi, base_losses, base_norms):
    """The dense and MoE pipelines on four ranks each, both gangs at once
    (PP_DENSE_*, PP_MOE_*): mesh_verdict of the dense gang against train's
    first four steps, of the MoE gang's CE terms against one process's
    with the pipeline's lb (pp_microbatch_lb; run here while the gangs
    run); the MoE gang's first router terms within MESH_FIRST_LOSS_ATOL of
    that process's; every rank's
    K1-K3 (and K5/K6/K7a/K7b) launches a step equal to pp_expected; K1 at
    8 and 2 heads under tp 2 (the PP_PLANTS run in phase_gang_plants).
    Logs each rank's step ms, host seconds in collectives,
    bytes staged through the host and sent through all_to_all, peak GB and
    the pipeline's bubble fraction (ranks sharing one card: a path check,
    not a scaling figure). The phase's line is printed before its checks
    fail it."""
    dense_cfg = preset_from_workload(PP_DENSE_WL)
    moe_cfg = preset_from_workload(PP_MOE_WL)
    d = gang_dir("pp_train")
    out, problems, one = {}, [], []
    try:
        runs = gangs_checked(d, "pp_train", [("dense", PP_DENSE_AXES, PP_DENSE_WL, ""),
                                             ("moe", PP_MOE_AXES, PP_MOE_WL, PP_TERMS)],
                             meanwhile=lambda: one.extend(pp_one_process(PP_MOE_WL, PP_MOE_AXES)))
        m_losses, m_norms, m_terms = one
        m_ce = [t["ce_loss"] for t in m_terms]
        lines, secs, texts = runs["dense"]
        failed, seen = mesh_verdict(lines, base_losses, base_norms)
        problems += [f"dense: {f}" for f in failed]
        heads = [dense_cfg.n_heads // 2, dense_cfg.n_kv_heads // 2]
        if not all(x["flash_fwd_heads"] == heads for x in lines):
            problems.append(f"dense: K1 heads {[x['flash_fwd_heads'] for x in lines]} != "
                            f"{heads}")
        out["dense"] = {"mesh": PP_DENSE_AXES, **seen, **pp_gang_summary(
            lines, texts, secs, "dense", pp_expected(dense_cfg, PP_DENSE_WL, PP_DENSE_AXES,
                                                     DENSE_PER_LAYER), problems)}
        lines, secs, texts = runs["moe"]
        terms = pp_terms_of(texts, "pp_train moe")
        ce_lines = [{**x, "losses": [t["ce_loss"] for t in tr]} for x, tr in zip(lines, terms)]
        failed, seen = mesh_verdict(ce_lines, m_ce, m_norms)
        first = terms[0][0]
        router = {"lb": first["moe_lb_loss"], "z": first["moe_z_loss"],
                  "recomputed_lb": m_terms[0]["moe_lb_loss"],
                  "recomputed_z": m_terms[0]["moe_z_loss"]}
        for key in ("lb", "z"):
            if abs(router[key] - router["recomputed_" + key]) > MESH_FIRST_LOSS_ATOL:
                failed.append(f"first {key} {router[key]} vs {router['recomputed_' + key]}")
        problems += [f"moe: {f}" for f in failed]
        out["moe"] = {"mesh": PP_MOE_AXES, **seen, "router_first_step": router,
                      "one_process_ce": m_ce, "one_process_losses": m_losses,
                      "one_process_grad_norms": m_norms,
                      **pp_gang_summary(lines, texts, secs, "moe",
                                        pp_expected(moe_cfg, PP_MOE_WL, PP_MOE_AXES,
                                                    MOE_PER_LAYER), problems)}
    finally:
        shutil.rmtree(d, ignore_errors=True)
    emit({"phase": "pp_train", "backend": "gloo", "ranks": 4, "runs": out,
          "train_losses": base_losses[:4], "train_grad_norms": base_norms[:4],
          "problems": problems,
          "note": "four ranks a gang, two gangs share one card over gloo: a path check, "
                  "not a scaling figure", "card": smi})
    check(not problems, f"pp_train: {problems}")
    return {label: r["launches_per_rank_per_step"] for label, r in out.items()}


# gang_resume: checkpoints of a gang on the card, two gangs at once (four
# ranks on the card) through the real harness with the controller's
# warm-restart environment (TPUJOB_CHECKPOINT_DIR, TPUJOB_RESUME_STEP).
# ep_resume: ep_train's gmm job (moe-small at full width and depth, ep 2,
# 1 + 3 steps) saving every 2 steps; rank 1 exits 138 at step 3 (after
# the step-2 save committed: the loop fences it before the exit), rank 0
# on the lost peer; the relaunch resumes both ranks from step 2 and trains
# steps 3 and 4, held to ep_train's losses and gradient norms at those
# steps: bitwise expected (fixed data, deterministic kernels and gloo
# sums), else within the mesh limits.
EP_RESUME_WL = {**EP_WL, "checkpoint_every": 2, "checkpoint_keep": 1, "fail_at_step": 3,
                "fail_rank": 1}
EP_RESUME_FROM = 2
# tp_recut: the train job (gqa-2048 at full width and depth) under tp 2
# for 1 + 2 steps, saving at step 2 (and its final save at step 3), each
# rank logging each written block's sha256. Then this process restores
# step 2 at world 1 (allow_world_resize: every tp-split leaf re-cut from
# its two blocks): each block cut from the restored state must have its
# writer's sha256, and the restored state's next step (step 3: the same
# params, one forward and backward, mesh_train's first-loss case) its
# loss within MESH_FIRST_LOSS_ATOL and gradient norm within
# MESH_GRAD_NORM_RTOL of the gang's step 3. The plant: the same restore
# with the two ranks' block files swapped must fail both (the vocab
# halves of the tied embedding trade places: the loss moves by O(1)).
TP_RECUT_WL = {**TRAIN_WL, "steps": 2, "checkpoint_every": 2, "checkpoint_keep": 2,
               "checkpoint_digests": True}
TP_RECUT_STEP = 2
CKPT_SAVE_LINE = re.compile(r"checkpoint save: (\{.*\})")


def gang_ended(gang, label: str, deadline: float) -> tuple:
    """A started gang's (exit codes, log texts), its ranks reaped by
    ``deadline`` (perf_counter) or the phase fails."""
    procs, paths = gang
    try:
        rcs = [p.wait(timeout=max(1.0, deadline - time.perf_counter())) for p in procs]
    except subprocess.TimeoutExpired:
        stop_gang(procs)
        check(False, f"gang_resume {label}: a rank did not end in time:\n"
              + "\n".join(p.read_text()[-2000:] for p in paths))
    return rcs, [p.read_text() for p in paths]


def save_lines(texts) -> list:
    """Each rank's ``checkpoint save`` lines (one a committed save)."""
    return [[json.loads(x) for x in CKPT_SAVE_LINE.findall(t)] for t in texts]


def recut_block_digests(state, manifest) -> dict:
    """{block file: sha256} of every block of ``manifest`` cut from the
    whole leaves of ``state`` (the writer's block bytes, on the host)."""
    sizes = dict(zip(manifest["mesh"]["axes"], manifest["mesh"]["shape"]))
    leaves = ckpt_mod._flatten(ckpt_mod._to_tree(state))
    out = {}
    for (path, leaf), rec in zip(leaves, manifest["leaves"]):
        check(path == rec["path"], f"tp_recut: leaf {path} vs the manifest's {rec['path']}")
        counts = block_counts(sizes, rec["placement"])
        for b in rec["blocks"]:
            piece = leaf[block_slices(rec["shape"], counts, b["index"])]
            host = piece.contiguous().cpu().numpy() if isinstance(piece, torch.Tensor) \
                else np.ascontiguousarray(piece)
            out[b["file"]] = hashlib.sha256(memoryview(host.reshape(-1).view(np.uint8))
                                            ).hexdigest()
    return out


def tp_recut_check(ckpt_dir: Path, wl: dict, lines: list, dev="cuda") -> dict:
    """tp_recut's one-process half (see TP_RECUT_WL): the sound re-cut
    and the swapped plant, each restored, digested and stepped."""
    cfg = preset_from_workload(wl)
    step_dir = ckpt_dir / f"step_{TP_RECUT_STEP}"
    manifest = json.loads((step_dir / "manifest.json").read_text())
    logged = {}
    for x in lines:
        save = [s for s in x["checkpoint"]["saves"] if s["step"] == TP_RECUT_STEP]
        check(len(save) == 1, f"tp_recut: rank {x['rank']} logged no step-2 save")
        logged.update(save[0]["digests"])
    files = {b["file"] for rec in manifest["leaves"] for b in rec["blocks"]}
    check(set(logged) == files, f"tp_recut: the ranks logged {len(logged)} block digests, "
          f"the manifest lists {len(files)} blocks")
    gang_loss = lines[0]["losses"][TP_RECUT_STEP]
    gang_norm = lines[0]["grad_norms"][TP_RECUT_STEP]
    tokens = fixed_tokens(wl["batch_size"], wl["seq_len"], cfg.vocab, dev)
    trainer = lm_trainer(wl, cfg, resolve_device(dev))

    def recut(label):
        mgr = ckpt_mod.CheckpointManager(ckpt_dir, readonly=True, world_size=1,
                                         allow_world_resize=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        state = mgr.restore(trainer.state_template(), step=TP_RECUT_STEP, device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        check(mgr.last_restore["recut"], f"tp_recut {label}: the restore did not re-cut")
        got = recut_block_digests(state, manifest)
        state.params = tree_map(lambda p: p.requires_grad_(True), state.params)
        state, m = trainer.step(state, tokens)
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        peak = torch.cuda.max_memory_allocated() / 1e9
        del state, m
        torch.cuda.empty_cache()
        bad = sorted(f for f in files if got[f] != logged[f])
        return {"restore_s": restore_s, "blocks_read": mgr.last_restore["blocks_read"],
                "bytes_read": mgr.last_restore["bytes_read"], "digests_differing": len(bad),
                "loss": loss, "loss_abs_diff": abs(loss - gang_loss), "grad_norm": norm,
                "grad_norm_rel_diff": abs(norm - gang_norm) / gang_norm, "peak_gb": peak}

    sound = recut("sound")
    check(sound["digests_differing"] == 0, f"tp_recut: re-cut digests differ: {sound}")
    check(sound["loss_abs_diff"] <= MESH_FIRST_LOSS_ATOL
          and sound["grad_norm_rel_diff"] <= MESH_GRAD_NORM_RTOL,
          f"tp_recut: world-1 step {TP_RECUT_STEP + 1} {sound} vs the gang's loss "
          f"{gang_loss}, grad norm {gang_norm}")
    swapped = 0
    for rec in manifest["leaves"]:
        if len(rec["blocks"]) == 2:  # a tp-split leaf: rank 0's block and rank 1's
            a, b = (step_dir / x["file"] for x in rec["blocks"])
            a.rename(step_dir / "swap.npy")
            b.rename(a)
            (step_dir / "swap.npy").rename(b)
            swapped += 1
    plant = recut("plant")
    check(plant["digests_differing"] > 0 and plant["loss_abs_diff"] > MESH_FIRST_LOSS_ATOL,
          f"tp_recut: the swapped blocks were not caught: {plant}")
    return {"gang_loss": gang_loss, "gang_grad_norm": gang_norm, "sound": sound,
            "plant": {**plant, "leaves_swapped": swapped}, "blocks": len(files),
            "loss_limit": MESH_FIRST_LOSS_ATOL, "grad_norm_rtol": MESH_GRAD_NORM_RTOL}


def ckpt_figures(x: dict, saves: list) -> dict:
    """A rank's checkpoint figures from its rank line and save lines."""
    restore = (x.get("checkpoint") or {}).get("restore") or {}
    return {"rank": x["rank"], "peak_gb": x["peak_gb"], "step_ms": x["step_ms"],
            "restore_s": restore.get("s"), "restore_recut": restore.get("recut"),
            "saves": [{"step": s["step"], "stall_ms": s["stall_s"] * 1e3,
                       "blocks": s["blocks"], "bytes": s["bytes"], "drain_s": s["drain_s"],
                       "commit_s": s["commit_s"]} for s in saves]}


def phase_gang_resume(smi, ep_losses, ep_norms):
    """ep_resume and tp_recut (see EP_RESUME_WL and TP_RECUT_WL), started
    at once; ep_resume's relaunch runs beside tp_recut's one-process half.
    Each rank's save stall, blocks and bytes written, drain and commit
    seconds, restore seconds and peak GB are logged; each gang's K1-K3
    (and ep_resume's K5-K7b) launches a step must be one process's."""
    spec = json.loads(NORTHSTAR_SPEC.read_text())
    ep_cfg, tp_cfg = preset_from_workload(EP_RESUME_WL), preset_from_workload(TP_RECUT_WL)
    # f32 params and two moments: tp's two steps, ep's step 2 and step 4
    need = 12 * 2 * (ep_cfg.n_params() + tp_cfg.n_params()) + (1 << 30)
    d = ckpt_dir_with_room("gang_resume", need)
    ep_ckpt, tp_ckpt = d / "ep_ckpt", d / "tp_ckpt"
    ep_wl = {**EP_RESUME_WL, "checkpoint_dir": str(ep_ckpt), "fail_marker": str(d / "died")}
    tp_wl = {**TP_RECUT_WL, "checkpoint_dir": str(tp_ckpt)}
    for sub in ("ep1", "ep2", "tp"):
        (d / sub).mkdir()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    deadline = t0 + 600
    started = []
    try:
        ep1 = start_gang(spec, ep_wl, 2, {"ep": 2}, d / "ep1", GLOO_ENV, ckpt_dir=ep_ckpt)
        started.append(ep1)
        tp = start_gang(spec, tp_wl, 2, {"tp": 2}, d / "tp", GLOO_ENV, ckpt_dir=tp_ckpt)
        started.append(tp)
        rcs1, texts1 = gang_ended(ep1, "ep_resume first incarnation", deadline)
        ep1_s = time.perf_counter() - t0
        check(rcs1 == [138, 138], f"gang_resume ep_resume: first incarnation exit codes "
              f"{rcs1}:\n" + "\n".join(t[-3000:] for t in texts1))
        check("fault injection: requesting retry at step 3" in texts1[1],
              "gang_resume ep_resume: rank 1 did not die at step 3")
        at_restart = ckpt_mod.latest_checkpoint_step(str(ep_ckpt))
        check(at_restart == EP_RESUME_FROM and
              ckpt_mod.checkpoint_world_size(str(ep_ckpt), at_restart) == 2,
              f"gang_resume ep_resume: latest step {at_restart} at the restart")
        t2 = time.perf_counter()
        ep2 = start_gang(spec, ep_wl, 2, {"ep": 2}, d / "ep2", GLOO_ENV, ckpt_dir=ep_ckpt)
        started.append(ep2)
        rcs_tp, tp_texts = gang_ended(tp, "tp_recut", deadline)
        tp_s = time.perf_counter() - t0
        check(rcs_tp == [0, 0], f"gang_resume tp_recut: exit codes {rcs_tp}:\n"
              + "\n".join(t[-3000:] for t in tp_texts))
        tp_lines = rank_lines(tp_texts, "gang_resume tp_recut")
        recut = tp_recut_check(tp_ckpt, tp_wl, tp_lines)
        rcs2, texts2 = gang_ended(ep2, "ep_resume relaunch", deadline)
        ep2_s = time.perf_counter() - t2
        check(rcs2 == [0, 0], f"gang_resume ep_resume: relaunch exit codes {rcs2}:\n"
              + "\n".join(t[-3000:] for t in texts2))
    finally:
        for gang in started:
            stop_gang(gang[0])
    try:
        for r, text in enumerate(texts2):
            for want in (f"warm restart: controller-declared resume step {EP_RESUME_FROM}",
                         f"resumed from checkpoint at step {EP_RESUME_FROM}"):
                check(want in text, f"gang_resume ep_resume: rank {r} logged no '{want}'")
        ep_lines = rank_lines(texts2, "gang_resume ep_resume")
        n = EP_WL["steps"] + 1 - EP_RESUME_FROM
        want_l, want_n = ep_losses[EP_RESUME_FROM:], ep_norms[EP_RESUME_FROM:]
        loss_diff = [abs(a - b) for a, b in zip(ep_lines[0]["losses"], want_l)]
        norm_rel = [abs(a - b) / b for a, b in zip(ep_lines[0]["grad_norms"], want_n)]
        check(len(loss_diff) == len(norm_rel) == n and max(loss_diff) <= MESH_LOSS_ATOL
              and max(norm_rel) <= MESH_GRAD_NORM_RTOL,
              f"gang_resume ep_resume: losses {ep_lines[0]['losses']} and grad norms "
              f"{ep_lines[0]['grad_norms']} vs ep_train's {want_l}, {want_n}")
        check(len({x["replicated_sha256"] for x in ep_lines}) == 1,
              "gang_resume ep_resume: the ranks' replicated leaves differ")
        for label, lines, cfg, steps, per_layer in (
                ("ep_resume", ep_lines, ep_cfg, n, MOE_PER_LAYER),
                ("tp_recut", tp_lines, tp_cfg, TP_RECUT_WL["steps"] + 1, DENSE_PER_LAYER)):
            want = {k: v * cfg.n_layers * steps for k, v in per_layer.items()}
            for x in lines:
                got = {k: x["launches"][k] for k in want}
                check(got == want, f"gang_resume {label}: rank {x['rank']} launches {got} "
                      f"!= {want}")
        ep_saves = [a + b for a, b in zip(save_lines(texts1), save_lines(texts2))]
        check(all([s["step"] for s in x] == [EP_RESUME_FROM, EP_WL["steps"] + 1]
                  for x in ep_saves), f"gang_resume ep_resume: saves {ep_saves}")
        tp_saves = save_lines(tp_texts)
        check(all([s["step"] for s in x] == [TP_RECUT_STEP, TP_RECUT_WL["steps"] + 1]
                  for x in tp_saves), f"gang_resume tp_recut: saves {tp_saves}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    emit({"phase": "gang_resume", "backend": "gloo", "ranks": 2,
          "ep_resume": {"preset": EP_WL["preset"], "mesh": {"ep": 2},
                        "resumed_from": at_restart, "exit_codes": [rcs1, rcs2],
                        "losses": ep_lines[0]["losses"], "grad_norms": ep_lines[0]["grad_norms"],
                        "ep_train_losses": want_l, "ep_train_grad_norms": want_n,
                        "loss_abs_diff": loss_diff, "grad_norm_rel_diff": norm_rel,
                        "bitwise": max(loss_diff) == 0 and max(norm_rel) == 0,
                        "per_rank": [ckpt_figures(x, s) for x, s in zip(ep_lines, ep_saves)],
                        "incarnation_s": [ep1_s, ep2_s]},
          "tp_recut": {"preset": TP_RECUT_WL["preset"], "mesh": {"tp": 2}, **recut,
                       "per_rank": [ckpt_figures(x, s) for x, s in zip(tp_lines, tp_saves)],
                       "gang_s": tp_s},
          "note": "four ranks share one card over gloo: a path check, not a scaling figure",
          "card": smi})
    return {"ep_resume": {k: v / n for k, v in ep_lines[0]["launches"].items()},
            "tp_recut": {k: v / (TP_RECUT_WL["steps"] + 1)
                         for k, v in tp_lines[0]["launches"].items()}}


def harness_result_done(text: str, phase: str) -> dict:
    """The last ``lm done`` line of a worker log: step ms and tokens/s."""
    done = HARNESS_DONE.findall(text)
    check(bool(done), f"{phase}: no lm done line:\n{text[-3000:]}")
    return {"step_ms": float(done[-1][2]), "tokens_per_s": float(done[-1][3])}


def phase_resnet_dp(smi, fused_losses):
    """Two ranks share the card over gloo and train ResNet-50 fused_1x1
    through the harness under dp 2, the global batch of resnet_train split
    in two, 1 + 3 steps: the losses within RESNET_AGREE_RTOL of
    resnet_train's first four; the BN running
    statistics agree bitwise across the ranks (one digest); K8 launched 36
    times a step on each rank."""
    spec = json.loads(RESNET_SPEC.read_text())
    cfg = replace(ResNetConfig.resnet50(int(RESNET_DP_WL["num_classes"])), fused_1x1=True)
    per_step = len(fused_1x1_shapes(cfg, RESNET_DP_WL["batch_size"] // 2,
                                    RESNET_DP_WL["image_size"]))
    n_steps = RESNET_DP_WL["steps"] + 1
    d = gang_dir("resnet_dp")
    try:
        torch.cuda.empty_cache()
        rcs, secs, texts = run_gang(spec, RESNET_DP_WL, 2, {"dp": 2}, d, GLOO_ENV,
                                    timeout=900)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    check(rcs == [0, 0], "resnet_dp: exit codes " + str(rcs) + ":\n"
          + "\n".join(t[-3000:] for t in texts))
    lines = rank_lines(texts, "resnet_dp")
    losses = lines[0]["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[:RESNET_AGREE_STEPS], fused_losses)]
    check(len(losses) == n_steps and max(rel) <= RESNET_AGREE_RTOL,
          f"resnet_dp: losses {losses} vs resnet_train's {fused_losses[:RESNET_AGREE_STEPS]}")
    check(lines[0]["bn_state_sha256"] == lines[1]["bn_state_sha256"],
          "resnet_dp: the ranks' BN running statistics differ")
    for x in lines:
        check(x["fused_linear_stats_launches"] == per_step * n_steps,
              f"resnet_dp: rank {x['rank']} K8 launches {x['fused_linear_stats_launches']} "
              f"!= {per_step} x {n_steps}")
    measured = lines[0]["fused_linear_stats_launches"] / n_steps
    emit({"phase": "resnet_dp", "mesh": {"dp": 2}, "backend": "gloo",
          "batch": RESNET_DP_WL["batch_size"], "image": RESNET_DP_WL["image_size"],
          "losses": losses, "resnet_train_losses": fused_losses[:RESNET_AGREE_STEPS],
          "loss_rel_diff": rel, "rtol": RESNET_AGREE_RTOL,
          "bn_state_sha256": lines[0]["bn_state_sha256"],
          "k8_launches_per_rank_per_step": measured,
          "per_rank": [{k: x[k] for k in ("rank", "step_ms", "collective_s", "collective_calls",
                                          "staged_bytes", "peak_gb")} for x in lines],
          "seconds": secs,
          "note": "two ranks share one card over gloo: a path check, not a scaling figure",
          "card": smi})
    return measured


def phase_gang_peer_loss(smi):
    """Two ranks of tiny LM on the card through the harness; once both
    have joined and trained a moment, rank 1 is killed (SIGKILL). Rank 0's
    next collective finds the peer gone: it must exit 138 (the harness's
    retryable exit, which the controller answers with a gang restart)
    within DIST_TIMEOUT_S of the kill, not hang."""
    import signal

    spec = json.loads(NORTHSTAR_SPEC.read_text())
    d = gang_dir("gang_peer_loss")
    procs, paths = start_gang(spec, PEER_LOSS_WL, 2, {"dp": 2}, d,
                              {**GLOO_ENV, "OMP_NUM_THREADS": "1"})
    try:
        t0 = time.perf_counter()
        while not all("joined the gang" in p.read_text() for p in paths):
            check(all(p.poll() is None for p in procs) and time.perf_counter() - t0 < 300,
                  "gang_peer_loss: the ranks did not join:\n"
                  + "\n".join(p.read_text()[-2000:] for p in paths))
            time.sleep(0.2)
        time.sleep(5.0)  # both train: tiny's steps take milliseconds
        check(all(p.poll() is None for p in procs), "gang_peer_loss: a rank ended early:\n"
              + "\n".join(p.read_text()[-2000:] for p in paths))
        t_kill = time.perf_counter()
        os.kill(procs[1].pid, signal.SIGKILL)
        try:
            rc0 = procs[0].wait(timeout=DIST_TIMEOUT_S + 30)
        except subprocess.TimeoutExpired:
            rc0 = None
        exit_s = time.perf_counter() - t_kill
        rc1 = procs[1].wait()
        text0 = paths[0].read_text()
    finally:
        stop_gang(procs)
        shutil.rmtree(d, ignore_errors=True)
    check(rc0 == 138 and exit_s <= DIST_TIMEOUT_S,
          f"gang_peer_loss: rank 0 exit {rc0} {exit_s:.1f} s after the kill:\n{text0[-3000:]}")
    check("lost a peer of the gang (retryable)" in text0,
          f"gang_peer_loss: rank 0 did not log the lost peer:\n{text0[-3000:]}")
    reason = [ln for ln in text0.splitlines() if "lost a peer of the gang" in ln][-1]
    emit({"phase": "gang_peer_loss", "rank0_exit": rc0, "rank1_exit": rc1,
          "rank0_exit_s_after_kill": exit_s, "timeout_s": DIST_TIMEOUT_S,
          "rank0_reason": reason[-300:], "card": smi})


def phase_jax_trajectory(dev, smi, artifact=trajectory.ARTIFACT, phase="jax_trajectory"):
    """A model at full width and depth in f32 (TF32 off) through K1-K3,
    from the numpy-seeded init and batch that ``artifact`` records (and,
    for a masked LM, JAX's mask by its positions), the port's remat as the
    artifact names it: 1 + 3 AdamW steps, each loss within the artifact's
    limit of the JAX package's (computed on a CPU,
    tests/test_torch_trajectory.py)."""
    art = json.loads((REPO / artifact).read_text())
    cfg = trajectory.trajectory_config(art["preset"], remat=art["port"]["remat"])
    params = init_transformer_numpy(cfg, art["init_seed"])
    head = params["embed"].reshape(-1)[:8].tolist()
    check(head == art["init_stream_head"], f"{phase}: init stream {head} differs")
    sums = {"embed": float(np.sum(params["embed"], dtype=np.float64)),
            **{f"layers.{k}": float(np.sum(v, dtype=np.float64))
               for k, v in params["layers"].items()}}
    bad = [k for k, v in art["init_sums"].items() if not math.isclose(sums[k], v, rel_tol=1e-9,
                                                                         abs_tol=1e-6)]
    check(not bad, f"{phase}: init sums differ: {bad}")
    tokens = trajectory.trajectory_tokens(cfg.vocab, art["batch_size"], art["seq_len"],
                                          art["batch_seed"])
    check(tokens[0, :16].tolist() == art["first_batch_head"]
          and int(tokens.sum(dtype=np.int64)) == art["first_batch_sum"],
          f"{phase}: the batch differs from the artifact's")
    mask = None if cfg.causal else trajectory.trajectory_mask(tokens.shape,
                                                              art["mask_positions"])
    torch.cuda.empty_cache()
    reset_counts()
    losses = trajectory.port_trajectory(cfg, params, tokens, art["steps"], device=dev, mask=mask)
    counts = read_counts()
    want = {name: DENSE_PER_LAYER.get(name, 0) * cfg.n_layers * art["steps"]
            for name in COUNTERS}
    check(counts == want, f"{phase} launches {counts} != {want}")
    diffs = [abs(a - b) for a, b in zip(losses, art["jax_losses"])]
    check(max(diffs) <= art["card_limit"],
          f"{phase}: losses {losses} vs JAX {art['jax_losses']} "
          f"(limit {art['card_limit']})")
    emit({"phase": phase, "preset": art["preset"], "dtype": "float32",
          "tf32": torch.backends.cuda.matmul.allow_tf32, "batch": art["batch_size"],
          "seq": art["seq_len"], "causal": cfg.causal, "remat": cfg.remat,
          "masked_positions": None if mask is None else int(mask.sum()), "losses": losses,
          "jax_losses": art["jax_losses"], "abs_diff": diffs, "limit": art["card_limit"],
          "launches": counts, "card": smi})


# ---------------------------------------------------------------------------
# the input pipeline and the Evaluator
# ---------------------------------------------------------------------------


def phase_data_memmap(smi, dev="cuda"):
    """gqa-2048 at full width and depth through run_lm with ``data:
    memmap``: a corpus of CORPUS_TOKENS uint16 tokens written from
    DATA_SEED, its last HOLDOUT_WINDOWS windows held out. The first
    DATA_CHECKED batches that arrive on the card are byte-equal (by
    sha256) to TokenMemmapDataset's own for the same seed; the flash
    kernels run 2·L / L / L times a step; the copies ran on the loader's
    stream, not the consumer's. Then 2 steps profiled on loader batches,
    and ``data: stream`` for 1 + 2 steps with the same launch check.
    Returns the memmap workload (eval_live scores its corpus) and the
    corpus's directory, which the caller removes."""
    d = ckpt_dir_with_room("data_memmap", 2 * CORPUS_TOKENS + (1 << 30))
    try:
        return _data_memmap(smi, dev, d)
    except BaseException:
        shutil.rmtree(d, ignore_errors=True)
        raise


def _data_memmap(smi, dev, d):
    from tf_operator_tpu_torch.train.data import TokenMemmapDataset, write_token_corpus
    from tf_operator_tpu_torch.workloads.lm import lm_loader

    corpus = str(d / "corpus.bin")
    cfg = preset_from_workload(TRAIN_WL)
    t0 = time.perf_counter()
    write_token_corpus(corpus, np.random.default_rng(DATA_SEED).integers(
        0, cfg.vocab, CORPUS_TOKENS, dtype=np.uint16))
    corpus_s = time.perf_counter() - t0
    wl = {**TRAIN_WL, "data": "memmap", "corpus": corpus, "holdout_windows": HOLDOUT_WINDOWS}
    arrived = []

    def tap(tokens):
        if len(arrived) < DATA_CHECKED:
            arrived.append(tokens.clone())  # on the consumer's stream, after the copy

    torch.cuda.empty_cache()
    reset_counts()
    run = run_lm(wl, device=dev, on_batch=tap)
    torch.cuda.synchronize()
    counts = read_counts()
    L, n = run.cfg.n_layers, len(run.losses)
    want = {name: DENSE_PER_LAYER.get(name, 0) * L * n for name in COUNTERS}
    check(counts == want, f"data_memmap launches {counts} != {want}")
    check(all(np.isfinite(run.losses)), f"data_memmap: non-finite loss: {run.losses}")
    ds = TokenMemmapDataset(corpus, wl["batch_size"], wl["seq_len"], holdout=HOLDOUT_WINDOWS)
    host = [b["tokens"] for _, b in zip(range(DATA_CHECKED), ds)]
    card_sha = [hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest() for t in arrived]
    host_sha = [hashlib.sha256(np.ascontiguousarray(h).tobytes()).hexdigest() for h in host]
    check(len(arrived) == DATA_CHECKED and card_sha == host_sha and arrived[0].dtype ==
          torch.int32, f"data_memmap: card batches {card_sha} != the dataset's {host_sha}")
    data = run.data
    compute_stream = torch.cuda.current_stream(dev).stream_id
    check(data["copy_stream"] is not None and data["copy_stream"] != data["consumer_stream"]
          and data["consumer_stream"] == compute_stream,
          f"data_memmap: copies on stream {data['copy_stream']}, steps on "
          f"{data['consumer_stream']} (compute stream {compute_stream})")
    check(data["delivered"] == n, f"data_memmap: {data['delivered']} batches for {n} steps")
    loader = lm_loader(wl, run.cfg, dev, skip=n)
    try:
        brk = phase_train_breakdown(run, smi, phase="data_memmap_breakdown",
                                    pull=lambda: next(loader)["tokens"].long())
    finally:
        loader.close()
    emit({"phase": "data_memmap", "preset": wl["preset"], "batch": wl["batch_size"],
          "seq": wl["seq_len"], "corpus_tokens": CORPUS_TOKENS, "corpus_dtype": "uint16",
          "holdout_windows": HOLDOUT_WINDOWS, "corpus_write_s": corpus_s,
          "steps": n, "timed_steps": run.timed, "losses": run.losses, "launches": counts,
          "launches_per_step": {k: v / n for k, v in counts.items()},
          "batches_checked": DATA_CHECKED, "batch_sha256": card_sha, "bytes_equal": True,
          "step_ms": run.step_s * 1e3, "tokens_per_s": run.tokens_per_s,
          "mfu_exact": run.mfu(run.flops_exact), "mfu_6nd": run.mfu(run.flops_6nd),
          "device_busy_ms_per_step": brk["device_busy_ms_per_step"],
          "device_idle_share": brk["device_idle_share"], "loader": data,
          "copy_stream_is_compute_stream": False, "card": smi})
    del run, loader
    torch.cuda.empty_cache()
    stream_wl = {**TRAIN_WL, "data": "stream", "steps": 2}
    reset_counts()
    srun = run_lm(stream_wl, device=dev)
    torch.cuda.synchronize()
    counts = read_counts()
    n = len(srun.losses)
    want = {name: DENSE_PER_LAYER.get(name, 0) * L * n for name in COUNTERS}
    check(counts == want, f"data_stream launches {counts} != {want}")
    check(all(np.isfinite(srun.losses)), f"data_stream: non-finite loss: {srun.losses}")
    check(srun.data["copy_stream"] != srun.data["consumer_stream"],
          f"data_stream: copies on the consumer's stream: {srun.data}")
    emit({"phase": "data_stream", "steps": n, "losses": srun.losses, "launches": counts,
          "step_ms": srun.step_s * 1e3, "tokens_per_s": srun.tokens_per_s,
          "loader": srun.data, "card": smi})
    del srun
    torch.cuda.empty_cache()
    return wl, d


EVAL_TIMING = re.compile(r"eval timing: step=(\d+) restore_s=([\d.]+) score_s=([\d.]+) "
                         r"value=(\S+) flash_fwd_launches=(\d+) flash_bwd_dq_launches=(\d+) "
                         r"flash_bwd_dkv_launches=(\d+)")


def phase_eval_live(smi, memmap_wl, dev="cuda"):
    """The north-star spec on data_memmap's corpus (EVAL_LIVE_OVERRIDES:
    10 steps, a checkpoint every 4 kept 3 deep), with the Evaluator
    (``tf_operator_tpu_torch.workloads.eval:main``) launched through the
    real harness as the operator's Evaluator replica before the trainer
    and before any checkpoint exists, then the trainer through the
    harness as operator_resume runs it. Both exit 0; the report holds
    every saved step, oldest first, each CE finite; the evaluator launched
    K1 n_layers x eval_batches times a scored checkpoint and no K2 or K3;
    the last step's CE is held to a recompute here through K1's plain
    version on the same holdout batches, within EVAL_CE_ATOL."""
    from tf_operator_tpu_torch.workloads.eval import lm_scorer

    spec = json.loads(NORTHSTAR_SPEC.read_text())
    cfg = preset_from_workload(spec["spec"]["workload"])
    d = ckpt_dir_with_room("eval_live", 3 * 12 * cfg.n_params() + (1 << 30))
    ckpt = d / "ckpt"
    report = d / "eval_report.json"
    wl = {**spec["spec"]["workload"], **EVAL_LIVE_OVERRIDES,
          "corpus": memmap_wl["corpus"], "holdout_windows": memmap_wl["holdout_windows"],
          "checkpoint_dir": str(ckpt), "eval_report": str(report)}
    torch.cuda.empty_cache()
    try:
        eval_log, train_log = d / "evaluator-0.log", d / "worker-0.log"
        t0 = time.perf_counter()
        with open(eval_log, "w") as out:
            evaluator = subprocess.Popen(
                [sys.executable, "-m", "tf_operator_tpu.rendezvous.harness"],
                env=harness_env(spec, wl, ckpt, replica_type="Evaluator",
                                entrypoint="tf_operator_tpu_torch.workloads.eval:main"),
                cwd=REPO, stdout=out, stderr=subprocess.STDOUT)
        try:
            check(not ckpt.exists() or not os.listdir(ckpt),
                  "eval_live: a checkpoint existed before the evaluator started")
            train_log.write_text("")
            rc_train, train_s = run_harness(spec, wl, ckpt, train_log)
            rc_eval = evaluator.wait(timeout=600)
        finally:
            if evaluator.poll() is None:
                evaluator.kill()
                evaluator.wait()
        eval_s = time.perf_counter() - t0
        text = train_log.read_text()
        etext = eval_log.read_text()
        check(rc_train == 0, f"eval_live: trainer exit {rc_train}:\n{text[-3000:]}")
        check(rc_eval == 0, f"eval_live: evaluator exit {rc_eval}:\n{etext[-3000:]}")
        trained = harness_result(text, "eval_live")
        saved = ckpt_mod.CheckpointManager(str(ckpt), readonly=True).all_steps()
        check(saved == list(EVAL_LIVE_STEPS), f"eval_live: saved steps {saved}")
        steps_run = EVAL_LIVE_STEPS[-1]
        want = {k: v * cfg.n_layers * steps_run for k, v in DENSE_PER_LAYER.items()}
        check(trained["launches"] == want, f"eval_live: trainer launches {trained['launches']}")
        scored = json.loads(report.read_text())
        check([int(k) for k in scored] == saved and all(math.isfinite(v) for v in
                                                      scored.values()),
              f"eval_live: report {scored} against saved steps {saved}")
        lines = EVAL_TIMING.findall(etext)
        per_ckpt = {int(st): {"restore_s": float(r), "score_s": float(sc),
                              "launches": [int(f), int(q), int(k)]}
                    for st, r, sc, _, f, q, k in lines}
        want_eval = [cfg.n_layers * wl["eval_batches"], 0, 0]
        check(sorted(per_ckpt) == saved and all(v["launches"] == want_eval
                                                 for v in per_ckpt.values()),
              f"eval_live: evaluator launches {per_ckpt}, want {want_eval} a checkpoint")
        last = saved[-1]
        templates, score, _ = lm_scorer(wl, dev)
        restored = ckpt_mod.CheckpointManager(str(ckpt), readonly=True).restore_subtrees(
            templates, step=last, device=dev)
        reset_counts()
        with plain_kernels():
            plain_ce, _ = score(restored)
        check(not any(read_counts().values()), "eval_live: the recompute launched kernels")
        diff = abs(scored[str(last)] - plain_ce)
        check(diff <= EVAL_CE_ATOL, f"eval_live: step {last} CE {scored[str(last)]} vs "
                                    f"plain {plain_ce} (limit {EVAL_CE_ATOL})")
        del restored, templates
    finally:
        shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    emit({"phase": "eval_live", "spec": str(NORTHSTAR_SPEC.relative_to(REPO)),
          "overrides": EVAL_LIVE_OVERRIDES, "exit_codes": {"trainer": rc_train,
                                                           "evaluator": rc_eval},
          "saved_steps": saved, "report": scored, "per_checkpoint": per_ckpt,
          "evaluator_launches_per_checkpoint_want": want_eval,
          "last_step_ce_plain": plain_ce, "last_step_ce_abs_diff": diff,
          "limit": EVAL_CE_ATOL, "trainer": trained, "trainer_s": train_s,
          "evaluator_s": eval_s, "card": smi})


def idx_fixture(d: Path) -> Path:
    """MNIST-geometry idx files (28x28 uint8) from DATA_SEED: REAL_TRAIN
    train and REAL_TEST test images, labels 0-9 drawn at random."""
    from tf_operator_tpu_torch.train.data import write_idx

    rng = np.random.default_rng(DATA_SEED)
    d.mkdir(parents=True, exist_ok=True)
    for prefix, n in (("train", REAL_TRAIN), ("t10k", REAL_TEST)):
        write_idx(str(d / f"{prefix}-images-idx3-ubyte"),
                  rng.integers(0, 256, (n, 28, 28), dtype=np.uint8))
        write_idx(str(d / f"{prefix}-labels-idx1-ubyte"),
                  rng.integers(0, 10, n, dtype=np.uint8))
    return d


def phase_resnet_real(smi, dev="cuda"):
    """The real-image path (train_real) at ResNet-50 width and depth with
    the workload of examples/resnet_real_idx_h100.json (224^2 from 28x28 x8,
    b 256, crop padding 16, no flip, 10 classes, lr 0.1, augmented) on a
    seeded idx fixture, one epoch, fused_1x1 through cfg: K8 exactly 36
    times a step; the native augmenter served every batch the loader
    staged; finite losses; the test accuracy in [0, 1] and the same when
    rescored with eval_b 64 and 100. Then 2 steps on loader batches
    profiled."""
    from tf_operator_tpu_torch.train import data as data_mod
    from tf_operator_tpu_torch.workloads.resnet import (
        make_test_accuracy,
        resnet_config_from_workload,
        test_split,
        train_real,
    )

    spec = json.loads(REAL_SPEC.read_text())
    d = ckpt_dir_with_room("resnet_real", 4 << 30)
    try:
        data_dir = idx_fixture(d / "mnist")
        wl = {k: v for k, v in spec["spec"]["workload"].items()
              if not k.startswith("checkpoint_")}
        wl.update(RESNET_REAL_OVERRIDES, data_dir=str(data_dir))
        cfg = replace(resnet_config_from_workload(wl), fused_1x1=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        data_mod.native_augment_batches = 0
        run = train_real(wl, device=dev, cfg=cfg)
        counts = read_counts()
        native = data_mod.native_augment_batches
        steps = len(run.losses)
        per_step = len(fused_1x1_shapes(cfg, wl["batch_size"], wl["image_size"]))
        want = {name: 0 for name in COUNTERS}
        want["fused_linear_stats_launches"] = per_step * steps
        check(counts == want, f"resnet_real launches {counts} != {want}")
        check(steps == REAL_TRAIN // wl["batch_size"], f"resnet_real: {steps} steps")
        check(native == run.data["staged"] >= steps,
              f"resnet_real: native augmenter served {native} of {run.data['staged']} "
              f"staged batches")
        check(all(np.isfinite(run.losses)), f"resnet_real: non-finite loss: {run.losses}")
        images, labels = test_split(wl["data_dir"], wl["image_size"])
        scorer = make_test_accuracy(cfg)
        rescored = {eval_b: scorer(run.state.params, run.state.extra, images, labels, eval_b)
                    for eval_b in (64, 100)}
        check(0.0 <= run.accuracy <= 1.0 and rescored[64] == rescored[100] == run.accuracy,
              f"resnet_real: accuracy {run.accuracy}, rescored {rescored}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ds = data_mod.MnistIdxDataset(wl["data_dir"], wl["batch_size"], seed=1)
        ds.arrays["image"] = data_mod.prepare_classification_images(ds.arrays["image"],
                                                                    wl["image_size"])
        loader = data_mod.DeviceLoader(data_mod.AugmentedImages(
            ds, pad=wl["crop_padding"], flip=wl["flip"], seed=1), dev)

        def pull():
            b = next(loader)
            return b["image"], b["label"].long()

        try:
            brk = phase_train_breakdown(run, smi, phase="resnet_real_breakdown", pull=pull)
        finally:
            loader.close()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    emit({"phase": "resnet_real", "variant": wl["variant"], "fused_1x1": True,
          "batch": wl["batch_size"], "image": wl["image_size"],
          "train_images": REAL_TRAIN, "test_images": REAL_TEST, "epochs": wl["epochs"],
          "steps": steps, "losses": run.losses, "launches": counts,
          "fls_launches_per_step": counts["fused_linear_stats_launches"] / steps,
          "native_augment_batches": native, "loader": run.data,
          "stager_host_ms_per_batch": run.data["source_ms"] + run.data["pin_ms"],
          "step_ms": run.step_s * 1e3, "images_per_s": run.images_per_s, "mfu": run.mfu(),
          "accuracy": run.accuracy, "accuracy_rescored": rescored, "eval_s": run.eval_s,
          "device_busy_ms_per_step": brk["device_busy_ms_per_step"],
          "device_idle_share": brk["device_idle_share"],
          "device_idle_share_without_htod": brk["device_idle_share_without_htod"],
          "peak_mem_gb": peak_gb, "card": smi})


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
                             "const bool live0 = row < M, live1 = row + 8 < M;",
                             "const bool live0 = row < M && m0 + kBM < M, "
                             "live1 = row + 8 < M && m0 + kBM < M;"),
    # the statistics of the bf16-rounded y instead of the f32 sums
    "stats_from_rounded_y": ("fls", "fused_linear_stats.cu",
                             "const float y0 = live0 ? acc[i] : 0.f, "
                             "y1 = live1 ? acc[i + 2] : 0.f;",
                             "const float y0 = live0 ? __bfloat162float(__float2bfloat16("
                             "acc[i])) : 0.f, y1 = live1 ? __bfloat162float("
                             "__float2bfloat16(acc[i + 2])) : 0.f;"),
    # the prologue applies the affine without the ReLU
    "prologue_no_relu": ("fls", "fused_linear_stats.cu",
                         "return fmaxf(__fmaf_rn(v, a, b), 0.f);",
                         "return __fmaf_rn(v, a, b);"),
    # x's K-major descriptors step 16 bytes along the swizzled row a depth
    # step of 16, not 32
    "x_k_step": ("fls", "fused_linear_stats.cu",
                 "const uint64_t ad = hopper::kmajor_desc(a + k * 32);",
                 "const uint64_t ad = hopper::kmajor_desc(a + k * 16);"),
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
    kernel; the loss finite, and with fused_1x1 lower after the first
    update. The fused run's losses are held to the unfused run's over the
    first steps by phase_resnet_agreement. (At lr 0.1 on one fixed batch
    the loss swings after a few steps, and where the ninth step lands
    depends on rounding alone: on an H100 the unfused yardstick rose from
    7.06 to 12.59 and the fused path through K8's plain version to 15.94,
    while K8 designs that differ only in their sums' rounding ended both
    below the first loss and far above it (tools/fls_decode_variants.py
    --resnet, PERF.md). Over the first four steps every one of them was
    within 0.43% of the unfused run.)"""
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
    if fused:  # the path under test; the unfused run is its yardstick (resnet_agreement)
        check(run.losses[1] < run.losses[0], f"loss did not fall: {run.losses}")
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


def phase_resnet_forward_check(run):
    """resnet_train's first forward through K8 and through its plain
    version (RESNET_FWD_STATE_RTOL's comment). Launches here are not the
    main path's."""
    init = run.trainer.init(0)  # the params and BN state run_resnet starts from
    with torch.no_grad():
        loss_k, state_k = resnet_loss(init.params, run.batch, init.extra, run.cfg)
        with plain_fls():
            loss_p, state_p = resnet_loss(init.params, run.batch, init.extra, run.cfg)
    loss_err = abs(float(loss_k) - float(loss_p))
    state_rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                    for a, b in zip(tree_leaves(state_k), tree_leaves(state_p)))
    emit({"phase": "resnet_forward_check", "loss_k8": float(loss_k), "loss_plain": float(loss_p),
          "loss_abs_diff": loss_err, "loss_atol": PARITY_BF16_FIRST_STEP_ATOL,
          "bn_state_rel_diff": state_rel, "bn_state_rtol": RESNET_FWD_STATE_RTOL})
    check(loss_err <= PARITY_BF16_FIRST_STEP_ATOL,
          f"resnet_forward_check: loss {float(loss_k)} vs plain {float(loss_p)}")
    check(state_rel <= RESNET_FWD_STATE_RTOL,
          f"resnet_forward_check: BN state {state_rel} of its largest")


def resnet_disagreement(fused_losses, unfused_losses) -> list[float]:
    """|fused - unfused| / |unfused| at each of the first
    RESNET_AGREE_STEPS steps."""
    return [abs(a - b) / abs(b) for a, b in
            zip(fused_losses[:RESNET_AGREE_STEPS], unfused_losses[:RESNET_AGREE_STEPS])]


def phase_resnet_agreement(fused_losses, unfused_losses):
    """resnet_train's fused losses against the unfused yardstick's over the
    first RESNET_AGREE_STEPS steps, within RESNET_AGREE_RTOL."""
    rel = resnet_disagreement(fused_losses, unfused_losses)
    check(len(rel) == RESNET_AGREE_STEPS and max(rel) <= RESNET_AGREE_RTOL,
          f"fused losses {fused_losses[:RESNET_AGREE_STEPS]} not within "
          f"{RESNET_AGREE_RTOL} of the unfused {unfused_losses[:RESNET_AGREE_STEPS]}")
    emit({"phase": "resnet_agreement", "steps": RESNET_AGREE_STEPS, "rtol": RESNET_AGREE_RTOL,
          "fused": fused_losses[:RESNET_AGREE_STEPS],
          "unfused": unfused_losses[:RESNET_AGREE_STEPS], "rel_diff": rel})


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


# K8's instantiations, fls_kernel<T, BN, PRO>: bf16 (the path's) and f32,
# 128- and 64-column tiles, with and without the prologue.
FLS_INSTANCES = {f"{t}_bn{bn}{pro_key}": f"fls_kernelI{piece}Li{bn}ELb{pro}E"
                 for t, piece in (("bf16", "13__nv_bfloat16"), ("f32", "f"))
                 for bn in (128, 64) for pro, pro_key in ((0, ""), (1, "_prologue"))}


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
    build = tma_build_facts("fused_linear_stats", FLS_INSTANCES)
    emit({"phase": "fls_timing", "dtype": "bfloat16", "batch": RESNET_WL["batch_size"],
          "image": RESNET_WL["image_size"],
          "yardsticks": "mm: torch.mm(x, w), the product alone; mm_plus_reductions: "
                        "torch.mm(out_dtype=f32), its column sum and sum of squares and the "
                        "bf16 cast of y; no one PyTorch call computes K8's function",
          "per_step": step, "top3_by_step_time": per_shape[:3], "shapes": per_shape,
          "build": build, "card": smi})
    return step


# ---------------------------------------------------------------------------
# elastic gangs: a shrink and a re-grow on the card, the reconciler played
# ---------------------------------------------------------------------------

ELASTIC_ENTRY = "tf_operator_tpu_torch.workloads.elastic:main"
ELASTIC_JOB = "elastic-h100"
ELASTIC_MEMBERS = 3
# The elastic soak's data plane (workloads/elastic.py) with its device
# state on the card: 480 windows at 0.02 s a window (a member consumes
# ~8 a second at 0.05 s with the directive poll, the row's device-to-host
# copy and the row store's fsync, on "NVIDIA H100 80GB HBM3, 700.00 W";
# the two survivors still hold windows when the re-grown member has
# started, ~9 s after its relaunch),
# a checkpoint every 10 windows consumed by the chief, seed 12 (the soak's
# recorded run). Worker 2 is killed after the first committed checkpoint,
# the gang shrinks to two (epoch 1) and re-grows to three (epoch 2).
ELASTIC_WL = {"total_windows": 480, "step_sleep_s": 0.02, "data_seed": 12,
              "checkpoint_every": 10, "checkpoint_backend": "npy", "elastic": True,
              "device_state": True, "device": "cuda"}
ELASTIC_TIMEOUT_S = 150
ELASTIC_MEMBER_LINE = re.compile(r"elastic member: (\{.*\})")
ELASTIC_RESTORED = re.compile(r"re-grown member restored step (\d+) \(source=(\w+)\)")
# The planted row update: the form ATen's CUDA kernels compile to a fused
# multiply-add (ROW_DECAY * row + ROW_LR * w rounded once), where the
# members round ROW_LR * w first, as the JAX package's jitted update does.
ELASTIC_PLANT = "torch.add(ROW_DECAY * row, w, alpha=ROW_LR)"

# The reconciler's part, in a process of its own (as the harness runs in
# its own): the operator's object store and API server (the JAX package's
# control plane, which imports no jax) holding the TPUJob, the three
# members launched through the harness with TPUJOB_API_SERVER, worker 2
# SIGKILLed after the first committed checkpoint, the shrink directive
# written (the shape of controller/reconciler.py's shrink), the chief's
# barrier awaited, worker 2 relaunched with TPUJOB_RESIZE_EPOCH and the
# grow directive written (the reconciler's re-grow: create, then the
# directive). argv[1]: a JSON file with the job name, entrypoint,
# workload, each member's environment, the log and checkpoint
# directories. Prints one ``conductor`` JSON line.
ELASTIC_CONDUCTOR = r"""
import importlib, json, os, signal, subprocess, sys, time
cfg = json.load(open(sys.argv[1]))
api = importlib.import_module("tf_operator_tpu.api.types")
runtime = importlib.import_module("tf_operator_tpu.runtime")
dashboard = importlib.import_module("tf_operator_tpu.dashboard")
name, ckpt, n = cfg["job"], cfg["checkpoint_dir"], len(cfg["envs"])
store = runtime.Store()
server = dashboard.DashboardServer(store, host="127.0.0.1", port=0)
server.start()
job = api.TPUJob(metadata=api.ObjectMeta(name=name), spec=api.TPUJobSpec(replica_specs={
    api.ReplicaType.WORKER: api.ReplicaSpec(replicas=n, template=api.ProcessTemplate(
        entrypoint=cfg["entrypoint"]))}))
job.spec.run_policy.elastic = True
job.spec.workload = cfg["workload"]
store.create(job)
members = [f"{name}-worker-{i}" for i in range(n)]
procs, killed, out, t0 = {}, set(), {"directives": []}, time.perf_counter()


def launch(i, epoch=0):
    env = dict(cfg["envs"][i], TPUJOB_API_SERVER=server.url)
    if epoch:
        env["TPUJOB_RESIZE_EPOCH"] = str(epoch)
    with open(os.path.join(cfg["log_dir"], f"worker-{i}.log"), "a") as log:
        procs[i] = subprocess.Popen([sys.executable, "-m", "tf_operator_tpu.rendezvous.harness"],
                                    env=env, cwd=cfg["cwd"], stdout=log,
                                    stderr=subprocess.STDOUT)


def direct(epoch, direction, live):
    d = {"epoch": epoch, "direction": direction, "world_size": len(live),
         "members": list(live), "time": time.time()}

    def mutate(j):
        j.status.resize_epoch = epoch
        j.status.resize_count += 1
        j.status.world_size = len(live)
        j.status.resize_directive = d

    store.update_with_retry("TPUJob", "default", name, mutate)
    out["directives"].append({**d, "at_s": time.perf_counter() - t0})


def directive():
    return dict(store.get("TPUJob", "default", name).status.resize_directive or {})


def steps():
    if not os.path.isdir(ckpt):
        return []
    return sorted(int(x[5:]) for x in os.listdir(ckpt) if x.startswith("step_")
                  and os.path.exists(os.path.join(ckpt, x, "manifest.json")))


def wait(cond, what, limit):
    end = time.perf_counter() + limit
    while not cond():
        for i, p in procs.items():
            if p not in killed and p.poll() not in (None, 0):
                raise RuntimeError(f"worker {i} exited {p.returncode} waiting for {what}")
        if time.perf_counter() > end:
            raise TimeoutError(f"no {what} within {limit} s")
        time.sleep(0.02)
    out[what.replace(" ", "_") + "_s"] = time.perf_counter() - t0


try:
    for i in range(n):
        launch(i)
    wait(lambda: bool(steps()), "first commit", cfg["timeout_s"])
    out["first_commit_step"] = steps()[0]
    procs[n - 1].send_signal(signal.SIGKILL)
    killed.add(procs[n - 1])
    out["killed_rc"] = procs[n - 1].wait()
    direct(1, "shrink", members[:-1])
    wait(lambda: "boundary_remaining" in directive(), "shrink barrier", cfg["timeout_s"])
    out["shrink_barrier"] = directive()
    launch(n - 1, epoch=2)
    direct(2, "grow", members)
    wait(lambda: all(p.poll() is not None for p in procs.values()), "members done",
         cfg["timeout_s"])
    out["exit_codes"] = [procs[i].returncode for i in range(n)]
    out["grow_barrier"] = directive()
except Exception as exc:
    out["error"] = f"{type(exc).__name__}: {exc}"
finally:
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()
    server.stop()
out["seconds"] = time.perf_counter() - t0
out["jax_loaded"] = any(m == "jax" or m.startswith("jax.") for m in sys.modules)
print("conductor " + json.dumps(out), flush=True)
"""


def elastic_expected(total: int, seed: int, dev="cpu") -> tuple:
    """The uninterrupted run's eval digest and params digest (the port's
    expected_params on ``dev``)."""
    order = data_mod.elastic_global_order(total, seed=seed)
    digest = elastic_mod._digest([{"p": p, "w": int(order[p])} for p in range(total)], total)
    params = reshard.expected_params(total, reshard.PARAM_DIM, seed, order, device=dev)
    return digest, params


def elastic_plant(total: int, seed: int, dev) -> np.ndarray:
    """expected_params through the planted row update (ELASTIC_PLANT)."""
    sound = reshard.row_update

    def fused(row, mom, w):
        step = reshard.ROW_LR * w
        return torch.add(reshard.ROW_DECAY * row, w, alpha=reshard.ROW_LR), \
            step * torch.ones_like(mom)

    reshard.row_update = fused
    try:
        return elastic_expected(total, seed, dev)[1]
    finally:
        reshard.row_update = sound


def phase_elastic_resize(smi, dev="cuda"):
    """An elastic job of three members on the card (ELASTIC_WL: the
    reshard model's params and momentum on cuda), through the harness, the
    reconciler played by ELASTIC_CONDUCTOR: a kill after the first commit,
    a shrink, a relaunch and a re-grow. Every member exits 0; the eval
    digest is the uninterrupted order's; the params digest is the port's
    expected_params on the CPU (held to the JAX package's by
    tests/test_torch_reshard.py); the chief's plan re-laid, re-fetched and
    inited rows; the re-grown member restored from disk (no agents' shard
    depots run here: the peer path is the CPU soak's gate) and every
    member's rows lived on the card. First, in this process,
    expected_params on the card must give the CPU's digest, and through
    the planted row update (ELASTIC_PLANT) must not."""
    t0 = time.perf_counter()
    total, seed = ELASTIC_WL["total_windows"], ELASTIC_WL["data_seed"]
    want_digest, want_params = elastic_expected(total, seed)
    want = reshard.params_digest(want_params)
    # the card rounds the row update as the CPU does; the fused form not
    card = elastic_expected(total, seed, dev)[1]
    check(reshard.params_digest(card) == want,
          "elastic_resize: expected_params on the card differs from the CPU's")
    planted = elastic_plant(total, seed, dev)
    caught = reshard.params_digest(planted) != want
    check(caught, f"elastic_resize: the planted row update ({ELASTIC_PLANT}) gave the "
          "sound digest")
    rows_changed = int((planted != want_params).any(axis=1).sum())
    d = gang_dir("elastic_resize")
    logs = d / "logs"
    logs.mkdir()
    wl = {**ELASTIC_WL, "workdir": str(d / "gang"), "checkpoint_dir": str(d / "ckpt")}
    spec = {"metadata": {"name": ELASTIC_JOB},
            "spec": {"replica_specs": {"Worker": {"template": {
                "entrypoint": ELASTIC_ENTRY, "chips_per_process": 1}}}, "topology": {}}}
    cfg = {"job": ELASTIC_JOB, "entrypoint": ELASTIC_ENTRY, "workload": wl,
           "envs": [gang_env(spec, wl, i, ELASTIC_MEMBERS, "localhost:0", {}, {})
                    for i in range(ELASTIC_MEMBERS)],
           "log_dir": str(logs), "checkpoint_dir": wl["checkpoint_dir"], "cwd": str(REPO),
           "timeout_s": ELASTIC_TIMEOUT_S}
    (d / "conductor.json").write_text(json.dumps(cfg))
    try:
        proc = subprocess.run([sys.executable, "-c", ELASTIC_CONDUCTOR, str(d / "conductor.json")],
                              cwd=REPO, env=cfg["envs"][0], capture_output=True, text=True,
                              timeout=4 * ELASTIC_TIMEOUT_S)
        texts = [(logs / f"worker-{i}.log").read_text() for i in range(ELASTIC_MEMBERS)]
        tail = "\n".join(t[-2000:] for t in texts)
        found = re.findall(r"^conductor (\{.*\})$", proc.stdout, re.M)
        check(proc.returncode == 0 and bool(found),
              f"elastic_resize: conductor exit {proc.returncode}:\n{proc.stdout[-2000:]}"
              f"{proc.stderr[-3000:]}\n{tail}")
        run = json.loads(found[-1])
        check("error" not in run, f"elastic_resize: {run.get('error')}: {run}\n{tail}")
        check(not run["jax_loaded"], "elastic_resize: the conductor loaded jax")
        check(run["exit_codes"] == [0] * ELASTIC_MEMBERS and run["killed_rc"] == -9,
              f"elastic_resize: exit codes {run['exit_codes']}, killed {run['killed_rc']}:\n"
              f"{tail}")
        done = json.loads((d / "gang" / "done.json").read_text())
        check(done["digest"] == want_digest,
              f"elastic_resize: eval digest {done['digest']} != uninterrupted {want_digest}")
        check(done["params_digest"] == want,
              f"elastic_resize: params digest {done['params_digest']} != expected {want}")
        plan = done["reshard"]
        check(min(plan["relaid"], plan["refetched"], plan["inited"]) >= 1,
              f"elastic_resize: the chief's plan {plan}")
        lines = [json.loads(ELASTIC_MEMBER_LINE.findall(t)[-1]) for t in texts
                 if ELASTIC_MEMBER_LINE.findall(t)]
        check(len(lines) == ELASTIC_MEMBERS, f"elastic_resize: member lines {lines}\n{tail}")
        check(done["device"].startswith("cuda")
              and all(str(x["device"]).startswith("cuda") for x in lines),
              f"elastic_resize: rows not on the card: {done['device']}, {lines}")
        restored = ELASTIC_RESTORED.findall(texts[-1])
        check(bool(restored) and restored[-1][1] == "disk"
              and lines[-1]["restore_source"] == "disk",
              f"elastic_resize: re-grown member's restore {restored}, {lines[-1]}")
        check(sum(x["consumed"] for x in lines) <= total, f"elastic_resize: {lines}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    emit({"phase": "elastic_resize", "members": ELASTIC_MEMBERS, "workload": ELASTIC_WL,
          "exit_codes": run["exit_codes"], "killed_rc": run["killed_rc"],
          "first_commit_step": run["first_commit_step"], "directives": run["directives"],
          "shrink_barrier": run["shrink_barrier"], "eval_digest_equal": True,
          "params_digest": done["params_digest"], "reshard": plan, "member_lines": lines,
          "restored": {"step": int(restored[-1][0]), "source": restored[-1][1]},
          "device": done["device"], "card_expected_equals_cpu": True,
          "plant": {"form": ELASTIC_PLANT, "caught": caught, "rows_changed": rows_changed},
          "conductor_s": run["seconds"],
          "conductor_marks_s": {k: v for k, v in run.items() if k.endswith("_s")},
          "seconds": time.perf_counter() - t0, "card": smi})


# ---------------------------------------------------------------------------
# MNIST: the operator's dist_mnist analogue
# ---------------------------------------------------------------------------

# The workload's synthetic mode at examples/mnist_dp.json's width (hidden
# 128, batch 256, 30 steps); f32 with TF32 off on both sides, so the card
# and the CPU part only by sum order: a [256, 784] x [784, 128] product
# sums 784 terms (~sqrt(784) * 2^-24 relative, ~1e-6 of a logit), the CE
# ~2.3, and two SGD updates at lr 0.1 barely grow it; 1e-4 is ~50x that.
MNIST_WL = {"steps": 30, "batch_size": 256, "hidden": 128, "lr": 0.1}
MNIST_CHECKED = 3
MNIST_LOSS_ATOL = 1e-4
# the idx path on idx_fixture's random images and labels (2,048 / 512):
# 2 epochs of 8 steps; its accuracy is logged, not gated
MNIST_IDX_WL = {"epochs": 2, "batch_size": 256, "hidden": 128, "lr": 0.1}


def phase_mnist_train(smi, dev="cuda"):
    """workloads/mnist.py in process on the card: the synthetic mode's
    first MNIST_CHECKED losses against the port's CPU run within
    MNIST_LOSS_ATOL and the loss falling (run_mnist raises otherwise);
    then the idx path through MnistIdxDataset and the DeviceLoader on a
    seeded write_idx fixture, its test accuracy logged."""
    t0 = time.perf_counter()
    cpu = mnist_mod.run_mnist(MNIST_WL, device="cpu")
    t1 = time.perf_counter()
    card = mnist_mod.run_mnist(MNIST_WL, device=dev)
    card_s = time.perf_counter() - t1
    diffs = [abs(a - b) for a, b in zip(card.losses[:MNIST_CHECKED], cpu.losses)]
    check(all(np.isfinite(card.losses)) and max(diffs) <= MNIST_LOSS_ATOL,
          f"mnist_train: card losses {card.losses[:MNIST_CHECKED]} vs CPU "
          f"{cpu.losses[:MNIST_CHECKED]} (limit {MNIST_LOSS_ATOL})")
    check(all(t.is_cuda for pair in card.params for t in pair), "mnist_train: params off the card")
    d = CKPT_ROOT / "mnist"
    try:
        shutil.rmtree(d, ignore_errors=True)
        t2 = time.perf_counter()
        real = mnist_mod.run_mnist({**MNIST_IDX_WL, "data_dir": str(idx_fixture(d))}, device=dev)
        real_s = time.perf_counter() - t2
    finally:
        shutil.rmtree(d, ignore_errors=True)
    check(all(np.isfinite(real.losses)) and 0.0 <= real.accuracy <= 1.0,
          f"mnist_train: idx run losses {real.losses[-3:]}, accuracy {real.accuracy}")
    emit({"phase": "mnist_train", "workload": MNIST_WL, "losses": card.losses,
          "cpu_losses": cpu.losses[:MNIST_CHECKED], "loss_abs_diff": diffs,
          "limit": MNIST_LOSS_ATOL, "card_s": card_s,
          "idx": {**MNIST_IDX_WL, "train": REAL_TRAIN, "test": real.test_n, "steps": real.steps,
                  "accuracy": real.accuracy, "final_loss": real.losses[-1], "seconds": real_s,
                  "note": "random labels: the accuracy is logged, not gated"},
          "seconds": time.perf_counter() - t0, "card": smi})


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
    run_phase("decode_plant", phase_decode_plant, dev)
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
    torch.cuda.empty_cache()
    run_phase("train_parity", phase_train_parity, dev)
    ft = run_phase("flash_timing", phase_flash_timing, smi)
    run_phase("ckpt_roundtrip", phase_ckpt_roundtrip, run, smi)
    train_losses, train_norms, train_step_ms = run.losses, run.grad_norms, run.step_s * 1e3
    del run
    torch.cuda.empty_cache()
    run_phase("operator_resume", phase_operator_resume, smi, train_losses)
    # multi-process training: the gang's ranks through the harness
    run_phase("dist_smoke", phase_dist_smoke, smi)
    run_phase("nccl_world1", phase_nccl_world1, smi, train_losses, train_norms, train_step_ms,
              dev)
    torch.cuda.empty_cache()
    mesh_counts, cut_base = run_phase("mesh_train", phase_mesh_train, smi, train_losses,
                                      train_norms, train_step_ms)
    # the peer-loss gang (tiny, mostly waiting) runs beside cp_train's
    peer = beside(run_phase, "gang_peer_loss", phase_gang_peer_loss, smi)
    cp_runs = run_phase("cp_train", phase_cp_train, smi, *cut_base)
    peer()
    # an elastic job, a member lost and re-grown (the reconciler played):
    # its members are light (their time is start-up, the directive polls
    # and the row store's fsyncs) and run beside the in-process trajectory
    # and remat phases, which write nothing to disk
    elastic = beside(run_phase, "elastic_resize", phase_elastic_resize, smi, dev)
    run_phase("jax_trajectory", phase_jax_trajectory, dev, smi)
    run_phase("jax_trajectory_bert", phase_jax_trajectory, dev, smi, trajectory.BERT_ARTIFACT,
              phase="jax_trajectory_bert")
    # the remat policies at the north star's shape, and the other new paths
    # at small size against the CPU
    run_phase("remat_policies", phase_remat_policies, smi, dev)
    elastic()
    torch.cuda.empty_cache()
    for name, wl in REMAT_PARITY:
        run_phase(name, phase_train_parity, dev, wl, phase=name)
    # BERT-base's masked LM: K1-K3 non-causal at d 64
    bert_counts = run_phase("bert_train", phase_bert_train, smi, dev)
    torch.cuda.empty_cache()
    run_phase("train_parity_bert", phase_train_parity, dev, bert_wl(),
              phase="train_parity_bert")
    # the input pipeline and the Evaluator on the same model
    memmap_wl, corpus_dir = run_phase("data_memmap", phase_data_memmap, smi, dev)
    try:
        run_phase("eval_live", phase_eval_live, smi, memmap_wl, dev)
    finally:
        shutil.rmtree(corpus_dir, ignore_errors=True)

    # MoE training path: moe-small
    gmm_err = run_phase("gmm_check", phase_gmm_check, dev)
    run_phase("gmm_plant", phase_gmm_plant, dev)
    torch.cuda.empty_cache()
    moe_run, moe_counts = run_phase("moe_train", phase_train, smi, MOE_WL,
                                    per_layer=MOE_PER_LAYER, phase="moe_train")
    moe_bd = run_phase("moe_train_breakdown", phase_train_breakdown, moe_run, smi,
                       phase="moe_train_breakdown")
    gmm_yardstick = {"step_ms": moe_run.step_s * 1e3, "tokens_per_s": moe_run.tokens_per_s,
                     "busy_ms": moe_bd["device_busy_ms_per_step"],
                     "idle_share": moe_bd["device_idle_share"], "drop_frac": 0.0}
    moe_losses, moe_norms = moe_run.losses, moe_run.grad_norms
    del moe_run
    torch.cuda.empty_cache()
    # expert parallelism on two ranks, then the ep and cp planted faults
    ep_counts, ep_losses, ep_norms = run_phase("ep_train", phase_ep_train, smi, moe_losses,
                                               moe_norms)
    # checkpoints of a gang: a warm gang restart and a re-cut to one process
    resume_counts = run_phase("gang_resume", phase_gang_resume, smi, ep_losses, ep_norms)
    # pipeline parallelism: four ranks a gang, dense and MoE at once
    pp_counts = run_phase("pp_train", phase_pp_train, smi, train_losses, train_norms)
    # the ep, cp and pp planted faults beside their sound runs, all at once
    run_phase("gang_plants", phase_gang_plants, smi)
    torch.cuda.empty_cache()
    run_phase("moe_parity", phase_train_parity, dev, MOE_WL, per_layer=MOE_PER_LAYER,
              phase="moe_parity", bf16_atol=PARITY_MOE_BF16_LOSS_ATOL)
    # the other MoE dispatches: sort, einsum, ragged
    run_phase("moe_dispatch", phase_moe_dispatch, smi, gmm_yardstick, dev)
    torch.cuda.empty_cache()
    run_phase("moe_layer_check", phase_moe_layer_check, dev)
    torch.cuda.empty_cache()
    for name, wl in DISPATCH_PARITY:
        run_phase(name, phase_train_parity, dev, wl, phase=name,
                  bf16_atol=PARITY_MOE_BF16_LOSS_ATOL)
    gt = run_phase("gmm_timing", phase_gmm_timing, smi)

    # ResNet training path: ResNet-50
    torch.cuda.empty_cache()
    fls_err, fls_ratio = run_phase("fls_check", phase_fls_check, dev)
    run_phase("fls_plant", phase_fls_plant, dev)
    torch.cuda.empty_cache()
    resnet_run, resnet_counts = run_phase("resnet_train", phase_resnet_train, smi)
    run_phase("resnet_breakdown", phase_resnet_breakdown, resnet_run, smi)
    run_phase("resnet_forward_check", phase_resnet_forward_check, resnet_run)
    fused_losses = resnet_run.losses
    del resnet_run
    torch.cuda.empty_cache()
    unfused_run, _ = run_phase("resnet_train_unfused", phase_resnet_train, smi, fused=False,
                               phase="resnet_train_unfused")
    run_phase("resnet_agreement", phase_resnet_agreement, fused_losses, unfused_run.losses)
    dp_k8 = run_phase("resnet_dp", phase_resnet_dp, smi, fused_losses)
    # the yardstick's device time: the host clock moves with the host
    run_phase("resnet_breakdown_unfused", phase_train_breakdown, unfused_run, smi,
              phase="resnet_breakdown_unfused", batch=unfused_run.batch)
    del unfused_run
    torch.cuda.empty_cache()
    run_phase("resnet_real", phase_resnet_real, smi, dev)
    torch.cuda.empty_cache()
    run_phase("mnist_train", phase_mnist_train, smi, dev)
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
        # 8 sequences at 1024-4096 positions (kernel_timing's long_context)
        "long_context": {x: timing["long_context"][x] for x in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")},
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
            # the masked LM's run (non-causal, d 64)
            "bert_train_launches": bert_counts[counter],
            # a rank's launches a step on two ranks under each mesh
            "mesh_train_launches_per_rank_per_step": {m: c[counter]
                                                      for m, c in mesh_counts.items()},
            # each rank's under cp 2 (ring: rank r runs r + 1 hops a layer)
            "cp_train_launches_per_rank_per_step": {
                impl: {rank: c[counter] for rank, c in r["launches_per_step"].items()}
                for impl, r in cp_runs.items()},
            "ep_train_launches_per_rank_per_step": ep_counts[counter],
            # a rank's under the 1F1B pipeline (pp 2 x tp 2 dense, pp 2 x ep 2 MoE)
            "pp_train_launches_per_rank_per_step": {g: c[counter]
                                                    for g, c in pp_counts.items()},
            # a rank's after the warm gang restart (ep_resume) and under tp 2
            # beside its re-cut (tp_recut)
            "gang_resume_launches_per_rank_per_step": {
                g: c[counter] for g, c in resume_counts.items()},
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
            # a rank's launches a step on two ranks under ep 2 (gmm), and
            # after their warm gang restart
            "ep_train_launches_per_rank_per_step": ep_counts[counter],
            # a rank's under the 1F1B pipeline over pp 2 x ep 2
            "pp_train_launches_per_rank_per_step": {"moe": pp_counts["moe"][counter]},
            "gang_resume_launches_per_rank_per_step": {
                "ep_resume": resume_counts["ep_resume"][counter]},
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
        # a rank's launches a step on two ranks under dp 2 (64 images each)
        "resnet_dp_launches_per_rank_per_step": dp_k8,
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
