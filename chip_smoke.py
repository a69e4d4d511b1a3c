#!/usr/bin/env python3
"""Drive the PyTorch port of MP-HSIR on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--out results.json] [--bwd-split KERNEL] [--mlp-bwd-split] [--wgrad]
                          [--train-cli] [--eval-cli] [--f32-eval] [--mesh-eval]
                          [--mesh-cards] [--mesh-train] [--mesh-tp]

Phases (any failure exits non-zero; no phase's error is caught):

1. Environment: the card's name and power limit (nvidia-smi), then the build
   of mp_hsir_tpu_torch/csrc/*.cu with nvcc (one process per source), each
   kernel's registers and spills, the bf16 spectral apply tile's plan bytes
   at every preset width, and the bf16 spectral stats tile's at every (C,
   heads) of the presets beside the float32 kernel's, and the GDFN tiles'
   registers and spills (the float32 tile beside the bf16 tile) and plans at
   every width of the presets' GDFN calls and at 27, 54 and 400 (the bf16
   tile's beside the float32 tile's, each float32 plan checked against its
   mirror, gdfn_f32_plan), and the bf16 MLP backward tile's at every width of
   the presets' train steps beside the float32 backward's, and the bf16
   spectral stats and window-attention backwards' two tiles each (their
   registers and spills, their plan bytes at every (C, heads) of the
   presets' train steps beside the float32 kernel's), and the bf16 spectral
   apply backward's two tiles (their registers and spills, their plan bytes
   at every width of the presets' train steps beside the float32 kernel's),
   and the bf16 GDFN backward's two tiles (their registers and spills, their
   plan bytes at every width of the presets' train steps beside the float32
   kernel's), and the registers and spills of the bf16 weight product's 16
   instances (copy widths of A and B) beside the guard of K10a's stencil tile
   dwconv_dx_tc_kernel<true, false, false> (<= 128 registers, no spills),
   K10b's instance <true, true, false> and K11's <true, true, true>; the
   float32 tail tile's kernels' registers and spills (mlp_f32_kernel and
   the float32 apply tile), and the float32 apply (with the tail) and mlp
   plans at every tail width and C = 400, beside the plans of the SIMT tail
   the tile replaced; the float32
   conv3 and window tiles' registers and spills (every instance) beside the
   bf16 tiles', the float32 window plan at every (C, heads) of the presets'
   window calls (with its ring stages and blocks per window) beside the bf16
   tile's and the SIMT kernel's it replaced, and conv3's float32 plan beside
   its bf16 and SIMT ones; the float32 stats tile's registers and spills
   beside the bf16 tile's, and its plan at every (C, heads) of the presets'
   stats calls and at 36/2, 27/3 and 400/8 beside the SIMT kernel's it
   replaced, each checked against its mirror (stats_f32_plan); the float32
   apply tile's registers and spills beside the bf16 tile's, and its plan
   at every (C, tail) of the presets' apply calls and at 27, 36, 54 and 400
   with and without the tail beside the SIMT front's it replaced, each
   checked against its mirror (apply_f32_plan).
2. Kernel checks: every kernel wrapper on the card at each shape the
   flagship 512x512x31 eval forward gives it, in bf16 from numpy-seeded
   inputs, against its plain PyTorch version on the same inputs; also once
   per shape in float32. Tolerances: bf16 max|kernel - plain| <= 3e-2 *
   max|plain| (a few bf16 ulps at the output's scale: both sides round at
   the same points, float32 sums in other orders can flip a rounding);
   float32 <= 1e-4 * max|plain|. Times each with CUDA events, beside the
   plain version, F.conv2d for the conv (library_ms) and the bound
   max(bytes / 3.35 TB/s, flops / 989 TFLOP/s); each conv3, window_attention,
   spectral_stats, spectral_apply, gdfn and mlp call (here and in phases 5, 7
   and 11) is also timed as its kernel alone (the weights packed once, the C
   entry launched directly) and prints its achieved TFLOP/s, the kernel
   alone's and its library call's (flops / ms); their sums over the path's
   calls follow the table. Each spectral_apply call with the PGSSTB tail is
   timed once more on the same inputs without it (through the wrapper and
   alone, with the front's own bound and TFLOP/s): the sums split the apply
   time into the front and the tail; the calls without the tail
   (PromptFusion, the training route's drop-path call) are fronts alone.
   An older checkout's float32 GDFN kernel keeps its input resident where
   that fits (its float32 stats kernel too: there each spectral_stats
   call at C > 64 is checked and timed once more on its float32 instance,
   resident and with its input streamed in 64-channel chunks, summed per
   forward). The window kernel and the spectral stats, apply and GDFN tiles
   stage their whole input in bf16 and have no chunk to stream; the float32
   stats, apply and GDFN tiles stream it in 32-channel chunks at every
   width. Each call's
   float32 instance is timed too (wrapper, alone, plain, F.conv2d with TF32
   off for conv3) beside its float32 bound max(bytes / 3.35 TB/s, 3 flops /
   495 TFLOP/s: 3xTF32), each float32 apply call with the tail once more
   without it; per forward the float32 sums per kernel, the apply's front
   / tail split (the tail: the float32 tail tile, 3xTF32) and the apply
   fronts (the float32 apply tile: the PGSSTB calls' fronts and the
   PromptFusion calls apart) beside their bounds; each float32 call of the
   tail, conv3, window, stats, apply and GDFN tiles is first run twice:
   bitwise equal. Then a float32 spectral apply with the tail and a float32
   mlp call at C = 400 (the tail tile in two output groups, the apply tile
   in two comb passes), float32 stats calls at 400/8, 36/2, 27/3 and the
   PromptFusion entry at 18 + 18, float32 apply calls at 36 and 54
   (shifted, with the tail), 27 and the PromptFusion entry at 27 + 27, and
   float32 gdfn calls at 54 and 27 (residual, exit 1x1) and 400 (residual,
   two output groups) (each one stats, apply or GDFN tile launch, no plain
   call), against plain (1e-4).
3. Main path: the flagship preset on the committed trained weights, bf16 at
   1x31x512x512, answering 4 requests (mode-0 cubes) after a warm-up. The
   launch counters are zeroed just before the requests and read just after;
   each kernel must have launched its expected count and no plain version
   may have run on a CUDA tensor. Restored PSNR must beat the degraded
   input by >= 3 dB; the model's plain float32 path on the card bounds the
   PSNR gap, and the float32 kernel path is held to it. The bf16 kernel
   forward is held to the plain bf16 forward (max-abs over the output's
   max-abs). Two faults planted in one block of the plain path must each
   break the float32 bound, the transposed projection the bf16 bound too
   (the block run unshifted moves the output less than bf16 rounding does).
4. CLI: the port's mode-0 CLI on two 512x512 .mat cubes; its stdout lines.
5. Training kernels: every kernel call signature of the flagship train
   step (the new MLP and backward kernels, the apply kernel's drop-path
   option, the eval kernels at the step's shapes), float32 and bf16, against
   the plain forward or the explicit plain backward on the same inputs
   (same tolerances as phase 2); times and bounds per call, and the
   resident forward calls streamed as in phase 2. Each backward call is
   also split into its stages (each C entry its wrapper calls, timed with
   CUDA events, the host queued ahead of the device; mlp_bwd's as the tile,
   the dW1 and dW2 weight products and the partial sums, the others' by C
   entry name, the two mp_wgrad calls of window_attention_bwd,
   spectral_apply_bwd and gdfn_bwd told apart as dWqkv / dWp, dWv / dcomb
   and dW_in / dW_out; the bf16 spectral_apply_bwd's as tile 1, tile 2,
   wgrad dWv, wgrad dcomb, d gate and sums, the bf16 gdfn_bwd's as tile 1,
   tile 2, wgrad dW_in, wgrad dW_out and sums), whose sum is the backward
   alone; two bf16 spectral_apply_bwd or gdfn_bwd calls must agree bitwise;
   each mlp call's float32 instance (K6's float32 body: the float32 tail
   tile) is timed as in phase 2, summed per step (also in phase 11); the stages
   per step, and their mp_wgrad stages summed, follow phase 6 (and phase 12 for phase
   11's calls). Then the wgrad phase: every weight product (nb, P, M, N)
   of the step, on seeded inputs made on the card, bf16 and float32 against
   wgrad_plain (TF32 off) within 1e-4 of the plain product's max-abs, two
   bf16 calls bitwise equal; ms through the wrapper and alone, TFLOP/s, the
   bound, the plain version's ms and torch.bmm's (float32 output; the bf16
   torch.matmul where bmm takes no out_dtype), per call and per step.
6. Training main path: the flagship preset in training mode (batch 32 of
   64x64 patches cut from the quality cube, Gaussian noise, task 0) from the
   committed weights. The float32 step's parameter gradients on the kernel
   path against the plain float32 step on the card, both backpropagating the
   plain step's L1 cotangent (per tensor, |g_kernel - g_plain| / |g_plain| <=
   1e-3, beside the plain step's own change for a 1e-6 input change); then
   20 bf16 AdamW steps with the counters zeroed before and read after: every
   kernel launches its expected count per step, the recorded call signatures
   equal the enumerated ones, no plain version runs; the loss of the last
   step is below the first; ms per step (median after 3 warm-up steps), the
   time until train_step returns, and peak memory.
7. Remote-sensing kernels: every kernel call signature of the 100-band
   preset's bf16 eval forward at 256x256 (C up to 384, dh 48 and 96: the
   channel-chunked shared-memory plans), bf16 and float32, against the plain
   versions (phase 2's tolerances), timed with their bounds; each shape's
   shared-memory plan in bytes beside the whole-input plan and the device's
   opt-in limit.
8. Remote-sensing main path: the preset on seeded random weights (no
   trained remote-sensing checkpoint exists), bf16 at 1x100x256x256 (the JAX
   package's remote-sensing bench size), 4 mode-0 requests after a warm-up,
   with phase 3's checks except the PSNR gain: launch counts equal the
   enumerated calls, no plain version on a CUDA tensor, the float32 kernel
   forward within 1e-4 max-abs of the plain float32 forward, the bf16
   kernel forward within its bound of the plain bf16 forward (random
   weights make the PSNR gap blind: the output is clamped to [0, 1] and
   most of it lies outside), the bf16 PSNR within 0.1 dB of the plain
   float32 one, the planted faults of phase 3 in a latent block.
9. The port's CLI with --data_type remote_sensing on two 100-band 256x256
   cubes (random weights): its stdout lines.
10. The window MSA kernel (K14) through the port's SpatialAttention layer,
    its own route (no model builds that layer): windows of the flagship's
    level 1 (512x512, C 64, 2 heads) and latent (128x128, C 256, 8 heads) and
    of the remote-sensing latent (64x64, C 384, 8 heads), each with and
    without shift-region labels, counted; then each against its plain version
    in bf16 and float32, timed with its bound and beside one library call of
    the same function (F.multi_head_attention_forward with the bias and the
    label mask as a float attn_mask), itself held to the plain version;
    each call's TFLOP/s and the sums over the 6 calls, kernel alone too.
11. Remote-sensing training kernels: every kernel call signature of the
    100-band preset's train step (batch 32 of 64x64 patches, C up to 384
    with 8 heads: the backward kernels' channel-chunked plans), bf16 and
    float32, against the plain forward or the explicit plain backward (phase
    2's tolerances); each call's plan bytes and channel chunk, time and
    bound; the largest plan against the device's opt-in limit; then the
    wgrad phase of phase 5 at this step's signatures.
12. Remote-sensing train step: the preset in training mode at full width on
    seeded random weights (text-query LN biases drawn), float32 parameter
    gradients against the plain step as in phase 6 at batch 8, then 11 bf16
    AdamW steps at batch 32 x 100 x 64^2 (task ids over the 7 tasks) with
    phase 6's launch checks: the median loss of the last 3 steps below the
    first; ms per step (median of 8 after 3 warm-up), the time until
    train_step returns, peak memory, and kernel ms per step from phase 11.
13. The training entry point, with torch's default TF32 settings (cuDNN's
    on): every branch of the degradation pipeline at
    both presets' band counts and 64x64, its draws made on the card, the
    card's apply against the CPU's on those draws (1e-5 max-abs); two batch
    degrades with one seed bitwise equal; the streaming pipeline (float32
    and uint16 upload) for 4 batches under set_sync_debug_mode("error");
    then the remote-sensing train CLI (python -m
    mp_hsir_tpu_torch.cli.train_cli) at full width, bf16, batch 32 x 64^2,
    on a store of 128 seeded 100-band patches (sources WDC_*) written by the
    port's PatchStoreWriter: 2 epochs x 6 steps with a checkpoint per epoch,
    every kernel at 12 x its per-step launches of phase 12's enumeration and
    no plain version on the card, every logged loss finite, the npz loading
    into build_model; resume from epoch 1's checkpoint reproducing epoch 2's
    losses (bitwise or the difference printed, bound 1e-3 of the loss); 6
    steps each with --upload_dtype uint16 and --resident_bank; ms per step
    (median after 2 warm-up), the upload and degrade ms per step (CUDA
    events), peak memory, beside phase 12's synthetic step.
14. The eval entry point (mp_hsir_tpu_torch.cli.test_cli's run_mode, in
    process, float32 as the JAX CLI): two 512x512x31 quality cubes (seeds
    991, 992; mode 12 pairs them with seeded sigma-30/255 copies) through
    every mode 0-12 on the trained flagship weights, one loaded model: each
    run launches every kernel (1 warm-up + 2 cubes) x the float32 forward's
    enumerated signatures (and the float32 tail tile once per apply call with
    the tail, the float32 conv3, window, stats, apply and GDFN tiles once
    per conv3, window, stats, apply and gdfn call, each counted apart), no
    plain version on the card; per mode the first
    cube through the kernel and the plain float32 forward under the mode's
    task id (max abs <= 1e-4: prompts 0-5); mode 0 restores >= 3 dB above
    the degraded input, the other modes print PSNR, SSIM, SAM and the
    degraded PSNR (mode 10: the zeroed bands); --pipeline 3 against the
    synchronous loop for modes 0, 7 and 10 under set_sync_debug_mode("error")
    (float32 upload within 1e-4 dB / 1e-5 / 1e-4 of PSNR / SSIM / SAM,
    float16 within 0.05 / 1e-3 / 0.05); the seeded random FFC classifier as
    the router on the card, consulted once per cube, synchronous and
    pipelined; one subprocess run of the CLI (mode 7, --pipeline 2
    --upload_dtype float16) held to the stdout lines; the remote-sensing
    preset on seeded random weights at 256x256x100, modes 0 and 10 (task 6),
    with the same launch and kernel-vs-plain checks; s/cube per mode; each
    preset's float32 kernels per forward (each call alone through its
    wrapper x its calls).
15. The row-sharded eval forward (--mesh_spatial N). (a) The float32 stats
    and apply tiles with halo rows, in this process: every distinct float32
    stats and apply call of the flagship forward (phase 2's shapes, read in
    the unrolled frame) cut into 2 and 4 row shards, each shard with its
    neighbours' rows as halos and its edge flags: against its plain version
    (phase 2's float32 tolerance), the shards composed (the stats summed in
    rank order, the apply outputs stacked) against the unsharded kernel call
    (1e-4 of max-abs), two planted faults (the halo rows swapped top for
    bottom; a top edge flag inverted) that must break that bound; each halo
    call of one shard of 2 timed beside the unsharded call, its plain
    version and its bound, summed per sharded forward. The same in bf16
    (the bf16 tiles with halo rows): each shard against its plain bf16
    version (3e-2 of max-abs), the stats summed within 1e-4 of the
    unsharded bf16 call, the apply shards stacked bitwise equal to it, the
    two faults composed in breaking that bound. (b) The eval CLI with
    --mesh_spatial 2, two ranks sharing this card over gloo: the flagship
    (trained weights, mode 0, the two 512^2 x 31 quality cubes) and the
    remote-sensing preset (seeded weights, 256^2 x 100, mode 0), each
    against --mesh_spatial 1 (PSNR within 1e-3 dB, SSIM within 1e-4), the
    gathered cubes against the unsharded kernel forward (max abs 1e-4),
    each rank's launches per forward (24 float32 stats and apply launches
    with halo rows, 22 window launches of which 11 with region labels, 8
    conv3, 2 GDFN) and no plain call on the card; each rank's s per cube
    (ranks sharing one card: not a multi-card figure). --mesh-eval adds a probe
    of which gloo collectives take CUDA tensors here (each op in two ranks
    of its own; reported, not checked: the port never hands gloo one).
    --mesh-cards (a machine with several cards) runs phase 1 and the same
    CLI check with one rank a card over NCCL (2 ranks, then one per card;
    rank r on card r), then the CLI under torchrun (2 processes) against the
    one-card stdout, then phase 16's 1 x 2 step with one rank a card.
16. The row- and data-sharded train step (--mesh_data N --mesh_spatial
    M). (a) Every distinct float32 K10a / K10b call of the
    flagship step (one card's whole-map backward at batch 8 x 31 x 64^2 on
    the trained weights, each call's inputs recorded in the sharded frame)
    cut into 2 and 4 row shards: each shard's kernel backward with its halo
    rows (dx, the halo cotangents, the weight gradients) against its plain
    backward (1e-4 of each output's max-abs), the shards composed (halo
    cotangents folded into the neighbours' rows, weight gradients summed)
    against the unsharded kernel backward (1e-4), three planted faults that
    must break the bound (top and bottom cotangents folded into each
    other's rows, a cotangent sent through the ring's wrap at an edge, an
    inverted edge flag); shard 0 of 2 timed beside its plain version, the
    unsharded call and its bound, summed per step; then every distinct
    bf16 call of the flagship bf16 step at batch 32 the same way (per shard
    3e-2 of max-abs off plain bf16; composed within 1e-2 of the unsharded
    bf16 kernel backward with dx held row by row; the three faults composed
    in, each 3 times the call's own composition error and above 1e-3;
    every call is checked and logged before a failure).
    (b) The 1 x 2 float32
    step, two ranks sharing this card over gloo, batch 8, trained weights,
    drop-path on: gradients (the one-rank plain step's loss cotangent)
    against the one-rank kernel step (1e-5 norm-wise per tensor) and the
    plain float32 step (1e-3); per rank per step 24 + 24 halo backward
    launches and 11 window backwards with region labels, no plain call;
    the parameters bitwise equal across the ranks after 3 AdamW steps; ms
    per step per rank (ranks sharing one card: not a multi-card figure).
    (c) The 2 x 1 data mesh (drop-path off): float32 gradients against one
    rank (1e-5), then 3 bf16 steps at batch 32 with finite losses and their
    ms. (d) The remote-sensing train CLI, --mesh_spatial 2 on phase 13's
    store (batch 8, 4 steps), float32 and then bf16 (its default): losses
    within 1e-4 (float32) / 1e-3 (bf16) of the one-rank CLI's, the
    parameters equal across the ranks. (e) The bf16 1 x 2 step, two ranks
    sharing this card over gloo, batch 32, trained weights, drop-path on:
    gradients against the one-rank bf16 kernel step (every tensor
    concatenated 2e-2 norm-wise; per tensor 3e-2 or ten times the tensor's
    one-rank bf16 distance from float32, the larger); per rank per step
    24 + 24 bf16 halo forward launches, 24 + 24 halo backward launches and
    11 window backwards with region labels, no plain call; the parameters bitwise
    equal across the ranks after 3 AdamW steps and after 20; the loss over
    the 20 steps falls; ms per step per rank (not a multi-card figure).
    --mesh-cards runs (e) with one rank a card over NCCL too. --mesh-train
    runs phase 1 and only phase 16.
17. The head-parallel spectral mesh axis in float32, then bf16 (make_mesh(data,
    spatial, spectral)). (a) Every distinct float32 stats and apply call of
    the flagship forward on the head-parallel route (512^2: no LayerNorm,
    the gate over n, no tail) as two members' head blocks: each member's
    kernels against their plain versions (1e-4 of max-abs), the members
    composed against the whole attention's kernel calls (the stats stacked
    bitwise, the applies summed within 1e-4), the same
    at 2 row shards x 2 members with halo rows, two planted faults that
    must break the bound (member 1 on member 0's weights with its own
    temperature, the gate not scaled by 1/n); member 0 timed beside plain,
    the whole call and the bound. (b) Every float32 K10a / K10b call of the
    flagship step at batch 8 (recorded as in phase 16, LayerNorm and
    residual left out) as two members: each against its plain backward
    (1e-4), dx summed and the weight cotangents scattered into full-size
    tensors against the whole backward (1e-4); member 0 timed. (c) The
    flagship 1 x 1 x 2 eval step on the trained weights, one 512^2 cube,
    two ranks sharing this card over gloo: within 1e-4 of max-abs of the
    one-rank float32 forward, PSNR and SSIM within 1e-3 dB / 1e-4 of one
    rank's; per rank 24 + 24 head-block launches, no plain call. (d) The
    float32 1 x 1 x 2 and 1 x 2 x 2 train steps, batch 8, trained weights,
    drop-path on: gradients against the one-rank kernel step (1e-4
    norm-wise per tensor), 24 + 24 head-block backwards per rank per step,
    no plain call, each of the route's own head-block backward launches
    (shift 0, gate maps over n) against its plain backward (1e-4), the
    parameters bitwise equal across the ranks after 3 and after 10 AdamW
    steps, the loss falling over the 10; ms per step per rank (ranks
    sharing one card: not a multi-card figure). (e) The
    remote-sensing 1 x 1 x 2 eval step (seeded weights, 256^2) against one
    rank. Then (a) - (e) again in bf16, the four bf16 head-block tiles:
    (a) each member against plain bf16 (3e-2), the stats stacked bitwise
    (1e-5 where a member's parts per image differ from the whole call's),
    the applies summed, the halo shards and the faults against 1.2e-2; (b)
    every bf16 K10a / K10b call of the step at batch 32 (3e-2 per member,
    composed 1.2e-2); (c) / (e) the bf16 eval steps within 5e-2 of max-abs
    of one rank's bf16 forward and PSNR within 0.1 dB of the one-rank
    float32 forward's; (d) the bf16 steps at batch 32 against one rank's
    bf16 step (every tensor concatenated 2e-2 norm-wise, per tensor 7.5e-2
    where bf16 resolves it), the route's backwards against plain (3e-2),
    the same launches, bits and loss as in float32 (bounds derived on the
    CPU by tests/tp_bounds.py --bf16, PERF.md). --mesh-cards runs (d)'s
    float32 1 x 1 x 2 step with one rank a card over NCCL too; --mesh-tp
    runs phase 1 and only phase 17.
18. The kernel summary line (each kernel's main-path numbers, its
    remote-sensing train-step numbers and the train and eval CLIs' launches
    beside them; the float32 tail tile's row: phase 14's launches, phase 2's
    tail ms per flagship float32 forward beside its bound and plain, the
    largest float32 error of its calls; the float32 conv3, window, stats,
    apply and GDFN tiles' rows: phase 14's launches (one per call of their
    kernel), phase 2's float32 ms per flagship forward (the apply tile's:
    its fronts), alone, plain, bound and library, phase 7's remote-sensing
    float32 sums; the four bf16 halo instances: phase 16 (e)'s launches,
    phase 15 (a)'s bf16 ms per sharded forward and phase 16 (a)'s bf16 ms
    per sharded step; the eight head-block instances (float32 and bf16):
    phase 17 (c)'s and (d)'s launches, phase 17 (a)'s ms per flagship
    forward and (b)'s per step for member 0 of 2), then the result line.

--bwd-split KERNEL (mlp_bwd, spectral_stats_bwd, window_attention_bwd,
spectral_apply_bwd or gdfn_bwd; repeatable) runs phase 1's build and only
that kernel's stage split, at both presets' train-step shapes, and the sum
of the named kernels' mp_wgrad stages: the same measurement for another
checkout of the package (this file copied to its root and run there);
--mlp-bwd-split is --bwd-split mlp_bwd. --wgrad runs phase 1 and only the
wgrad phase, at both presets' train-step signatures. --train-cli runs phase
1 and only phase 13, --eval-cli phase 1 and only phase 14. --f32-eval runs
phases 1, 2, K6's float32 calls of phases 5 and 11 (checked and timed),
phase 7's two gdfn calls (the remote-sensing forward's, checked and timed
in both types) and 14: the float32 path's kernels and the eval CLI, also
for an older checkout (this file copied to its root: where its package has
no float32 tail tile, the tile's launches are not expected and its C = 400
mlp call is left out; where it has no float32 conv3 and window tiles, no
float32 stats, apply or GDFN tile, their launches are not expected and only
their SIMT kernels' registers are logged; its float32 apply and GDFN calls
are timed and counted with its own chunked plans).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import zlib
from collections import Counter

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet: HBM rate and dense bf16 tensor-core rate
BF16_FLOPS = 989e12
# dense TF32 tensor-core rate (data sheet); a float32 call's bound counts three
# TF32 products per float32 product (3xTF32, the float32 tail tile's method)
TF32_FLOPS = 495e12
ART = os.path.join("assets", "trained", "natural_12k_f16.npz")
RS_SIZE, RS_SEED = 256, 2024  # remote-sensing main path: bench size, weight seed
BF16_TOL, F32_TOL = 3e-2, 1e-4
# whole forward: float32 kernels vs plain, max abs (sound reading ~3e-6); bf16
# kernels vs plain float32, PSNR (sound reading ~0.014 dB)
MODEL_F32_TOL, MODEL_PSNR_TOL = 1e-4, 0.1
# whole forward: bf16 kernels vs the plain bf16 path, max abs over the
# output's max abs (sound readings 1.6e-2 flagship, 1.0e-2 remote sensing;
# the transposed-projection fault 5.1e-2 and 4.0e-2)
MODEL_BF16_TOL = 2.5e-2
# the planted faults each bound must catch: running one shifted block
# unshifted (float32 7.5e-3 / 2.4e-2 max abs) stays within bf16's own
# rounding noise through the network, so the bf16 bound is held to the other
F32_FAULTS = ("block run unshifted", "window projection transposed")
BF16_FAULTS = ("window projection transposed",)
REQUESTS = 4
SIZE = 512
TRAIN_BATCH, TRAIN_SIZE, TRAIN_STEPS, TRAIN_WARMUP = 32, 64, 20, 3
# remote-sensing train step: 3 warm-up + 8 timed steps; the float32 gradient
# check's batch (the step itself runs TRAIN_BATCH)
RS_TRAIN_STEPS, RS_GRAD_BATCH = 11, 8
GRAD_TOL = 1e-3  # float32 train-step gradients, kernels vs plain, norm-wise per tensor

KERNELS = {
    "window_attention": dict(source="mp_hsir_tpu_torch/csrc/window_attention.cu", tpu=["K1", "K3"],
                             replaces="mp_hsir_tpu/ops/pallas_attention.py:198"),
    "spectral_stats": dict(source="mp_hsir_tpu_torch/csrc/spectral_stats.cuh", tpu=["K3", "K2"],
                           replaces="mp_hsir_tpu/ops/pallas_attention.py:362"),
    "spectral_apply": dict(source="mp_hsir_tpu_torch/csrc/spectral.cu", tpu=["K2"],
                           replaces="mp_hsir_tpu/ops/pallas_attention.py:1429"),
    "conv3": dict(source="mp_hsir_tpu_torch/csrc/conv3.cu", tpu=["K4"],
                  replaces="mp_hsir_tpu/ops/pallas_attention.py:1084"),
    "gdfn": dict(source="mp_hsir_tpu_torch/csrc/gdfn.cu", tpu=["K5"],
                 replaces="mp_hsir_tpu/ops/pallas_attention.py:1274"),
}
K14_KERNEL = {"window_msa": dict(source="mp_hsir_tpu_torch/csrc/window_attention.cu", tpu=["K14"],
                                 replaces="mp_hsir_tpu/ops/pallas_attention.py:40")}
# the kernels that stage their input whole where it fits, else in chunks (the
# window kernel's bf16 plan stages the whole window at every width, the bf16
# spectral stats, apply and GDFN tiles their whole input)
STAGED = ("spectral_stats", "spectral_apply", "gdfn")
# the float32 tail tile (mlp_tail_f32 in csrc/mlp_tail.cuh): K6's float32 body
# and the float32 spectral apply's PGSSTB tail; its launches count in its own
# counter beside mlp's and spectral_apply's
TAIL_F32_KERNEL = {"mlp_tail_f32": dict(source="mp_hsir_tpu_torch/csrc/mlp_tail.cuh",
                                        tpu=["K2", "K6"],
                                        replaces="mp_hsir_tpu/ops/pallas_attention.py:965")}
# the float32 conv3, window, spectral stats, spectral apply and GDFN tiles
# (3xTF32): K4's, K1's, K2 phase 0's, K2 phase 1's (with K7b's) and K5's
# float32 instances, the eval CLI's route; their launches count in their
# own counters beside conv3's, window_attention's, spectral_stats's,
# spectral_apply's and gdfn's
F32_TILE_KERNELS = {
    "conv3_f32": dict(source="mp_hsir_tpu_torch/csrc/conv3.cu", tpu=["K4"], of="conv3",
                      replaces="mp_hsir_tpu/ops/pallas_attention.py:1182"),
    "window_attention_f32": dict(source="mp_hsir_tpu_torch/csrc/window_attention.cu",
                                 tpu=["K1", "K3"], of="window_attention",
                                 replaces="mp_hsir_tpu/ops/pallas_attention.py:794"),
    "spectral_stats_f32": dict(source="mp_hsir_tpu_torch/csrc/spectral_stats_f32.cuh",
                               tpu=["K2", "K3", "K7a"], of="spectral_stats",
                               replaces="mp_hsir_tpu/ops/pallas_attention.py:1842"),
    "spectral_apply_f32": dict(source="mp_hsir_tpu_torch/csrc/spectral.cu", tpu=["K2", "K7b"],
                               of="spectral_apply", sums="spectral_apply_front",
                               replaces="mp_hsir_tpu/ops/pallas_attention.py:1842"),
    "gdfn_f32": dict(source="mp_hsir_tpu_torch/csrc/gdfn.cu", tpu=["K5"], of="gdfn",
                     replaces="mp_hsir_tpu/ops/pallas_attention.py:1412"),
}
# a width past fc2's 384-channel register slice (two output groups), float32
WIDE_C = 400
# the kernels timed alone beside their wrappers, with their library yardsticks
ALONE = {"conv3": "F.conv2d", "window_attention": None,
         "window_msa": "F.multi_head_attention_forward", "mlp": None, "spectral_stats": None,
         "spectral_apply": None, "gdfn": None, "mlp_bwd": None}
# the training route's new kernels (timed at the train step's shapes)
TRAIN_KERNELS = {
    "mlp": dict(source="mp_hsir_tpu_torch/csrc/mlp.cu", tpu=["K6"],
                replaces="mp_hsir_tpu/ops/pallas_attention.py:1024"),
    "mlp_bwd": dict(source="mp_hsir_tpu_torch/csrc/mlp.cu", tpu=["K9"],
                    replaces="mp_hsir_tpu/ops/pallas_vjp.py:260"),
    "window_attention_bwd": dict(source="mp_hsir_tpu_torch/csrc/window_attention.cu", tpu=["K8"],
                                 replaces="mp_hsir_tpu/ops/pallas_vjp.py:853"),
    "spectral_stats_bwd": dict(source="mp_hsir_tpu_torch/csrc/spectral_stats.cuh",
                               tpu=["K10a", "K12"],
                               replaces="mp_hsir_tpu/ops/pallas_vjp.py:1671"),
    "spectral_apply_bwd": dict(source="mp_hsir_tpu_torch/csrc/spectral_apply_bwd.cuh",
                               tpu=["K10b", "K12"],
                               replaces="mp_hsir_tpu/ops/pallas_vjp.py:1758"),
    "gdfn_bwd": dict(source="mp_hsir_tpu_torch/csrc/gdfn.cu", tpu=["K11"],
                     replaces="mp_hsir_tpu/ops/pallas_vjp.py:471"),
    # the weight products of the five backward kernels: the float32 weight
    # accumulators their TPU kernels carry across the grid (_mlp_bwd_kernel
    # :124, _gdfn_bwd_kernel :342, _win_bwd_kernel :539, _sp0_bwd_kernel
    # :1443, _sp1_bwd_kernel :1501); its time lies inside theirs
    "wgrad": dict(source="mp_hsir_tpu_torch/csrc/grad.cu", tpu=["K9", "K11", "K8", "K10a", "K10b"],
                  replaces="mp_hsir_tpu/ops/pallas_vjp.py:124"),
}
# kernels whose time lies inside other kernels' (left out of the step's sum)
INSIDE = ("wgrad",)
# wgrad against wgrad_plain, both dtypes: float32 sums of the same products
# (bf16 products are exact in float32) in other orders
WGRAD_TOL = F32_TOL


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print a line; a phase's header ("== ...") with the seconds since the
    script started."""
    if msg.startswith("== "):
        msg += f"  [{time.perf_counter() - _T0:.0f} s]"
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# the main path's kernel calls, enumerated from the configuration
# ---------------------------------------------------------------------------

def path_specs(cfg, size: int, dt: str) -> Counter:
    """Per-forward multiset of the kernel calls of the flagship eval forward,
    in the wrappers' own spec format (checked against what the run records)."""
    specs: Counter = Counter()
    d = cfg.dim
    levels = [(size, d, cfg.heads[0], cfg.num_blocks[0], 0),
              (size // 2, 2 * d, cfg.heads[1], cfg.num_blocks[1], 1),
              (size // 4, 4 * d, cfg.heads[2], cfg.num_blocks[2], 2),
              (size // 2, 2 * d, cfg.heads[1], cfg.num_blocks[1], 1),
              (size, 2 * d, cfg.heads[0], cfg.num_blocks[0], 0),
              (size, 2 * d, cfg.heads[0], cfg.num_refinement_blocks, 0)]
    for res, c, nh, depth, level in levels:
        frozen = min(cfg.train_resolution) >> level
        for i in range(depth):
            shift = 0 if (i % 2 == 0 or frozen <= 8) else 4
            specs[("window_attention", 1, res, res, c, nh, shift, dt)] += 1
            specs[("spectral_stats", 1, res, res, c, 0, nh, shift, False, dt)] += 1
            specs[("spectral_apply", 1, res, res, c, 0, shift, False, False, True, True,
                   int(c * cfg.ffn_expansion_factor), dt)] += 1
    for res, c, nh in ((size // 2, 2 * d, 8), (size, d, 4)):  # fusion2, fusion1
        specs[("spectral_stats", 1, res, res, c, c, nh, 0, True, dt)] += 1
        specs[("spectral_apply", 1, res, res, c, c, 0, True, True, False, False, 0, dt)] += 1
        specs[("gdfn", 1, res, res, 2 * c, int(2 * c * cfg.ffn_expansion_factor), c, True, dt)] += 1
    s2, s4 = size // 2, size // 4
    for spec in (("conv3", 1, size, size, cfg.in_channels, d, "plain"),
                 ("conv3", 1, size, size, d, d // 2, "down"),
                 ("conv3", 1, s2, s2, 2 * d, d, "down"),
                 ("conv3", 1, s4, s4, 4 * d, 8 * d, "up"),
                 ("conv3", 1, s2, s2, 2 * d, 4 * d, "up"),
                 ("conv3", 1, s2, s2, 2 * d, 2 * d, "plain"),
                 ("conv3", 1, size, size, d, d, "plain"),
                 ("conv3", 1, size, size, 2 * d, cfg.out_channels, "res")):
        specs[spec + (dt,)] += 1
    return specs


# ---------------------------------------------------------------------------
# phase 2: inputs, checks, times and bounds per kernel call
# ---------------------------------------------------------------------------

class Inputs:
    def __init__(self, seed: int, dev, dt):
        self.rng = np.random.default_rng(seed)
        self.dev, self.dt = dev, dt

    def n(self, shape, scale=1.0, dt=None):
        a = (self.rng.standard_normal(shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(self.dev, dt or self.dt)

    def u(self, shape, fan_in):
        b = 1.0 / np.sqrt(fan_in)
        a = self.rng.uniform(-b, b, shape).astype(np.float32)
        return torch.from_numpy(a).to(self.dev)


def apply_cost(b, h, w, c, e, gate, short) -> tuple:
    """(bytes, flops) of one spectral apply call without the PGSSTB tail (the
    front): its input, comb (float32), the v weights, the gate and shortcut
    maps read once, its output written once; the 1x1, the depthwise 3x3 and
    the comb product."""
    p = b * h * w
    byts = 2 * p * c * e + b * c * c * 4 + (c * c + 9 * c) * e
    byts += (p // 64 * c * e if gate else 0) + (p * c * e if short else 0)
    return byts, p * (4 * c * c + 18 * c)


def make_call(spec, dev, dt):
    """(kernel fn, args, kwargs, library fn or None, bytes, flops) for one spec."""
    from mp_hsir_tpu_torch.ops.kernels import conv3, gdfn, spectral, window_attention

    name = spec[0]
    g = Inputs(zlib.crc32(repr(spec[:-1]).encode()), dev, dt)
    e = torch.tensor([], dtype=dt).element_size()
    f32 = lambda shape, s=1.0: g.n(shape, s, torch.float32)  # noqa: E731
    if name == "window_attention":
        _, b, h, w, c, nh, shift, _ = spec
        args = (g.n((b, h, w, c)), 1 + f32((c,), 0.1), f32((c,), 0.1), g.u((3 * c, c), c),
                g.u((3 * c,), c), f32((nh, 64, 64), 0.02), g.u((c, c), c), g.u((c,), c), nh)
        p = b * h * w
        byts = 2 * p * c * e + p // 64 * c * e + 4 * c * c * e + nh * 4096 * 4 + 6 * c * 4
        flops = 2 * p * (4 * c * c + 128 * c)
        return window_attention.window_attention, args, dict(shift=shift), None, byts, flops
    if name == "spectral_stats":
        _, b, h, w, c1, c2, nh, shift, ln, _ = spec
        c = c1 + c2
        kw = dict(shift=shift)
        if c2:
            kw["x2"] = g.n((b, h, w, c2))
        if ln:
            kw.update(ln_w=1 + f32((c,), 0.1), ln_b=f32((c,), 0.1))
        args = (g.n((b, h, w, c1)), g.u((3 * c, c, 1, 1), c), g.u((3 * c, 1, 3, 3), 9), nh)
        p = b * h * w
        byts = p * c * e + (2 * c * c + 18 * c) * e + b * (c * c // nh + 2 * c) * 4
        flops = p * (4 * c * c + 36 * c + 2 * c * (c // nh) + 4 * c)
        return spectral.spectral_stats, args, kw, None, byts, flops
    if name == "spectral_apply":
        dp = spec[-2] == "dp"
        _, b, h, w, c1, c2, shift, ln, residual, gate, short, hid = spec[:12]
        c = c1 + c2
        kw = dict(shift=shift, residual=residual)
        if dp:
            kw["dp_scale"] = torch.tensor([1.25, 0.0] * (b // 2) + [1.25] * (b % 2), device=dev)
        p = b * h * w
        byts, flops = apply_cost(b, h, w, c, e, gate, short)
        if c2:
            kw["x2"] = g.n((b, h, w, c2))
        if ln:
            kw.update(ln_w=1 + f32((c,), 0.1), ln_b=f32((c,), 0.1))
        if gate:
            kw["gate"] = g.n((b, h // 8, w // 8, c), 0.5)
        if short:
            kw["shortcut"] = g.n((b, h, w, c))
        if hid:
            kw["mlp"] = (1 + f32((c,), 0.1), f32((c,), 0.1), g.u((2 * hid, c), c),
                         g.u((2 * hid,), c), g.u((c, hid), hid), g.u((c,), hid))
            byts += 3 * c * hid * e
            flops += p * 6 * c * hid
        args = (g.n((b, h, w, c1)), f32((b, c, c), c ** -0.5), g.u((3 * c, c, 1, 1), c),
                g.u((3 * c, 1, 3, 3), 9))
        return spectral.spectral_apply, args, kw, None, byts, flops
    if name == "conv3":
        _, b, h, w, cin, cout, mode, _ = spec
        x = g.n((b, h, w, cin))
        wt = g.u((cout, cin, 3, 3), 9 * cin)
        res = f32((b, h, w, cout)) if mode == "res" else None
        p = b * h * w
        byts = p * cin * e + p * cout * (8 if mode == "res" else e) + 9 * cin * cout * e
        flops = 2 * 9 * p * cin * cout
        xc, wl = x.permute(0, 3, 1, 2), wt.to(dt)

        def library():
            return torch.nn.functional.conv2d(xc, wl, padding=1)

        return conv3.conv3, (x, wt, mode, res), {}, library, byts, flops
    if name == "gdfn":
        _, b, h, w, c, hid, co, residual, _ = spec
        args = (g.n((b, h, w, c)), 1 + f32((c,), 0.1), f32((c,), 0.1), g.u((2 * hid, c, 1, 1), c),
                g.u((2 * hid, 1, 3, 3), 9), g.u((c, hid, 1, 1), hid))
        kw = dict(residual=residual, proj_w=g.u((co, c, 1, 1), c) if co else None)
        p = b * h * w
        byts = p * (c + (co or c)) * e + (3 * c * hid + 18 * hid + c * co) * e
        flops = p * (6 * c * hid + 36 * hid + 2 * c * co)
        return gdfn.gdfn, args, kw, None, byts, flops
    raise KeyError(name)


def _code(spec) -> int:
    """The kernels' compute-type code of a spec (0 float32, 1 bf16)."""
    return int(spec[-1] != "torch.float32")


# the kernels whose plan is one function of the shape: (smem entry, chunk
# entry or None, the shape's ints from the spec)
PLAN_ENTRIES = {
    "window_attention": ("mp_window_attention_smem", "mp_window_chunk",
                         lambda s: (*s[4:6], _code(s))),
    "window_msa": ("mp_window_msa_smem", "mp_window_chunk", lambda s: (*s[2:4], _code(s))),
    "spectral_stats": ("mp_spectral_stats_smem", "mp_spectral_stats_chunk",
                       lambda s: (s[4] + s[5], s[6])),
    "spectral_apply": ("mp_spectral_apply_smem", "mp_spectral_apply_chunk",
                       lambda s: (s[4] + s[5], int(s[11] > 0), _code(s))),
    "gdfn": ("mp_gdfn_smem", "mp_gdfn_chunk", lambda s: s[4:5]),
    "mlp": ("mp_mlp_smem", None, lambda s: (s[4], _code(s))),
    "mlp_bwd": ("mp_mlp_bwd_smem", "mp_mlp_bwd_chunk", lambda s: s[4:5]),
    "window_attention_bwd": ("mp_window_attention_bwd_smem", "mp_window_attention_bwd_chunk",
                             lambda s: s[4:6]),
    "spectral_stats_bwd": ("mp_spectral_stats_bwd_smem", None, lambda s: s[4:6]),
    "spectral_apply_bwd": ("mp_spectral_apply_bwd_smem", "mp_spectral_apply_bwd_chunk",
                           lambda s: (s[4], s[4])),
    "gdfn_bwd": ("mp_gdfn_bwd_smem", "mp_gdfn_bwd_chunk", lambda s: s[4:5]),
}


def plan_of(spec) -> dict:
    """The shared-memory plan of one spec: ``smem``, the bytes of the plan
    the kernel launches with; ``smem_whole``, those of its whole-input plan
    (the only one before the channel-chunked staging); ``kc``, its channel
    chunk, and ``c`` its input width (kc = c: the input is resident); for
    the window kernels also ``blocks_per_window``, the thread-block cluster
    that splits a window's heads where windows are few (bf16)."""
    import ctypes

    from mp_hsir_tpu_torch.ops.kernels import _build

    name = spec[0]
    if name == "conv3":
        # one plan per compute type, whatever the shape: Cin streams in
        # chunks of CHUNK_K
        from mp_hsir_tpu_torch.ops.kernels.conv3 import CHUNK_K
        n = _build.plan_bytes("mp_conv3_smem", int(spec[-1] != "torch.float32"))
        return dict(smem=n, smem_whole=n, kc=CHUNK_K, c=spec[4])
    smem_entry, chunk_entry, shape_of = PLAN_ENTRIES[name]
    shape = tuple(shape_of(spec))
    c = shape[0]
    if name == "window_attention" and has_f32_tiles():  # both tiles: one whole-window plan
        n = _build.plan_bytes(smem_entry, *shape)
        fn = _build.lib().mp_window_cluster
        fn.argtypes, fn.restype = [ctypes.c_int] * 5, ctypes.c_int
        return dict(smem=n, smem_whole=n, kc=c, c=c,
                    blocks_per_window=int(fn(*shape, spec[1] * (spec[2] // 8) * (spec[3] // 8),
                                             0)))
    if name == "spectral_stats" and _code(spec):  # the bf16 tile: one resident plan
        n = _build.plan_bytes("mp_spectral_stats_tc_smem", c, *shape)
        return dict(smem=n, smem_whole=n, kc=c, c=c)
    if name == "spectral_stats" and has_stats_f32_tile():  # the float32 tile: one plan
        n = _build.plan_bytes("mp_spectral_stats_smem", c, *shape)
        return dict(smem=n, smem_whole=n, kc=c, c=c)
    if name == "spectral_apply" and has_apply_f32_tile():  # both tiles: one plan each
        n = _build.plan_bytes(smem_entry, c, *shape)
        return dict(smem=n, smem_whole=n, kc=c, c=c)
    if name == "gdfn" and _code(spec):  # the bf16 tile: one resident plan
        n = _build.plan_bytes("mp_gdfn_tc_smem", c)
        return dict(smem=n, smem_whole=n, kc=c, c=c)
    if name == "gdfn" and has_gdfn_f32_tile():  # the float32 tile: one plan, no chunk
        n = _build.plan_bytes("mp_gdfn_f32_smem", c)
        return dict(smem=n, smem_whole=n, kc=c, c=c)
    if name == "mlp_bwd" and _code(spec):  # the bf16 tile: one resident plan
        n = _build.plan_bytes("mp_mlp_bwd_tc_smem", c)
        return dict(smem=n, smem_whole=n, kc=c, c=c)
    if name == "spectral_stats_bwd" and _code(spec):  # the bf16 tiles: the larger plan
        n = max(_build.plan_bytes("mp_spectral_stats_bwd_tc_smem", c, *shape),
                _build.plan_bytes("mp_dwconv_dx_tc_smem", c, 2 * c))
        return dict(smem=n, smem_whole=n, kc=c, c=c)
    if name == "spectral_stats_bwd":  # the float32 kernel: one whole-input plan
        n = _build.plan_bytes(smem_entry, c, *shape)
        return dict(smem=n, smem_whole=n, kc=c, c=c)
    if name == "spectral_apply_bwd" and _code(spec):  # the bf16 tiles: the larger plan
        n = max(_build.plan_bytes("mp_spectral_apply_bwd_tc_smem", c, c, tile) for tile in (1, 2))
        return dict(smem=n, smem_whole=n, kc=c, c=c)
    if name == "gdfn_bwd" and _code(spec):  # the bf16 tiles: the larger plan
        n = max(_build.plan_bytes(f"mp_gdfn_{tile}_tc_smem", c) for tile in ("bwd", "dx"))
        return dict(smem=n, smem_whole=n, kc=c, c=c)
    if name == "window_attention_bwd" and _code(spec):  # the bf16 tiles: the larger plan
        n = max(_build.plan_bytes("mp_window_attention_bwd_tc_smem", *shape),
                _build.plan_bytes("mp_window_attention_dx_tc_smem", c))
        return dict(smem=n, smem_whole=n, kc=c, c=c)
    if chunk_entry is None:  # a single whole-input plan
        n = _build.plan_bytes(smem_entry, *shape)
        return dict(smem=n, smem_whole=n, kc=c, c=c)
    kc = _build.chunk(chunk_entry, *shape)
    plan = dict(smem=_build.plan_bytes(smem_entry, *shape, kc),
                smem_whole=_build.plan_bytes(smem_entry, *shape, c), kc=kc, c=c)
    if name in ("window_attention", "window_msa"):
        k14 = name == "window_msa"
        nwin = spec[1] if k14 else spec[1] * (spec[2] // 8) * (spec[3] // 8)
        fn = _build.lib().mp_window_cluster
        fn.argtypes, fn.restype = [ctypes.c_int] * 5, ctypes.c_int
        plan["blocks_per_window"] = int(fn(*shape, nwin, int(k14)))
    return plan


def log_plan(plan) -> str:
    """A plan's bytes and chunk (and blocks per window) for the logs."""
    g = plan.get("blocks_per_window")
    return (f"smem {plan['smem']} B at kc {plan['kc']} (whole input {plan['smem_whole']} B)"
            + ("" if g is None else f", {g} block{'s' * (g > 1)} per window"))


@contextlib.contextmanager
def streamed_plans(kc: int = 64):
    """Every staged kernel launched in this block streams its input in
    ``kc``-channel chunks, whatever the plan it would pick."""
    from mp_hsir_tpu_torch.ops.kernels import _build

    picked = _build.chunk
    _build.chunk = lambda entry, *shape: min(kc, shape[0])
    try:
        yield
    finally:
        _build.chunk = picked


def streamed_ms(spec, fn, args, kw):
    """A call whose input is resident (kc = C > 64) timed, then checked
    against its plain version and timed once more with its input streamed in
    64-channel chunks: what a single streamed plan would cost at this shape
    (``ms_resident``, ``ms_streamed`` and the instance's ``dtype``). A bf16
    spectral_stats call runs its float32 instance here (the bf16 tile has no
    chunk). None for the calls that stream already or have no chunk."""
    if spec[0] not in STAGED or spec[0] in ("spectral_apply", "gdfn") and _code(spec):
        return None  # (the bf16 apply and GDFN tiles have one resident plan)
    if spec[0] == "spectral_stats" and has_stats_f32_tile():
        return None  # (both stats tiles have one plan)
    if spec[0] == "gdfn" and has_gdfn_f32_tile():
        return None  # (both GDFN tiles have one plan)
    f32spec = spec[:-1] + ("torch.float32",)
    plan = plan_of(f32spec)  # the chunked layout
    if plan["kc"] < plan["c"] or plan["c"] <= 64:
        return None
    tol = BF16_TOL
    if spec[0] == "spectral_stats" and _code(spec):
        fn, args, kw, *_ = make_call(f32spec, args[0].device, torch.float32)
        tol = F32_TOL
    resident = time_ms(lambda: fn(*args, **kw), 10)
    with streamed_plans():
        compare(fn, args, kw, tol)
        return dict(ms_resident=resident, ms_streamed=time_ms(lambda: fn(*args, **kw), 10),
                    dtype=str(args[0].dtype).replace("torch.", ""))


def _flat(out):
    return out if isinstance(out, tuple) else (out,)


def compare(fn, args, kw, tol):
    """Max-abs error of kernel vs plain (each output against its own scale)."""
    from mp_hsir_tpu_torch.ops.kernels._route import plain_reference

    got = _flat(fn(*args, **kw))
    with plain_reference():
        ref = _flat(fn(*args, **kw))
    torch.cuda.synchronize()
    worst, worst_rel = 0.0, 0.0
    for a, r in zip(got, ref):
        if a.shape != r.shape or a.dtype != r.dtype:
            raise AssertionError(f"shape/dtype {a.shape} {a.dtype} vs {r.shape} {r.dtype}")
        if not torch.isfinite(a.float()).all():
            raise AssertionError("kernel output not finite")
        err = (a.float() - r.float()).abs().max().item()
        scale = max(r.float().abs().max().item(), 1e-6)
        worst, worst_rel = max(worst, err), max(worst_rel, err / scale)
        if err > tol * scale:
            raise AssertionError(f"max abs err {err:.3e} > {tol} * {scale:.3e}")
    return worst, worst_rel


def compare_library(library, fn, args, kw):
    """Max-abs error of a library call against the plain version of the
    kernel it stands beside (phase 2's bf16 tolerance): the yardstick must
    compute the same function."""
    from mp_hsir_tpu_torch.ops.kernels._route import plain_reference

    got = library()
    with plain_reference():
        ref = fn(*args, **kw)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    scale = max(ref.float().abs().max().item(), 1e-6)
    if got.shape != ref.shape or not err <= BF16_TOL * scale:
        raise AssertionError(f"library call: shape {tuple(got.shape)}, max abs err {err:.3e} "
                             f"> {BF16_TOL} * {scale:.3e}")
    return err, err / scale


def time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_alone_ms(name, args, kw) -> float:
    """A kernel alone on a call's inputs: its launch prepared once (conv3's
    weight packed, the window, mlp, spectral and GDFN kernels' weights packed
    and their outputs allocated) and the C entry launched directly, without
    what the wrapper adds on the host per call (the packing copies,
    allocations, Python)."""
    from mp_hsir_tpu_torch.ops.kernels import (
        _build, conv3, gdfn, mlp, spectral, window_attention, window_msa,
    )
    from mp_hsir_tpu_torch.ops.kernels._route import dtype_code, stream_ptr

    if name == "conv3":
        x, w, mode, res = args
        b, h, wd, cin = x.shape
        wk = conv3.pack_weight(w, x.dtype)
        res = None if res is None else res.float().contiguous()
        out = conv3.conv3(x, w, mode, res)
        held = (wk, res, out)
        launch = [x.data_ptr(), wk.data_ptr(), _build.ptr(res), out.data_ptr(), dtype_code(x), b,
                  h, wd, cin, w.shape[0], conv3.MODES[mode], stream_ptr()]
        entry, what = conv3._entry(), "mp_conv3"
    elif name == "window_attention":
        launch, _, held = window_attention._prepare(*args, kw.get("shift", 0), kw.get("eps", 1e-5))
        entry, what = window_attention._entry(), "mp_window_attention"
    elif name == "mlp":
        launch, _, held = mlp._prepare(*args, kw.get("residual", False), kw.get("dp_scale"),
                                       kw.get("eps", 1e-5))
        entry, what = mlp._entry(), "mp_mlp"
    elif name == "spectral_apply":
        launch, _, held = spectral._apply_prepare(*args, **kw)
        entry, what = spectral._apply_entry(), "mp_spectral_apply"
    elif name == "spectral_stats":
        launch, _, held = spectral._stats_prepare(*args, **kw)
        entry, what = spectral._stats_entry(), "mp_spectral_stats"
    elif name == "gdfn":
        launch, _, held = gdfn._prepare(*args, **kw)
        entry, what = gdfn._entry(), "mp_gdfn"
    elif name == "window_msa":
        launch, _, held = window_msa._prepare(*args, kw.get("labels"))
        entry, what = window_msa._entry(), "mp_window_msa"
    else:
        raise KeyError(name)
    _build.check(what, entry(*launch))
    ms = time_ms(lambda: entry(*launch), 20)
    del held
    return ms


def tflops(spec, args, kw, flops, ms, lib_ms) -> dict:
    """For the kernels of ALONE: the kernel-alone time, and the achieved
    rates (flops / ms) of the wrapper, the kernel alone and its library
    yardstick."""
    if spec[0] not in ALONE:
        return {}
    kms = kernel_alone_ms(spec[0], args, kw)
    return dict(kernel_ms=kms, tflops=flops / ms / 1e9, kernel_tflops=flops / kms / 1e9,
                library_tflops=None if lib_ms is None else flops / lib_ms / 1e9)


def front_split(spec, fn, args, kw) -> dict:
    """A spectral apply call with the PGSSTB tail timed once more on the same
    inputs without it (mlp=None): the front's time through the wrapper,
    alone and as its plain version, its bound and rates (apply_cost); the
    tail's time is the difference."""
    from mp_hsir_tpu_torch.ops.kernels._route import plain_reference

    if spec[0] != "spectral_apply" or not kw.get("mlp"):
        return {}
    front = dict(kw, mlp=None)
    compare(fn, args, front, BF16_TOL)
    _, b, h, w, c1, c2, _, _, _, gate, short = spec[:11]
    byts, flops = apply_cost(b, h, w, c1 + c2, args[0].element_size(), gate, short)
    ms, kms = time_ms(lambda: fn(*args, **front), 10), kernel_alone_ms(spec[0], args, front)

    def plain():
        with plain_reference():
            return fn(*args, **front)

    return dict(front_ms=ms, front_kernel_ms=kms, front_plain_ms=time_ms(plain, 3),
                front_flops=flops,
                front_bound_ms=max(byts / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3,
                front_tflops=flops / ms / 1e9, front_kernel_tflops=flops / kms / 1e9)


def has_tail_f32() -> bool:
    """Whether this checkout's package has the float32 tail tile (an older
    checkout measured with this file has not: its float32 tail is SIMT)."""
    from mp_hsir_tpu_torch.ops.kernels import mlp

    return hasattr(mlp, "TAIL_F32")


def tail_f32_specs(specs: Counter) -> Counter:
    """The float32 tail tile's launches of a multiset of calls: one per
    float32 spectral_apply call with the tail and per float32 mlp call, as
    ("mlp_tail_f32", B, H, W, C, hid); none where the package has no such
    tile."""
    out: Counter = Counter()
    if not has_tail_f32():
        return out
    for spec, n in specs.items():
        if spec[-1] != "torch.float32":
            continue
        if spec[0] == "spectral_apply" and spec[11]:
            out[("mlp_tail_f32", *spec[1:4], spec[4] + spec[5], spec[11])] += n
        elif spec[0] == "mlp":
            out[("mlp_tail_f32", *spec[1:6])] += n
    return out


def has_f32_tiles() -> bool:
    """Whether this checkout's package has the float32 conv3 and window
    tiles (an older checkout measured with this file has not: both are
    SIMT there)."""
    from mp_hsir_tpu_torch.ops.kernels import conv3, window_attention

    return hasattr(conv3, "F32_TILE") and hasattr(window_attention, "F32_TILE")


def has_stats_f32_tile() -> bool:
    """Whether this checkout's package has the float32 spectral stats tile
    (an older checkout measured with this file has not: its float32 stats
    kernel is SIMT, with a channel chunk)."""
    from mp_hsir_tpu_torch.ops.kernels import spectral

    return hasattr(spectral, "F32_TILE")


def has_apply_f32_tile() -> bool:
    """Whether this checkout's package has the float32 spectral apply tile
    (an older checkout measured with this file has not: its float32 apply
    front is SIMT, with a channel chunk)."""
    from mp_hsir_tpu_torch.ops.kernels import spectral

    return hasattr(spectral, "APPLY_F32")


def has_gdfn_f32_tile() -> bool:
    """Whether this checkout's package has the float32 GDFN tile (an older
    checkout measured with this file has not: its float32 GDFN is SIMT,
    with a channel chunk)."""
    from mp_hsir_tpu_torch.ops.kernels import gdfn

    return hasattr(gdfn, "F32_TILE")


def f32_tile_specs(specs: Counter) -> Counter:
    """The float32 conv3, window, stats, apply and GDFN tiles' launches of a
    multiset of calls: one per float32 conv3 call, as ("conv3_f32", B, H, W,
    Cin, Cout, mode), per float32 window_attention call, as
    ("window_attention_f32", B, H, W, C, heads, shift), per float32
    spectral_stats call, as ("spectral_stats_f32", B, H, W, C1, C2, heads,
    shift, ln), per float32 spectral_apply call, as ("spectral_apply_f32",
    B, H, W, C1, C2, shift, ln, residual, gate, shortcut, hid), and per
    float32 gdfn call, as ("gdfn_f32", B, H, W, C, hid, Co, residual); none
    for the tiles the package does not have."""
    out: Counter = Counter()
    kinds = (("conv3", "window_attention") if has_f32_tiles() else ()) + (
        ("spectral_stats",) if has_stats_f32_tile() else ()) + (
        ("spectral_apply",) if has_apply_f32_tile() else ()) + (
        ("gdfn",) if has_gdfn_f32_tile() else ())
    for spec, n in specs.items():
        if spec[-1] == "torch.float32" and spec[0] in kinds:
            out[(spec[0] + "_f32", *spec[1:-1])] += n
    return out


def f32_bound_ms(byts, flops) -> float:
    """A float32 call's bound: its bytes at the HBM rate or three TF32
    products per float32 product at the TF32 rate, the larger."""
    return max(byts / HBM_BYTES_PER_S, 3 * flops / TF32_FLOPS) * 1e3


def f32_times(spec, fn, args, kw, byts, flops) -> dict:
    """A float32 call timed: through its wrapper, alone (the kernels of
    ALONE), as its plain version, beside its float32 bound (a call that runs
    a float32 tile is first run twice: bitwise equal); a conv3 call
    beside F.conv2d (TF32 off). A spectral_apply call with the tail is timed
    once more without it (wrapper, alone, plain; the front's bound): the
    difference is the tail's time, beside the tail's bound (its weights read
    once; 6 C hid flops per pixel)."""
    from mp_hsir_tpu_torch.ops.kernels._route import plain_reference

    def plain(kw=kw):
        with plain_reference():
            return fn(*args, **kw)

    if (spec[0] == "mlp" or spec[0] == "spectral_apply" and kw.get("mlp")
            or spec[0] in ("conv3", "window_attention") and has_f32_tiles()
            or spec[0] == "spectral_stats" and has_stats_f32_tile()
            or spec[0] == "spectral_apply" and has_apply_f32_tile()
            or spec[0] == "gdfn" and has_gdfn_f32_tile()):
        # the float32 tail, conv3, window, stats, apply and GDFN tiles sum in
        # a fixed order, with no float atomics
        if not all(torch.equal(a, b) for a, b in zip(_flat(fn(*args, **kw)),
                                                     _flat(fn(*args, **kw)))):
            raise AssertionError(f"{spec[0]} {spec[1:-1]}: two float32 calls differ")
    row = dict(f32_ms=time_ms(lambda: fn(*args, **kw), 10), f32_plain_ms=time_ms(plain, 3),
               f32_bound_ms=f32_bound_ms(byts, flops), f32_flops=flops)
    if spec[0] in ALONE:
        row["f32_kernel_ms"] = kernel_alone_ms(spec[0], args, kw)
    if spec[0] == "conv3":
        x, w, *_ = args
        xc, wl = x.permute(0, 3, 1, 2), w.float()
        row["f32_library_ms"] = time_ms(lambda: torch.nn.functional.conv2d(xc, wl, padding=1), 10)
    if spec[0] == "spectral_apply" and kw.get("mlp"):
        front = dict(kw, mlp=None)
        _, b, h, w, c1, c2, _, _, _, gate, short = spec[:11]
        c, hid = c1 + c2, spec[11]
        fb, ff = apply_cost(b, h, w, c, 4, gate, short)
        row.update(f32_front_ms=time_ms(lambda: fn(*args, **front), 10),
                   f32_front_kernel_ms=kernel_alone_ms(spec[0], args, front),
                   f32_front_plain_ms=time_ms(lambda: plain(front), 3),
                   f32_front_bound_ms=f32_bound_ms(fb, ff),
                   f32_tail_bound_ms=f32_bound_ms(4 * (3 * c * hid + 2 * hid + 3 * c),
                                                  6 * b * h * w * c * hid),
                   f32_tail_flops=6 * b * h * w * c * hid)
    return row


def log_f32(row) -> str:
    if "f32_ms" not in row:
        return ""
    alone = f", alone {row['f32_kernel_ms']:.4f}" if "f32_kernel_ms" in row else ""
    lib = f", F.conv2d {row['f32_library_ms']:.4f}" if "f32_library_ms" in row else ""
    tail = ("" if "f32_front_ms" not in row else
            f"; without the tail {row['f32_front_ms']:.4f} (alone "
            f"{row['f32_front_kernel_ms']:.4f}): tail {row['f32_ms'] - row['f32_front_ms']:.4f}, "
            f"bound {row['f32_tail_bound_ms']:.4f}")
    return (f"\n      float32: {row['f32_ms']:.4f} ms{alone}, plain {row['f32_plain_ms']:.3f}, "
            f"bound {row['f32_bound_ms']:.4f}{lib}{tail}")


def tflop_rate(flops, ms) -> float:
    """flops / ms in TFLOP/s (nan where a difference of two times is not positive)."""
    return flops / ms / 1e9 if ms > 0 else float("nan")


def front_sums(rows, per: str) -> dict:
    """The float32 apply fronts of a path's calls summed (wrapper, alone,
    plain, bound): a call with the tail counts its run without it, a call
    without the tail (PromptFusion) itself."""
    def one(r, k):
        return r[k.replace("f32_", "f32_front_")] if "f32_front_ms" in r else r[k]
    tot = lambda k: sum(one(r, k) * r[per] for r in rows)  # noqa: E731
    return dict(calls=sum(r[per] for r in rows), ms=tot("f32_ms"),
                kernel_alone_ms=tot("f32_kernel_ms"), plain_ms=tot("f32_plain_ms"),
                bound_ms=tot("f32_bound_ms"), max_abs_err=max(r["max_abs_err_f32"] for r in rows),
                rel_err=max(r["rel_err_f32"] for r in rows))


def log_f32_sums(what: str, rows, per: str) -> dict:
    """The float32 calls summed per kernel over the path (wrapper, alone,
    plain, bound, F.conv2d), the spectral_apply calls with the tail split
    into front and tail (each beside its bound), the float32 tail tile's
    row for the kernels line, and the apply fronts (the float32 apply
    tile's row): the PGSSTB calls' fronts and the PromptFusion calls
    apart, each beside its bound."""
    out = {}
    mine = [r for r in rows if "f32_ms" in r]
    log(f"  float32 calls {what}: ms through the wrapper, alone, plain, bound "
        f"max(bytes / 3.35 TB/s, 3 flops / 495 TFLOP/s), library")
    for name in sorted({r["spec"][0] for r in mine}):
        rs = [r for r in mine if r["spec"][0] == name]
        tot = lambda k, rs=rs: sum(r[k] * r[per] for r in rs)  # noqa: E731
        d = dict(ms=tot("f32_ms"), plain_ms=tot("f32_plain_ms"), bound_ms=tot("f32_bound_ms"),
                 calls=sum(r[per] for r in rs), max_abs_err=max(r["max_abs_err_f32"] for r in rs),
                 rel_err=max(r["rel_err_f32"] for r in rs))
        if all("f32_kernel_ms" in r for r in rs):
            d["kernel_alone_ms"] = tot("f32_kernel_ms")
        if all("f32_library_ms" in r for r in rs):
            d["library_ms"] = tot("f32_library_ms")
        out[name] = d
        log(f"    {name:18s} {d['ms']:9.3f} ms  alone "
            f"{d.get('kernel_alone_ms', float('nan')):9.3f}  plain {d['plain_ms']:9.3f}  bound "
            f"{d['bound_ms']:.4f}  library {d.get('library_ms', '-')}  ({d['calls']} calls)")
    tails = [r for r in mine if "f32_front_ms" in r]
    if tails:
        tot = lambda k: sum(r[k] * r[per] for r in tails)  # noqa: E731
        t = dict(calls=sum(r[per] for r in tails), ms=tot("f32_ms") - tot("f32_front_ms"),
                 kernel_alone_ms=tot("f32_kernel_ms") - tot("f32_front_kernel_ms"),
                 plain_ms=tot("f32_plain_ms") - tot("f32_front_plain_ms"),
                 bound_ms=tot("f32_tail_bound_ms"), flops=tot("f32_tail_flops"),
                 front_ms=tot("f32_front_ms"), front_kernel_ms=tot("f32_front_kernel_ms"),
                 front_plain_ms=tot("f32_front_plain_ms"), front_bound_ms=tot("f32_front_bound_ms"),
                 with_tail_ms=tot("f32_ms"), with_tail_kernel_ms=tot("f32_kernel_ms"),
                 max_abs_err=max(r["max_abs_err_f32"] for r in tails),
                 rel_err=max(r["rel_err_f32"] for r in tails))
        out["spectral_apply_split"] = t
        log(f"    spectral_apply, the {t['calls']} calls with the PGSSTB tail: wrapper "
            f"{t['with_tail_ms']:.3f} ms = front {t['front_ms']:.3f} + tail {t['ms']:.3f}; "
            f"alone {t['with_tail_kernel_ms']:.3f} = front {t['front_kernel_ms']:.3f} + tail "
            f"{t['kernel_alone_ms']:.3f}; plain front {t['front_plain_ms']:.3f} + tail "
            f"{t['plain_ms']:.3f}; bounds front {t['front_bound_ms']:.4f}, tail "
            f"{t['bound_ms']:.4f} ms; tail {tflop_rate(t['flops'], t['ms']):.1f} TFLOP/s through "
            f"the wrapper, {tflop_rate(t['flops'], t['kernel_alone_ms']):.1f} alone")
    applies = [r for r in mine if r["spec"][0] == "spectral_apply"]
    if applies:
        fr = front_sums(applies, per)
        for part, rs in (("pgsstb", [r for r in applies if "f32_front_ms" in r]),
                         ("fusion", [r for r in applies if "f32_front_ms" not in r])):
            if rs:
                fr[part] = front_sums(rs, per)
        out["spectral_apply_front"] = fr
        log(f"    spectral_apply fronts, all {fr['calls']} calls: wrapper {fr['ms']:.3f} ms, alone "
            f"{fr['kernel_alone_ms']:.3f}, plain {fr['plain_ms']:.3f}, bound {fr['bound_ms']:.4f}; "
            + "; ".join(f"{k} ({fr[k]['calls']} calls) wrapper {fr[k]['ms']:.3f} ms, alone "
                        f"{fr[k]['kernel_alone_ms']:.3f}, plain {fr[k]['plain_ms']:.3f}, bound "
                        f"{fr[k]['bound_ms']:.4f}" for k in ("pgsstb", "fusion") if k in fr))
    return out


def log_tflops(row) -> str:
    if "tflops" not in row:
        return ""
    lib = row["library_tflops"]
    front = ("" if "front_ms" not in row else
             f"; without the tail {row['front_ms']:.4f} ms ({row['front_tflops']:.1f} TFLOP/s), "
             f"alone {row['front_kernel_ms']:.4f} ({row['front_kernel_tflops']:.1f}), "
             f"front bound {row['front_bound_ms']:.4f}")
    return (f"  {row['tflops']:.1f} TFLOP/s; kernel alone {row['kernel_ms']:.4f} ms "
            f"{row['kernel_tflops']:.1f} TFLOP/s (lib {'-' if lib is None else f'{lib:.1f}'})"
            + front)


def log_alone_sums(what: str, rows, per: str) -> None:
    """Each kernel of ALONE summed over the path's calls: wrapper, kernel
    alone and library call, with the rates of the sums."""
    for name, lib_name in ALONE.items():
        mine = [r for r in rows if r["spec"][0] == name and "kernel_ms" in r]
        if not mine:
            continue
        tot = lambda k: sum(r[k] * r[per] for r in mine)  # noqa: E731
        flops = tot("flops") / 1e9
        lib = ""
        if lib_name is not None and all(r["library_ms"] is not None for r in mine):
            lib = f", {lib_name} {tot('library_ms'):.4f} ms ({flops / tot('library_ms'):.1f} TFLOP/s)"
        log(f"  {name} {what}: wrapper {tot('ms'):.4f} ms ({flops / tot('ms'):.1f} TFLOP/s), "
            f"kernel alone {tot('kernel_ms'):.4f} ms ({flops / tot('kernel_ms'):.1f} TFLOP/s)"
            f"{lib} ({sum(r[per] for r in mine)} calls), bound {tot('bound_ms'):.4f} ms")
        tails = [r for r in mine if "front_ms" in r]
        if tails:
            tot_t = lambda k: sum(r[k] * r[per] for r in tails)  # noqa: E731
            ff = tot_t("front_flops") / 1e9
            log(f"    of it the {sum(r[per] for r in tails)} calls with the PGSSTB tail: wrapper "
                f"{tot_t('ms'):.4f} ms = front {tot_t('front_ms'):.4f} + tail "
                f"{tot_t('ms') - tot_t('front_ms'):.4f}; alone {tot_t('kernel_ms'):.4f} ms = front "
                f"{tot_t('front_kernel_ms'):.4f} + tail "
                f"{tot_t('kernel_ms') - tot_t('front_kernel_ms'):.4f}; their fronts: bound "
                f"{tot_t('front_bound_ms'):.4f} ms, plain {tot_t('front_plain_ms'):.4f} ms, "
                f"{ff / tot_t('front_ms'):.1f} TFLOP/s, alone {ff / tot_t('front_kernel_ms'):.1f}")
        fronts = [r for r in mine if r["spec"][0] == "spectral_apply" and "front_ms" not in r]
        if fronts:  # the calls without the tail are fronts alone
            tot_f = lambda k: sum(r[k] * r[per] for r in fronts)  # noqa: E731
            ff = tot_f("flops") / 1e9
            log(f"    the {sum(r[per] for r in fronts)} calls without the tail (fronts): wrapper "
                f"{tot_f('ms'):.4f} ms ({ff / tot_f('ms'):.1f} TFLOP/s), alone "
                f"{tot_f('kernel_ms'):.4f} ({ff / tot_f('kernel_ms'):.1f}), bound "
                f"{tot_f('bound_ms'):.4f} ms")


def kernel_checks(specs: Counter, dev) -> dict:
    from mp_hsir_tpu_torch.ops.kernels._route import plain_reference

    rows = []
    for spec, mult in sorted(specs.items(), key=lambda kv: str(kv[0])):
        fn, args, kw, library, byts, flops = make_call(spec, dev, torch.bfloat16)
        err, rel = compare(fn, args, kw, BF16_TOL)
        f32spec = spec[:-1] + ("torch.float32",)
        f_fn, f_args, f_kw, _, f_byts, f_flops = make_call(f32spec, dev, torch.float32)
        err32, rel32 = compare(f_fn, f_args, f_kw, F32_TOL)
        f32 = f32_times(f32spec, f_fn, f_args, f_kw, f_byts, f_flops)
        del f_args, f_kw
        ms = time_ms(lambda: fn(*args, **kw), 10)

        def plain():
            with plain_reference():
                return fn(*args, **kw)

        plain_ms = time_ms(plain, 3)
        lib_ms = time_ms(library, 10) if library is not None else None
        bound_ms = max(byts / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
        plan = plan_of(spec)
        streamed = streamed_ms(spec, fn, args, kw)
        row = dict(spec=list(spec), per_forward=mult, max_abs_err=err, rel_err=rel,
                   max_abs_err_f32=err32, rel_err_f32=rel32, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound_ms, bytes=byts, flops=flops,
                   bound_by="bytes" if byts / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations",
                   smem=plan["smem"], smem_whole=plan["smem_whole"], kc=plan["kc"],
                   blocks_per_window=plan.get("blocks_per_window"),
                   streamed=streamed, **tflops(spec, args, kw, flops, ms, lib_ms),
                   **front_split(spec, fn, args, kw), **f32)
        rows.append(row)
        log(f"  {spec[0]:16s} {str(spec[1:-1]):58s} x{mult:<2d} err {err:.2e} (rel {rel:.1e}, "
            f"f32 rel {rel32:.1e})  {ms:8.3f} ms  plain {plain_ms:8.3f}  "
            f"lib {'-' if lib_ms is None else f'{lib_ms:.3f}'}  bound {bound_ms:.4f} ({row['bound_by']})  "
            + log_plan(plan)
            + log_streamed_call(streamed) + log_tflops(row) + log_f32(row))
        del args, kw
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def quality_cube(seed: int, size: int, bands: int = 31):
    """The smooth band-correlated cube of tests/test_quality_artifact.py
    (31 bands; ``bands`` samples the same spectral curves more finely),
    tiled to size x size, and its sigma=70 mode-0 degradation."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((4, 8, 8)).astype(np.float32)
    maps = np.stack([np.kron(b, np.ones((8, 8), np.float32)) for b in base])
    t = np.linspace(0, 1, bands, dtype=np.float32)
    mix = np.stack([np.sin(2 * np.pi * (f * t + p))
                    for f, p in ((1.0, 0.0), (1.5, 0.3), (0.7, 0.6), (2.0, 0.9))])
    clean = np.einsum("kc,khw->chw", mix, maps)
    clean -= clean.min()
    clean /= clean.max() + 1e-9
    clean = np.tile(clean, (1, size // 64, size // 64)).astype(np.float32)
    noise = np.random.default_rng(2024).standard_normal(clean.shape) * (70 / 255.0)
    return clean, np.clip(clean + noise, 0.0, 1.0).astype(np.float32)


def band_psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    from mp_hsir_tpu_torch.ops.metrics import psnr_per_band

    return float(psnr_per_band(a.float().clamp(0, 1), b.float()).mean())


def main_path(dev, expected: Counter, model, clean, degraded, label: str, gain_floor,
              fault_block, bf16_tol) -> dict:
    """Requests through ``model`` (bf16, eval), then the float32, bf16 and
    planted-fault checks. ``gain_floor``: the least PSNR gain over the
    degraded cube (None: not checked, for random weights); ``fault_block``:
    a shifted PGSSTB of the model to plant the faults in; ``bf16_tol``: the
    bound on the bf16 kernel forward's max-abs distance from the plain bf16
    forward, over the output's max-abs (None: read, not held)."""
    import dataclasses

    from mp_hsir_tpu_torch.models import layers as L
    from mp_hsir_tpu_torch.ops.kernels import _route

    cfg = model.cfg
    x = torch.from_numpy(degraded)[None].to(dev)
    c = torch.from_numpy(clean)[None].to(dev)
    tid = torch.zeros(1, dtype=torch.long, device=dev)
    with torch.inference_mode():
        t0 = time.perf_counter()
        model(x, tid)
        torch.cuda.synchronize()
        log(f"  warm-up forward {time.perf_counter() - t0:.3f} s")
        torch.cuda.reset_peak_memory_stats()
        _route.reset_counters()
        L.reset_path_stats()
        times, enqueue, out = [], [], None
        for _ in range(REQUESTS):
            t0 = time.perf_counter()
            out = model(x, tid)
            enqueue.append((time.perf_counter() - t0) * 1e3)  # host time to issue the forward
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        counts = {name: cnt.launches for name, cnt in _route.COUNTERS.items()}
        recorded = Counter()
        for cnt in _route.COUNTERS.values():
            recorded.update(cnt.specs)
        plain_calls = _route.ROUTE.plain_cuda_calls
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  ms per cube ({label}, {REQUESTS} requests): "
        f"{' '.join(f'{t:.2f}' for t in times)}; median {statistics.median(times):.2f}; "
        f"host issue time median {statistics.median(enqueue):.2f}; peak memory {peak_gib:.2f} GiB")
    log(f"  launches: {json.dumps(counts)}; plain versions on CUDA tensors: {plain_calls}; "
        f"route stats: {json.dumps(L.PATH_STATS)}")
    if plain_calls:
        fail(f"{plain_calls} plain-version calls on CUDA tensors in the kernel run")
    want = Counter({k: v * REQUESTS for k, v in expected.items()})
    if recorded != want:
        fail(f"kernel calls differ from the checked path: extra {dict(recorded - want)}, "
             f"missing {dict(want - recorded)}")
    per_kernel = Counter()
    for spec, n in expected.items():
        per_kernel[spec[0]] += n
    for name in KERNELS:
        if counts.get(name, 0) != per_kernel[name] * REQUESTS or per_kernel[name] == 0:
            fail(f"{name}: {counts.get(name, 0)} launches, expected {per_kernel[name] * REQUESTS}")
    if not torch.isfinite(out).all() or tuple(out.shape) != tuple(x.shape):
        fail(f"output not finite or shape {tuple(out.shape)}")
    p_deg, p_res = band_psnr(x, c), band_psnr(out, c)
    log(f"  PSNR degraded {p_deg:.3f} dB, restored (bf16 kernels) {p_res:.3f} dB, "
        f"gain {p_res - p_deg:.3f} dB")
    if gain_floor is not None and p_res - p_deg < gain_floor:
        fail(f"restored PSNR is less than {gain_floor} dB above the degraded input")

    # float32: the model's plain path on the card (TF32 off) against the
    # kernel path, then the bf16 kernel path's PSNR against it
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    model.cfg = dataclasses.replace(cfg, compute_dtype="float32")
    with torch.inference_mode():
        out32 = model(x, tid)
        with _route.plain_reference():
            ref32 = model(x, tid)
    torch.cuda.synchronize()
    err32 = (out32 - ref32).abs().max().item()
    p_ref, p32 = band_psnr(ref32, c), band_psnr(out32, c)
    log(f"  float32: kernels vs plain max abs err {err32:.3e} (output max abs "
        f"{ref32.abs().max().item():.3f}); PSNR plain {p_ref:.4f} dB, "
        f"kernels {p32:.4f} dB; bf16 kernels - plain f32 = {p_res - p_ref:+.4f} dB")
    if err32 > MODEL_F32_TOL:
        fail(f"float32 kernel path differs from the plain path by more than {MODEL_F32_TOL}")
    if abs(p_res - p_ref) > MODEL_PSNR_TOL:
        fail(f"bf16 kernel path PSNR differs from the float32 plain path by more than "
             f"{MODEL_PSNR_TOL} dB")
    planted = planted_faults(model, x, tid, c, ref32, 1.0, fault_block, MODEL_F32_TOL,
                             F32_FAULTS, "float32, max abs err")

    # bf16: the last request's output against the model's plain bf16 path on
    # the card, both rounding at the same points
    model.cfg = cfg
    with torch.inference_mode(), _route.plain_reference():
        ref16 = model(x, tid)
    torch.cuda.synchronize()
    scale16 = ref16.float().abs().max().item()
    diff16 = out.float() - ref16.float()
    err16 = diff16.abs().max().item() / scale16
    norm16 = (diff16.norm() / ref16.float().norm()).item()
    log(f"  bf16: kernels vs plain bf16 max abs err / output max abs {err16:.3e} (bound "
        f"{bf16_tol}, output max abs {scale16:.3f}); norm-wise {norm16:.3e}")
    if bf16_tol is not None and err16 > bf16_tol:
        fail(f"bf16 kernel path differs from the plain bf16 path by more than {bf16_tol} of the "
             f"output's max abs")
    planted16 = planted_faults(model, x, tid, c, ref16, scale16, fault_block, bf16_tol,
                               BF16_FAULTS, "bf16, max abs err / output max abs")
    return dict(ms_per_cube=times, median_ms=statistics.median(times), host_issue_ms=enqueue,
                launches=counts, peak_gib=peak_gib, psnr_degraded=p_deg, psnr_restored=p_res,
                psnr_plain_f32=p_ref, psnr_kernels_f32=p32, max_abs_err_f32=err32,
                planted=planted, rel_err_bf16=err16, norm_err_bf16=norm16, planted_bf16=planted16)


def planted_faults(model, x, tid, c, ref, scale, blk, bound, caught, what) -> dict:
    """Faults planted in one shifted block of the model's plain path (in the
    dtype of ``model.cfg``), read against the sound plain path ``ref`` as
    max-abs / ``scale``: the model-level ``bound`` must catch each fault
    named in ``caught``, or it would not catch a kernel that made the same
    fault (None: read only)."""
    from mp_hsir_tpu_torch.ops.kernels import _route

    if not blk.shift:
        fail("the block chosen for the planted faults is expected to be a shifted block")
    readings = {}
    p_ref = band_psnr(ref, c)

    def read(name):
        with torch.inference_mode(), _route.plain_reference():
            out = model(x, tid)
        diff = out.float() - ref.float()
        err, dp = diff.abs().max().item() / scale, band_psnr(out, c) - p_ref
        norm = (diff.norm() / ref.float().norm()).item()
        readings[name] = dict(max_abs_err=err, norm_err=norm, psnr_delta=dp)
        log(f"  planted fault '{name}' ({what}): {err:.3e}, norm-wise {norm:.3e}, "
            f"PSNR {dp:+.4f} dB")

    shift, blk.shift = blk.shift, 0
    read("block run unshifted")
    blk.shift = shift
    proj = blk.attn.proj.weight
    with torch.no_grad():
        saved = proj.clone()
        proj.copy_(saved.t())
        read("window projection transposed")
        proj.copy_(saved)
    for name, r in readings.items():
        if bound is not None and name in caught and r["max_abs_err"] <= bound:
            fail(f"planted fault '{name}' stays within the {bound} model bound ({what})")
    return readings


def run_cli(data_type: str = "natural_scene", size: int = SIZE, bands: int = 31,
            ckpt: str = ART, psnr_floor=14.2) -> dict:
    """The port's mode-0 CLI on two quality cubes; ``psnr_floor`` None skips
    the PSNR check (random weights)."""
    import scipy.io as sio

    with tempfile.TemporaryDirectory(dir=os.getcwd(), prefix=".smoke_cubes_") as d:
        for i, seed in enumerate((991, 992)):
            clean, _ = quality_cube(seed, size, bands)
            sio.savemat(os.path.join(d, f"cube_{i}.mat"), {"data": clean.transpose(1, 2, 0)})
        cmd = [sys.executable, "-m", "mp_hsir_tpu_torch.cli.test_cli", "--mode", "0",
               "--test_dir", d, "--data_type", data_type, "--no_save_images"]
        if ckpt:
            cmd += ["--ckpt_path", ckpt]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        secs = time.perf_counter() - t0
    log("  " + "\n  ".join(r.stdout.strip().splitlines()))
    if r.returncode != 0:
        fail(f"CLI exited {r.returncode}: {r.stderr[-3000:]}")
    lines = r.stdout.strip().splitlines()
    if (len(lines) != 4 or lines[0] != "Start gaussian denoise testing sigma=70"
            or lines[1] != "Total Test HSIs Ids : 2"
            or not lines[2].startswith("Denoise sigma=70: psnr: ")
            or not lines[3].startswith("Denoise sigma=70: sam: ")):
        fail(f"CLI stdout lines differ from the contract: {lines}")
    psnr = float(lines[2].split("psnr: ")[1].split(",")[0])
    # sigma=70 noise on [0, 1] data is ~11.2 dB; the trained weights restore well above it
    if not np.isfinite(psnr) or (psnr_floor is not None and psnr < psnr_floor):
        fail(f"CLI PSNR {psnr} is not finite or below {psnr_floor}")
    return dict(stdout=lines, seconds=secs, psnr=psnr)


# ---------------------------------------------------------------------------
# phases 5-6: the training route
# ---------------------------------------------------------------------------

def train_path_specs(cfg, b: int, size: int, dt: str) -> Counter:
    """Per-step multiset of the kernel calls of the flagship train step
    (forward and backward), in the wrappers' spec format. conv3 counts the
    forward and the backward's dx launches; the patch embed's input needs no
    gradient, so it has no dx launch."""
    specs: Counter = Counter()
    d, nb = cfg.dim, cfg.num_blocks
    dpr = np.linspace(0.0, cfg.drop_path_max, sum(nb))
    rates = (dpr[:nb[0]], dpr[nb[0]:nb[0] + nb[1]], dpr[nb[0] + nb[1]:])
    ref_rates = [rates[1][i % nb[1]] for i in range(cfg.num_refinement_blocks)]
    levels = [(size, d, cfg.heads[0], rates[0], 0), (size // 2, 2 * d, cfg.heads[1], rates[1], 1),
              (size // 4, 4 * d, cfg.heads[2], rates[2], 2),
              (size // 2, 2 * d, cfg.heads[1], rates[1], 1), (size, 2 * d, cfg.heads[0], rates[0], 0),
              (size, 2 * d, cfg.heads[0], ref_rates, 0)]
    for res, c, nh, rr, level in levels:
        frozen = min(cfg.train_resolution) >> level
        hid = int(c * cfg.ffn_expansion_factor)
        for i, rate in enumerate(rr):
            shift = 0 if (i % 2 == 0 or frozen <= 8) else 4
            dp = bool(rate > 0)
            for spec in (("window_attention", b, res, res, c, nh, shift),
                         ("window_attention_bwd", b, res, res, c, nh, shift),
                         ("spectral_stats", b, res, res, c, 0, nh, shift, False),
                         ("spectral_stats_bwd", b, res, res, c, nh, shift, False),
                         ("spectral_apply", b, res, res, c, 0, shift, False, False, True, True, 0)
                         + (("dp",) if dp else ()),
                         ("spectral_apply_bwd", b, res, res, c, shift, False, False, True, dp),
                         ("mlp", b, res, res, c, hid, True, dp),
                         ("mlp_bwd", b, res, res, c, hid, True, dp)):
                specs[spec + (dt,)] += 1
    for res, c, nh in ((size // 2, 4 * d, 8), (size, 2 * d, 4)):  # fusion2, fusion1 (concat)
        hid = int(c * cfg.ffn_expansion_factor)
        for spec in (("spectral_stats", b, res, res, c, 0, nh, 0, True),
                     ("spectral_stats_bwd", b, res, res, c, nh, 0, True),
                     ("spectral_apply", b, res, res, c, 0, 0, True, True, False, False, 0),
                     ("spectral_apply_bwd", b, res, res, c, 0, True, True, False, False),
                     ("gdfn", b, res, res, c, hid, c, True), ("gdfn_bwd", b, res, res, c, hid, True)):
            specs[spec + (dt,)] += 1
    s2, s4 = size // 2, size // 4
    convs = ((size, size, cfg.in_channels, d, "plain"), (size, size, d, d // 2, "down"),
             (s2, s2, 2 * d, d, "down"), (s4, s4, 4 * d, 8 * d, "up"), (s2, s2, 2 * d, 4 * d, "up"),
             (s2, s2, 2 * d, 2 * d, "plain"), (size, size, d, d, "plain"),
             (size, size, 2 * d, cfg.out_channels, "res"))
    for i, (h, w, cin, cout, mode) in enumerate(convs):
        specs[("conv3", b, h, w, cin, cout, mode, dt)] += 1
        if i:
            specs[("conv3", b, h, w, cout, cin, "plain", dt)] += 1
    for spec, k in list(specs.items()):
        for call in wgrad_calls(spec):
            specs[("wgrad",) + call + (dt,)] += k
    return specs


def wgrad_calls(spec) -> list:
    """The wgrad calls (nb, P, M, N) of one backward kernel call, in its
    order: mlp_bwd and gdfn_bwd dW1 / dW_in (C, 2 hid) then dW2 / dW_out
    (hid, C); window_attention_bwd dWqkv (C, 3C) then dWp (C, C);
    spectral_stats_bwd dWqk (C, 2C); spectral_apply_bwd dWv (C, C) then
    dcomb per image."""
    name, b, h, w, c = spec[:5]
    p = b * h * w
    if name in ("mlp_bwd", "gdfn_bwd"):
        return [(1, p, c, 2 * spec[5]), (1, p, spec[5], c)]
    if name == "window_attention_bwd":
        return [(1, p, c, 3 * c), (1, p, c, c)]
    if name == "spectral_stats_bwd":
        return [(1, p, c, 2 * c)]
    if name == "spectral_apply_bwd":
        return [(1, p, c, c), (b, h * w, c, c)]
    return []


def make_bwd_call(spec, dev, dt):
    """(backward kernel fn, its plain version, bytes, flops) for one backward
    spec: both take the same forward inputs and output cotangent. Bound:
    twice the forward's products (the input and the weight cotangents),
    each input and output read or written once."""
    from mp_hsir_tpu_torch.ops.kernels import gdfn, mlp, spectral, window_attention as wa

    name = spec[0]
    g = Inputs(zlib.crc32(repr(spec[:-1]).encode()), dev, dt)
    e = torch.tensor([], dtype=dt).element_size()
    f32 = lambda shape, s=1.0: g.n(shape, s, torch.float32)  # noqa: E731
    eps = 1e-5
    b, h, w, c = spec[1:5]
    p = b * h * w
    dpv = torch.tensor([1.25, 0.0] * (b // 2) + [1.25] * (b % 2), device=dev)
    if name == "mlp_bwd":
        hid, residual, dp = spec[5:8]
        args = (g.n((b, h, w, c)), 1 + f32((c,), 0.1), f32((c,), 0.1), g.u((2 * hid, c), c),
                g.u((2 * hid,), c), g.u((c, hid), hid), g.u((c,), hid), dpv if dp else None,
                residual, eps, g.n((b, h, w, c)))
        return (lambda: mlp._bwd_launch(*args), lambda: mlp.mlp_bwd_plain(*args),
                3 * p * c * e + 3 * c * hid * (e + 4), 12 * p * c * hid)
    if name == "window_attention_bwd":
        nh, shift = spec[5:7]
        args = (g.n((b, h, w, c)), 1 + f32((c,), 0.1), f32((c,), 0.1), g.u((3 * c, c), c),
                g.u((3 * c,), c), f32((nh, 64, 64), 0.02), g.u((c, c), c), g.u((c,), c), nh, shift,
                eps, g.n((b, h, w, c)), g.n((b, h // 8, w // 8, c)))
        return (lambda: wa._bwd_launch(*args), lambda: wa.window_attention_bwd_plain(*args),
                3 * p * c * e + p // 64 * c * e + 4 * c * c * (e + 4) + nh * 4096 * 8,
                4 * p * (4 * c * c + 128 * c))
    if name == "spectral_stats_bwd":
        nh, shift, ln = spec[5:8]
        dh = c // nh
        args = (g.n((b, h, w, c)), g.u((3 * c, c, 1, 1), c), g.u((3 * c, 1, 3, 3), 9), nh, shift,
                1 + f32((c,), 0.1) if ln else None, f32((c,), 0.1) if ln else None, eps,
                f32((b, c, dh), 1e-3), f32((b, nh, dh), 1e-3), f32((b, nh, dh), 1e-3))
        return (lambda: spectral._stats_bwd_launch(*args),
                lambda: spectral.spectral_stats_bwd_plain(*args),
                2 * p * c * e + (2 * c * c + 18 * c) * (e + 4) + 3 * b * c * dh * 4,
                2 * p * (4 * c * c + 36 * c + 2 * c * dh + 4 * c))
    if name == "spectral_apply_bwd":
        shift, ln, residual, gate, dp = spec[5:10]
        args = (g.n((b, h, w, c)), f32((b, c, c), c ** -0.5), g.u((3 * c, c, 1, 1), c),
                g.u((3 * c, 1, 3, 3), 9), shift, 1 + f32((c,), 0.1) if ln else None,
                f32((c,), 0.1) if ln else None, residual,
                g.n((b, h // 8, w // 8, c), 0.5) if gate else None, dpv if dp else None, eps,
                g.n((b, h, w, c)))
        return (lambda: spectral._apply_bwd_launch(*args),
                lambda: spectral.spectral_apply_bwd_plain(*args),
                3 * p * c * e + 2 * b * c * c * 4 + (c * c + 9 * c) * (e + 4)
                + (2 * p // 64 * c * e if gate else 0), 2 * p * (4 * c * c + 18 * c))
    if name == "gdfn_bwd":
        hid, residual = spec[5:7]
        args = (g.n((b, h, w, c)), 1 + f32((c,), 0.1), f32((c,), 0.1), g.u((2 * hid, c, 1, 1), c),
                g.u((2 * hid, 1, 3, 3), 9), g.u((c, hid, 1, 1), hid), residual, eps,
                g.n((b, h, w, c)))
        return (lambda: gdfn._bwd_launch(*args), lambda: gdfn.gdfn_bwd_plain(*args),
                3 * p * c * e + (3 * c * hid + 18 * hid) * (e + 4), 2 * p * (6 * c * hid + 36 * hid))
    raise KeyError(name)


def make_train_fwd_call(spec, dev, dt):
    """make_call for the training route's new forward kernel (mlp) and the
    apply kernel's drop-path option."""
    from mp_hsir_tpu_torch.ops.kernels import mlp

    if spec[0] != "mlp":
        return make_call(spec, dev, dt)
    _, b, h, w, c, hid, residual, dp, _ = spec
    g = Inputs(zlib.crc32(repr(spec[:-1]).encode()), dev, dt)
    e = torch.tensor([], dtype=dt).element_size()
    f32 = lambda shape, s=1.0: g.n(shape, s, torch.float32)  # noqa: E731
    args = (g.n((b, h, w, c)), 1 + f32((c,), 0.1), f32((c,), 0.1), g.u((2 * hid, c), c),
            g.u((2 * hid,), c), g.u((c, hid), hid), g.u((c,), hid))
    kw = dict(residual=residual)
    if dp:
        kw["dp_scale"] = torch.tensor([1.25, 0.0] * (b // 2) + [1.25] * (b % 2), device=dev)
    p = b * h * w
    return mlp.mlp, args, kw, None, 2 * p * c * e + 3 * c * hid * e, 6 * p * c * hid


def compare_pair(kernel, plain, tol):
    """Max-abs error of a backward kernel against its plain version (each
    output against its own scale; None outputs must agree)."""
    from mp_hsir_tpu_torch.ops.kernels._route import plain_reference

    got = kernel()
    with plain_reference():
        ref = plain()
    torch.cuda.synchronize()
    worst, worst_rel = 0.0, 0.0
    for i, (a, r) in enumerate(zip(got, ref)):
        if (a is None) != (r is None):
            raise AssertionError(f"output {i}: None on one side only")
        if a is None:
            continue
        if a.shape != r.shape:
            raise AssertionError(f"output {i}: shape {tuple(a.shape)} vs {tuple(r.shape)}")
        if not torch.isfinite(a.float()).all():
            raise AssertionError(f"output {i} not finite")
        err = (a.float() - r.float()).abs().max().item()
        scale = max(r.float().abs().max().item(), 1e-6)
        worst, worst_rel = max(worst, err), max(worst_rel, err / scale)
        if err > tol * scale:
            raise AssertionError(f"output {i}: max abs err {err:.3e} > {tol} * {scale:.3e}")
    return worst, worst_rel


MLP_BWD_STAGES = ("tile", "wgrad_dw1", "wgrad_dw2", "sums")
# the backward kernels split into stages: the module whose ctypes entry
# getter the wrapper calls (grad.cu's getter is timed too)
BWD_SPLIT = {"mlp_bwd": ("mlp", "_entry"), "spectral_stats_bwd": ("spectral", "_stats_entry"),
             "window_attention_bwd": ("window_attention", "_entry"),
             "spectral_apply_bwd": ("spectral", "_apply_entry"), "gdfn_bwd": ("gdfn", "_entry")}
# the stages named for what they are rather than by C entry (the bf16
# spectral apply and GDFN backwards'; an entry not listed keeps its name, so
# that the parent tree's split reads as before)
STAGE_NAMES = {"spectral_apply_bwd": {"mp_spectral_apply_bwd_tc": "tile 1",
                                      "mp_spectral_apply_dx_tc": "tile 2",
                                      "mp_spectral_gate_grad": "d gate", "mp_sum_parts": "sums"},
               "gdfn_bwd": {"mp_gdfn_bwd_tc": "tile 1", "mp_gdfn_dx_tc": "tile 2",
                            "mp_sum_parts": "sums"}}
# the kernels whose backward calls mp_wgrad twice: the two calls' stage keys
# (each call's first, then its second)
WGRAD_STAGES = {"mlp_bwd": MLP_BWD_STAGES[1:3],
                "window_attention_bwd": ("mp_wgrad dWqkv", "mp_wgrad dWp"),
                "spectral_apply_bwd": ("wgrad dWv", "wgrad dcomb"),
                "gdfn_bwd": ("wgrad dW_in", "wgrad dW_out")}


def bwd_split(name: str, kern, flops: float, ms: float, reps: int = 5) -> dict:
    """A backward kernel's device time by stage: every C entry its wrapper
    calls, timed with CUDA events around the call, the device held by a
    sleep kernel until the host has queued all ``reps`` calls (no host gap
    counts); the mean per call. mlp_bwd's stages are ``tile`` (bf16:
    mp_mlp_bwd_tc; the float32 route and the design before the tile:
    mp_mlp_bwd and mp_ln_linear_bwd with its part sums), ``wgrad_dw1`` and
    ``wgrad_dw2`` (a call's first and second mp_wgrad, with their part sums)
    and ``sums`` (mp_sum_parts); the other kernels' are keyed by C entry name
    (a grad.cu entry with its own part sums; the two mp_wgrad calls of
    window_attention_bwd as ``mp_wgrad dWqkv`` and ``mp_wgrad dWp``, of
    spectral_apply_bwd as ``wgrad dWv`` and ``wgrad dcomb``, of gdfn_bwd as
    ``wgrad dW_in`` and ``wgrad dW_out``; the bf16 spectral_apply_bwd's
    tiles, d gate and sums and the bf16 gdfn_bwd's tiles and sums by
    STAGE_NAMES), so that the same script splits
    the trees before and after a redesign. Their sum is the backward alone
    (``kernel_ms``), without the wrapper's host time and weight packing;
    rates are flops over the wrapper's and that time."""
    from mp_hsir_tpu_torch.ops.kernels import _grad

    mod_name, getter = BWD_SPLIT[name]
    mod = importlib.import_module(f"mp_hsir_tpu_torch.ops.kernels.{mod_name}")
    events = []

    def timed(get):
        def entry(*key):
            fn = get(*key)

            def call(*a):
                e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                e0.record()
                err = fn(*a)
                e1.record()
                events.append((fn.__name__, e0, e1))
                return err

            return call

        return entry

    kern()
    torch.cuda.synchronize()
    saved = {(mod, getter): getattr(mod, getter), (_grad, "_entry"): _grad._entry}
    try:
        for (m, attr), get in saved.items():
            setattr(m, attr, timed(get))
        torch.cuda._sleep(50_000_000)
        for _ in range(reps):
            kern()
        torch.cuda.synchronize()
    finally:
        for (m, attr), get in saved.items():
            setattr(m, attr, get)
    split: dict = dict.fromkeys(MLP_BWD_STAGES, 0.0) if name == "mlp_bwd" else {}
    n_wgrad = 0
    for entry, e0, e1 in events:
        key = entry
        if name in WGRAD_STAGES and entry == "mp_wgrad":
            key = WGRAD_STAGES[name][n_wgrad % 2]
            n_wgrad += 1
        elif name == "mlp_bwd":
            key = "sums" if entry == "mp_sum_parts" else "tile"
        else:
            key = STAGE_NAMES.get(name, {}).get(entry, entry)
        split[key] = split.get(key, 0.0) + e0.elapsed_time(e1) / reps
    alone = sum(split.values())
    return dict(split=split, kernel_ms=alone, tflops=flops / ms / 1e9,
                kernel_tflops=flops / alone / 1e9, library_tflops=None)


def log_bwd_split(name: str, what: str, rows, per: str) -> dict:
    """A backward kernel's stages summed over the path's calls (each call's
    split times its calls), beside the wrapper's time."""
    mine = [r for r in rows if r["spec"][0] == name and "split" in r]
    keys = list(dict.fromkeys(k for r in mine for k in r["split"]))
    out = {k: sum(r["split"].get(k, 0.0) * r[per] for r in mine) for k in keys}
    out.update(alone_ms=sum(r["kernel_ms"] * r[per] for r in mine),
               wrapper_ms=sum(r["ms"] * r[per] for r in mine), calls=sum(r[per] for r in mine),
               wgrad_ms=sum(out[k] for k in keys if "wgrad" in k))
    log(f"  {name} stages {what}: " + " + ".join(f"{k} {out[k]:.3f}" for k in keys)
        + f" = alone {out['alone_ms']:.3f} ms; wrapper {out['wrapper_ms']:.3f} ms "
        f"({out['calls']} calls)")
    return out


def log_wgrad_stages(what: str, splits: dict) -> float:
    """The mp_wgrad stages of the split backward kernels, summed: wgrad's
    device time inside a step's backward (the same sum for any checkout)."""
    tot = sum(v["wgrad_ms"] for v in splits.values())
    log(f"  mp_wgrad inside the backward kernels {what}: {tot:.3f} ms ("
        + ", ".join(f"{k} {v['wgrad_ms']:.3f}" for k, v in splits.items()) + ")")
    return tot


def train_kernel_checks(specs: Counter, dev, streamed: bool = True, iters: int = 10,
                        plain_iters: int = 3) -> list:
    """Every kernel of the training route (the new ones, the apply kernel's
    drop-path option and the eval kernels at the step's shapes; conv3's
    backward dx calls are conv3 calls) at every call signature of the train
    step, bf16 and float32, timed in bf16 (``iters`` calls of the kernel,
    ``plain_iters`` of the plain version, each after one warm-up call),
    with its shared-memory plan; ``streamed``: also time the resident
    forward calls streamed in 64-channel chunks."""
    from mp_hsir_tpu_torch.ops.kernels._route import plain_reference

    rows = []
    for spec in sorted(specs, key=str):
        mult, name = specs[spec], spec[0]
        if name == "wgrad":  # wgrad_checks
            continue
        f32spec = spec[:-1] + ("torch.float32",)
        library, f32 = None, {}
        if name.endswith("_bwd"):
            kern, plain, byts, flops = make_bwd_call(spec, dev, torch.bfloat16)
            err, rel = compare_pair(kern, plain, BF16_TOL)
            if name in ("spectral_apply_bwd", "gdfn_bwd"):  # no float atomics: bitwise
                one, two = kern(), kern()
                if not all(a is None or torch.equal(a, r) for a, r in zip(one, two)):
                    raise AssertionError(f"{name} {spec[1:-1]}: two bf16 calls differ")
                del one, two
            k32, p32, *_ = make_bwd_call(f32spec, dev, torch.float32)
            err32, rel32 = compare_pair(k32, p32, F32_TOL)
            del k32, p32
        else:
            fn, args, kw, library, byts, flops = make_train_fwd_call(spec, dev, torch.bfloat16)
            err, rel = compare(fn, args, kw, BF16_TOL)
            f_fn, f_args, f_kw, _, f_byts, f_flops = make_train_fwd_call(f32spec, dev,
                                                                         torch.float32)
            err32, rel32 = compare(f_fn, f_args, f_kw, F32_TOL)
            if name == "mlp":  # K6's float32 calls: the float32 tail tile
                f32 = f32_times(f32spec, f_fn, f_args, f_kw, f_byts, f_flops)
            del f_args, f_kw
            kern = lambda fn=fn, args=args, kw=kw: fn(*args, **kw)  # noqa: E731
            plain = kern
        ms = time_ms(kern, iters)
        st = (None if name.endswith("_bwd") or not streamed
              else streamed_ms(spec, fn, args, kw))
        plan = plan_of(spec)

        def run_plain():
            with plain_reference():
                return plain()

        plain_ms = time_ms(run_plain, plain_iters)
        lib_ms = time_ms(library, iters) if library is not None else None
        bound_ms = max(byts / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
        rows.append(dict(spec=list(spec), per_step=mult, max_abs_err=err, rel_err=rel,
                         max_abs_err_f32=err32, rel_err_f32=rel32, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms, bytes=byts, flops=flops,
                         bound_by="bytes" if byts / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations",
                         streamed=st, smem=plan["smem"], smem_whole=plan["smem_whole"],
                         kc=plan["kc"],
                         **(bwd_split(name, kern, flops, ms) if name in BWD_SPLIT else
                            {} if name.endswith("_bwd") else
                            tflops(spec, args, kw, flops, ms, lib_ms)), **f32))
        log(f"  {name:20s} {str(spec[1:-1]):50s} x{mult:<2d} err {err:.2e} (rel {rel:.1e}, "
            f"f32 rel {rel32:.1e})  {ms:8.3f} ms  plain {plain_ms:8.3f}  "
            f"lib {'-' if lib_ms is None else f'{lib_ms:.3f}'}  bound {bound_ms:.4f}  "
            + log_plan(plan)
            + log_streamed_call(st) + log_tflops(rows[-1]) + log_split(rows[-1])
            + log_f32(rows[-1]))
        torch.cuda.empty_cache()
    return rows


def wgrad_library(a, b):
    """(call, name): one PyTorch call of wgrad's function on the same inputs,
    torch.bmm(a^T, b) with a float32 output (cuBLAS); where this torch's bmm
    takes no out_dtype, the bf16 product torch.matmul(a^T, b), named so."""
    try:
        torch.bmm(a[:1, :16].mT, b[:1, :16], out_dtype=torch.float32)
        return (lambda: torch.bmm(a.mT, b, out_dtype=torch.float32),
                "torch.bmm(out_dtype=float32)")
    except (TypeError, RuntimeError, NotImplementedError):
        return lambda: torch.matmul(a.mT, b), "torch.matmul in bf16 (bmm has no out_dtype here)"


def wgrad_alone_ms(a, b) -> float:
    """The C entry mp_wgrad alone on (a, b): its partials and output allocated
    once, launched directly (without the wrapper's allocations and Python)."""
    from mp_hsir_tpu_torch.ops.kernels import _build, _grad
    from mp_hsir_tpu_torch.ops.kernels._route import dtype_code, stream_ptr

    nb, p, m = a.shape
    n = b.shape[-1]
    n_parts, _ = _grad.wgrad_plan(nb, p, m, n, a.dtype == torch.bfloat16)
    f32 = dict(dtype=torch.float32, device=a.device)
    part = torch.empty((nb, n_parts, m, n), **f32) if n_parts > 1 else None
    out = torch.empty((nb, m, n), **f32)
    launch = [a.data_ptr(), b.data_ptr(), _build.ptr(part), out.data_ptr(), dtype_code(a), nb, p,
              m, n, n_parts, stream_ptr()]
    entry = _grad._entry("mp_wgrad")
    _build.check("mp_wgrad", entry(*launch))
    return time_ms(lambda: entry(*launch), 20)


def wgrad_checks(specs: Counter, dev, what: str) -> list:
    """Every wgrad signature (nb, P, M, N) of a train step, on seeded normal
    inputs made on the card: the kernel against wgrad_plain (TF32 off) in
    bf16 and in float32, within WGRAD_TOL of the plain product's max-abs;
    two bf16 calls bitwise equal; the library call held to the plain product
    (BF16_TOL). Per signature: ms through the wrapper and alone (CUDA
    events), TFLOP/s, the bound max(bytes / 3.35 TB/s, flops / 989 TFLOP/s)
    with the operands read once and the float32 output written once, the
    plain version's and the library call's ms; then the sums per step."""
    from mp_hsir_tpu_torch.ops.kernels import _build
    from mp_hsir_tpu_torch.ops.kernels._grad import wgrad, wgrad_plain, wgrad_plan

    rows, lib_name = [], ""
    smem = _build.plan_bytes("mp_wgrad_tc_smem")
    for spec in sorted((s for s in specs if s[0] == "wgrad"), key=str):
        _, nb, p, m, n, _ = spec
        gen = torch.Generator(device=dev).manual_seed(zlib.crc32(repr(spec[:-1]).encode()))
        a32 = torch.randn((nb, p, m), generator=gen, device=dev)
        b32 = torch.randn((nb, p, n), generator=gen, device=dev)
        a, b = a32.bfloat16(), b32.bfloat16()
        err, rel = compare_pair(lambda: (wgrad(a, b),), lambda: (wgrad(a, b),), WGRAD_TOL)
        err32, rel32 = compare_pair(lambda: (wgrad(a32, b32),), lambda: (wgrad(a32, b32),),
                                    WGRAD_TOL)
        del a32, b32
        if not torch.equal(wgrad(a, b), wgrad(a, b)):
            fail(f"wgrad {spec[1:-1]}: two bf16 calls differ")
        ms, kms = time_ms(lambda: wgrad(a, b), 10), wgrad_alone_ms(a, b)
        plain_ms = time_ms(lambda: wgrad_plain(a, b), 3)
        library, lib_name = wgrad_library(a, b)
        compare_library(library, wgrad, (a, b), {})
        lib_ms = time_ms(library, 10)
        byts, flops = nb * p * (m + n) * 2 + nb * m * n * 4, 2 * nb * p * m * n
        bound_ms = max(byts / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
        rows.append(dict(spec=list(spec), per_step=specs[spec], max_abs_err=err, rel_err=rel,
                         max_abs_err_f32=err32, rel_err_f32=rel32, ms=ms, kernel_ms=kms,
                         plain_ms=plain_ms, library_ms=lib_ms, library=lib_name,
                         bound_ms=bound_ms, bytes=byts, flops=flops,
                         bound_by="bytes" if byts / HBM_BYTES_PER_S >= flops / BF16_FLOPS
                         else "operations", n_parts=wgrad_plan(nb, p, m, n)[0],
                         smem=smem, smem_whole=smem, kc=None, streamed=None,
                         tflops=flops / ms / 1e9, kernel_tflops=flops / kms / 1e9,
                         library_tflops=flops / lib_ms / 1e9))
        log(f"  wgrad {str(spec[1:-1]):28s} x{specs[spec]:<2d} parts {rows[-1]['n_parts']:<3d} "
            f"err rel {rel:.1e} (f32 {rel32:.1e}, bound {WGRAD_TOL})  {ms:7.4f} ms  alone "
            f"{kms:7.4f} ({flops / kms / 1e9:5.1f} TFLOP/s)  plain {plain_ms:7.4f}  lib "
            f"{lib_ms:7.4f} ({flops / lib_ms / 1e9:5.1f})  bound {bound_ms:.4f} "
            f"({rows[-1]['bound_by']})")
        del a, b
        torch.cuda.empty_cache()
    tot = lambda k: sum(r[k] * r["per_step"] for r in rows)  # noqa: E731
    tf = tot("flops") / 1e9
    log(f"  wgrad per {what} train step ({sum(r['per_step'] for r in rows)} calls, "
        f"{tf:.1f} GFLOP, {tot('bytes') / 1e9:.2f} GB): wrapper {tot('ms'):.3f} ms "
        f"({tf / tot('ms'):.1f} TFLOP/s), alone {tot('kernel_ms'):.3f} ({tf / tot('kernel_ms'):.1f}), "
        f"bound {tot('bound_ms'):.4f}, plain {tot('plain_ms'):.3f}, library {tot('library_ms'):.3f} "
        f"({tf / tot('library_ms'):.1f}; {lib_name}); alone / library "
        f"{tot('kernel_ms') / tot('library_ms'):.2f}")
    return rows


def log_split(row) -> str:
    if "split" not in row:
        return ""
    return "  stages " + ", ".join(f"{k} {v:.4f}" for k, v in row["split"].items())


def train_batch(dev, b: int, size: int, seed: int = 2024, bands: int = 31,
                tasks: int = 1) -> dict:
    """Clean size x size patches, one quality cube per sample, sigma = 70
    Gaussian noise from a torch.Generator on the card; task ids cycle over
    the first ``tasks`` ids."""
    clean = torch.from_numpy(np.stack([quality_cube(3000 + i, size, bands)[0]
                                       for i in range(b)])).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn(clean.shape, generator=gen, device=dev)
    return dict(degraded=(clean + noise * (70 / 255.0)).clamp(0, 1), clean=clean,
                task_id=torch.arange(b, device=dev) % tasks)


def grad_check(dev, model, batch, what: str) -> dict:
    """The float32 step's parameter gradients on the kernel path against the
    plain float32 step on the card (per tensor, norm-wise, GRAD_TOL). The L1
    loss's cotangent sign(pred - clean) / N flips for pixels within float32
    noise of their target, so both paths take the plain step's loss
    cotangent: the comparison then sees the backward kernels only."""
    import dataclasses

    from mp_hsir_tpu_torch.ops.kernels import _route
    from mp_hsir_tpu_torch.training.losses import l1_clamped

    cfg = model.cfg

    def grads(cot=None, degraded=None):
        model.zero_grad(set_to_none=True)
        gen = torch.Generator(device=dev).manual_seed(5)
        pred = model(batch["degraded"] if degraded is None else degraded, batch["task_id"], gen)
        p = pred.detach().requires_grad_(True)
        loss = l1_clamped(p, batch["clean"])
        if cot is None:
            loss.backward()
            cot = p.grad
        pred.backward(cot)
        return loss.item(), {k: q.grad.detach().clone() for k, q in model.named_parameters()}, cot

    model.cfg = dataclasses.replace(cfg, compute_dtype="float32")
    with _route.plain_reference():
        loss_p, g_p, cot = grads()
        # noise floor: the plain step's own gradients when the input moves
        # by 1e-6 of its value
        noisy = batch["degraded"] * (1 + 1e-6 * torch.randn(
            batch["degraded"].shape, generator=torch.Generator(device=dev).manual_seed(9), device=dev))
        _, g_n, _ = grads(cot, noisy)
    loss_k, g_k, _ = grads(cot)
    model.cfg = cfg

    def rel(a, b):  # norm-wise relative difference of one tensor
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    rows_g = sorted(((rel(g_k[k], g), rel(g_n[k], g),
                      (g_k[k] - g).abs().max().item() / max(g.abs().max().item(), 1e-30), k)
                     for k, g in g_p.items()), reverse=True)
    worst = rows_g[0]
    log(f"  float32 step ({what}): loss kernels {loss_k:.6f} plain {loss_p:.6f}; per-tensor "
        f"|g_kernel - g_plain| / |g_plain| (bound {GRAD_TOL}), the plain step's own change "
        f"for a 1e-6 input change, and max-abs error / max-abs, worst five:")
    for r in rows_g[:5]:
        log(f"    {r[3]:60s} {r[0]:.2e}  noise {r[1]:.2e}  max-abs {r[2]:.2e}")
    if worst[0] > GRAD_TOL:
        fail(f"float32 gradient of {worst[3]} differs from the plain step by {worst[0]:.2e}")
    del g_k, g_p, g_n
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    return dict(f32_grad_worst=rows_g[:10], loss_f32_kernels=loss_k, loss_f32_plain=loss_p)


def step_run(dev, model, batch, expected: Counter, steps: int, what: str) -> dict:
    """bf16 AdamW steps (no warm-up of the rate) with the counters zeroed
    before and read after: every kernel launches its expected count per step,
    the recorded call signatures equal the enumerated ones, no plain version
    runs; ms per step (median after TRAIN_WARMUP steps), the time until
    train_step returns (it does not synchronise: where this is near the
    step's time, the host holds the step or waits on the device inside it)
    and peak memory."""
    from mp_hsir_tpu_torch.config import TrainConfig
    from mp_hsir_tpu_torch.ops.kernels import _route
    from mp_hsir_tpu_torch.training.trainer import create_train_state, train_step

    state = create_train_state(model.cfg, TrainConfig(warmup_frac=0.0), device=dev, model=model)
    gen = torch.Generator(device=dev).manual_seed(2024)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _route.reset_counters()
    losses, times, returns = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = train_step(state, batch, gen)
        returns.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    counts = {name: cnt.launches for name, cnt in _route.COUNTERS.items()}
    recorded = Counter()
    for cnt in _route.COUNTERS.values():
        recorded.update(cnt.specs)
    plain_calls = _route.ROUTE.plain_cuda_calls
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = times[TRAIN_WARMUP:]
    b, bands, size = batch["degraded"].shape[:3]
    log("  losses: " + " ".join(f"{v:.5f}" for v in losses))
    log(f"  ms per train step ({what}, bf16, batch {b} x {bands} x {size}^2, median of "
        f"{len(steady)} after {TRAIN_WARMUP} warm-up): {statistics.median(steady):.2f} "
        f"(min {min(steady):.2f}, max {max(steady):.2f}); train_step returns after a median "
        f"{statistics.median(returns[TRAIN_WARMUP:]):.2f}; peak memory {peak_gib:.2f} GiB")
    per_step = {k: v // steps for k, v in counts.items()}
    log(f"  launches per step: {json.dumps(per_step)}; conv3 = 8 forward + 7 dx (the patch "
        f"embed's input needs no gradient); plain versions on CUDA tensors: {plain_calls}")
    if plain_calls:
        fail(f"{plain_calls} plain-version calls on CUDA tensors in the train steps")
    want = Counter({k: v * steps for k, v in expected.items()})
    if recorded != want:
        fail(f"train kernel calls differ from the enumerated step: extra {dict(recorded - want)}, "
             f"missing {dict(want - recorded)}")
    exp_per = Counter()
    for spec, n in expected.items():
        exp_per[spec[0]] += n
    for name, n in exp_per.items():
        if counts.get(name, 0) != n * steps:
            fail(f"{name}: {counts.get(name, 0)} launches in {steps} steps, expected {n * steps}")
    if not all(np.isfinite(losses)):
        fail(f"train loss not finite: {losses}")
    return dict(losses=losses, ms_per_step=times, median_ms=statistics.median(steady),
                returns_ms=returns, peak_gib=peak_gib, launches=counts, launches_per_step=per_step)


def train_path(dev, expected: Counter) -> dict:
    from mp_hsir_tpu_torch.checkpoint import load_params_npz
    from mp_hsir_tpu_torch.config import natural_scene_config
    from mp_hsir_tpu_torch.models.mp_hsir import build_model

    cfg = natural_scene_config(compute_dtype="bfloat16")
    model = build_model(cfg, dev, train=True)
    load_params_npz(ART, model)
    batch = train_batch(dev, TRAIN_BATCH, TRAIN_SIZE)
    checks = grad_check(dev, model, batch, f"batch {TRAIN_BATCH}")
    # bf16 AdamW steps from the committed weights; counters over all steps
    res = step_run(dev, model, batch, expected, TRAIN_STEPS, "flagship")
    losses = res["losses"]
    if not losses[-1] < losses[0]:
        fail(f"train loss did not fall over {TRAIN_STEPS} steps: {losses[0]} -> {losses[-1]}")
    return dict(res, **checks)


def rs_train_path(dev, expected: Counter) -> dict:
    """Phase 12: the remote-sensing preset's train step at full width on
    seeded random weights (no trained remote-sensing checkpoint exists), the
    TVSP text-query LN biases drawn as tests/test_torch_train.py draws them
    (at their zero init the query gradients are float32 noise in both
    paths). Task ids cycle over the preset's 7 tasks."""
    from mp_hsir_tpu_torch.config import remote_sensing_config
    from mp_hsir_tpu_torch.models.mp_hsir import build_model

    cfg = remote_sensing_config(compute_dtype="bfloat16")
    torch.manual_seed(RS_SEED)
    model = build_model(cfg, dev, train=True)
    rng = np.random.default_rng(RS_SEED)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            if name.endswith("cross_transformer.norm11.bias"):
                prm.copy_(torch.from_numpy(0.5 * rng.standard_normal(prm.shape).astype(np.float32)))
    bands, tasks = cfg.in_channels, cfg.task_classes
    checks = grad_check(dev, model, train_batch(dev, RS_GRAD_BATCH, TRAIN_SIZE, bands=bands,
                                                tasks=tasks),
                        f"batch {RS_GRAD_BATCH} x {bands} x {TRAIN_SIZE}^2, tasks 0-{tasks - 1}")
    batch = train_batch(dev, TRAIN_BATCH, TRAIN_SIZE, bands=bands, tasks=tasks)
    res = step_run(dev, model, batch, expected, RS_TRAIN_STEPS, "remote sensing")
    losses = res["losses"]
    if not statistics.median(losses[-3:]) < losses[0]:
        fail(f"remote-sensing train loss did not fall over {RS_TRAIN_STEPS} steps: first "
             f"{losses[0]}, median of the last 3 {statistics.median(losses[-3:])}")
    del model
    torch.cuda.empty_cache()
    return dict(res, **checks)


# ---------------------------------------------------------------------------
# phase 13: the training entry point (patch store, pipeline, train CLI)
# ---------------------------------------------------------------------------

DEGRADE_TOL = 1e-5  # a branch's apply on the card against the same apply on the CPU
CLI_STORE, CLI_EPOCHS, CLI_STEPS, CLI_WARMUP = 128, 2, 6, 2


def degradation_checks(dev) -> dict:
    """Every branch of make_degrader at both presets' band counts and 64x64
    (each of its host-drawn options), its dense draws made on the card and
    copied to the CPU: the card's apply against the CPU's (DEGRADE_TOL
    max-abs); then two batch degrades with one seed bitwise equal on the card."""
    from mp_hsir_tpu_torch.data.degradations_np import default_cirrus
    from mp_hsir_tpu_torch.ops.pipeline_degrade import TABLES, make_batch_degrader, make_degrader

    cirrus = np.stack([default_cirrus(TRAIN_SIZE, TRAIN_SIZE, seed=s) for s in range(4)])
    worst, out = 0.0, {}
    for data_type, bands in (("remote_sensing", 100), ("natural_scene", 31)):
        types = tuple(TABLES[data_type])
        deg = make_degrader(types, data_type, cirrus)
        clean = np.stack([quality_cube(5000 + i, TRAIN_SIZE, bands)[0] for i in range(4)])
        x_cpu = torch.from_numpy(clean)
        x_dev = x_cpu.to(dev)
        errs = {}
        for br in deg.branches:
            for sub in range(br.n_sub):
                for sub2 in range(br.n_sub2[sub] if br.n_sub2 else 1):
                    gen = torch.Generator(device=dev).manual_seed(11 + sub + 7 * sub2)
                    draws = br.draw(gen, x_dev, sub, sub2)
                    y_dev = br.apply(x_dev, draws, sub, sub2)
                    y_cpu = br.apply(x_cpu, tuple(d.cpu() for d in draws), sub, sub2)
                    err = (y_dev.cpu() - y_cpu).abs().max().item()
                    errs[f"{br.name}[{sub},{sub2}]"] = err
                    if not torch.isfinite(y_dev).all() or err > DEGRADE_TOL:
                        fail(f"degradation {br.name} ({data_type}, option {sub},{sub2}): card "
                             f"vs CPU max-abs {err:.3e} (bound {DEGRADE_TOL})")
        worst = max(worst, max(errs.values()))
        log(f"  {data_type} ({bands} bands, {TRAIN_SIZE}^2, 4 samples): {len(errs)} branch "
            f"options, card vs CPU on the card's draws, max-abs worst "
            f"{max(errs.values()):.2e} ({max(errs, key=errs.get)}; bound {DEGRADE_TOL})")
        bd = make_batch_degrader(types, data_type, cirrus)
        batch = torch.from_numpy(np.concatenate([clean] * 8)).to(dev)
        de_ids = np.arange(32) % len(types)
        runs = []
        for _ in range(2):
            gen = torch.Generator(device=dev).manual_seed(2024)
            runs.append(bd(gen, batch, de_ids, np.random.default_rng([2024, 0, 0, 1])))
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        log(f"  {data_type}: two batch degrades of 32 samples with one seed on the card: "
            f"{'bitwise equal' if same else 'DIFFER'}")
        if not same:
            fail(f"{data_type}: two degrades with one seed differ on the card")
        out[data_type] = errs
    return dict(max_abs=worst, branches=out)


def write_store(path: str, n: int, bands: int) -> None:
    """n seeded smooth band-correlated 64x64 patches, sources WDC_* (the
    remote-sensing source filter keeps them)."""
    from mp_hsir_tpu_torch.data.patch_store import PatchStoreWriter

    with PatchStoreWriter(path) as w:
        for i in range(n):
            w.add(quality_cube(6000 + i, TRAIN_SIZE, bands)[0], f"WDC_{i:04d}.mat")


def sync_free_pipeline(dev, store: str) -> None:
    """The streaming pipeline (degrade and upload) under
    torch.cuda.set_sync_debug_mode("error") for 4 batches: any synchronising
    call raises."""
    from mp_hsir_tpu_torch.config import TrainConfig
    from mp_hsir_tpu_torch.data.degradations_np import default_cirrus
    from mp_hsir_tpu_torch.data.patch_store import PatchStore
    from mp_hsir_tpu_torch.data.train_pipeline import TrainPipeline

    tc = TrainConfig(batch_size=TRAIN_BATCH, patch_size=TRAIN_SIZE)
    cirrus = np.stack([default_cirrus(TRAIN_SIZE, TRAIN_SIZE, seed=s) for s in range(4)])
    for dtype in ("float32", "uint16"):
        pipe = TrainPipeline(PatchStore(store), tc, cirrus_bank=cirrus, target_bands=100,
                             upload_dtype=dtype, device=dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            batches = list(pipe.epoch(0, steps=4))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        ok = all(torch.isfinite(b["degraded"]).all().item() for b in batches)
        log(f"  streaming pipeline, upload {dtype}: 4 batches of {TRAIN_BATCH} x 100 x "
            f"{TRAIN_SIZE}^2 under set_sync_debug_mode('error'): no synchronising call; "
            f"finite {ok}")
        if not ok:
            fail("the pipeline's degraded batches are not finite")


def cli_run(dev, expected: Counter, argv: list, steps: int, what: str) -> dict:
    """One train CLI run with the counters zeroed just before and read just
    after: every kernel launches steps x its per-step count, the recorded
    call signatures equal the enumerated ones x steps, no plain version runs
    on the card, every logged loss is finite."""
    import gc

    from mp_hsir_tpu_torch.cli import train_cli
    from mp_hsir_tpu_torch.ops.kernels import _route

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _route.reset_counters()
    res = train_cli.main(argv)
    counts = {name: cnt.launches for name, cnt in _route.COUNTERS.items() if cnt.launches}
    recorded = Counter()
    for cnt in _route.COUNTERS.values():
        recorded.update(cnt.specs)
    if _route.ROUTE.plain_cuda_calls:
        fail(f"train CLI ({what}): {_route.ROUTE.plain_cuda_calls} plain-version calls on CUDA "
             f"tensors")
    want = Counter({k: v * steps for k, v in expected.items()})
    if recorded != want:
        fail(f"train CLI ({what}) kernel calls differ from {steps} x the enumerated step: extra "
             f"{dict(recorded - want)}, missing {dict(want - recorded)}")
    losses = [r["train_loss"] for r in res["losses"]]
    if len(losses) != steps or not all(np.isfinite(losses)):
        fail(f"train CLI ({what}): logged losses {losses}")
    ms = res["step_ms"][CLI_WARMUP:]
    up = [u for u, _ in res["pipeline_ms"][CLI_WARMUP:] if u is not None]
    dg = [d for _, d in res["pipeline_ms"][CLI_WARMUP:]]
    res.update(what=what, launches=counts, median_ms=statistics.median(ms),
               upload_ms=statistics.median(up) if up else None,
               degrade_ms=statistics.median(dg))
    upl = "-" if res["upload_ms"] is None else f"{res['upload_ms']:.3f}"
    log(f"  {what}: ms per step median {res['median_ms']:.2f} of {len(ms)} after {CLI_WARMUP} "
        f"warm-up (min {min(ms):.2f}, max {max(ms):.2f}); upload {upl} ms and degrade "
        f"{res['degrade_ms']:.3f} ms per step (CUDA events, medians); peak "
        f"{res['peak_gib']:.2f} GiB; launches {json.dumps(counts)}")
    return res


def train_cli_path(dev, expected: Counter, synthetic_ms) -> dict:
    """Phase 13: the degradations on the card, the pipeline without a
    synchronising call, then the remote-sensing train CLI at full width:
    2 epochs x 6 steps (checkpoint each epoch), resume of epoch 2 from epoch
    1's checkpoint, and 6 steps each with --upload_dtype uint16 and with
    --resident_bank."""
    import shutil

    from mp_hsir_tpu_torch.checkpoint import load_params_npz
    from mp_hsir_tpu_torch.config import remote_sensing_config
    from mp_hsir_tpu_torch.models.mp_hsir import build_model

    # torch's default TF32 settings, as a user's process has them (the other
    # phases turn TF32 off): the blur must still match the CPU, through its
    # own TF32-off scope
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    tmp = tempfile.mkdtemp(prefix="mp_hsir_train_cli_")
    try:
        deg = degradation_checks(dev)
        store = os.path.join(tmp, "store")
        write_store(store, CLI_STORE, 100)
        sync_free_pipeline(dev, store)
        base = ["--db_path", store, "--data_type", "remote_sensing", "--batch_size",
                str(TRAIN_BATCH), "--patch_size", str(TRAIN_SIZE), "--compute_dtype", "bfloat16",
                "--log_every", "1", "--ckpt_every_epochs", "1", "--steps_per_epoch", str(CLI_STEPS)]
        ck = os.path.join(tmp, "ck")
        runs = [cli_run(dev, expected, base + ["--epochs", str(CLI_EPOCHS), "--ckpt_dir", ck],
                        CLI_EPOCHS * CLI_STEPS, f"streaming float32, {CLI_EPOCHS} epochs x "
                        f"{CLI_STEPS} steps")]
        first = runs[0]
        if len(first["checkpoints"]) != CLI_EPOCHS or not all(
                os.path.exists(c) for c in first["checkpoints"] + [first["params"]]):
            fail(f"train CLI files missing: {first['checkpoints']}, {first['params']}")
        model = build_model(remote_sensing_config(compute_dtype="bfloat16"), dev)
        load_params_npz(first["params"], model)
        del model
        resumed = cli_run(dev, expected, base + ["--epochs", str(CLI_EPOCHS), "--ckpt_dir",
                                                 os.path.join(tmp, "ck_resume"), "--ckpt_path",
                                                 first["checkpoints"][0]],
                          CLI_STEPS, "resume of epoch 2 from epoch 1's checkpoint")
        want = [r["train_loss"] for r in first["losses"][CLI_STEPS:]]
        got = [r["train_loss"] for r in resumed["losses"]]
        resume_diff = max(abs(a - b) for a, b in zip(got, want))
        log(f"  resume: epoch 2's losses {' '.join(f'{v:.6f}' for v in got)} against the "
            f"uninterrupted run's {' '.join(f'{v:.6f}' for v in want)}: "
            f"{'bitwise equal' if got == want else f'max |diff| {resume_diff:.3e}'}")
        if not np.allclose(got, want, rtol=0, atol=1e-3 * max(map(abs, want))):
            fail("the resumed epoch's losses differ from the uninterrupted run's")
        for flag, what in ((["--upload_dtype", "uint16"], "streaming uint16"),
                           (["--resident_bank"], "resident bank")):
            runs.append(cli_run(dev, expected, base + ["--epochs", "1", "--ckpt_dir",
                                                       os.path.join(tmp, flag[0][2:])] + flag,
                                CLI_STEPS, what))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    log(f"  ms per step, remote-sensing train CLI (bf16, batch {TRAIN_BATCH} x 100 x "
        f"{TRAIN_SIZE}^2, degradation and upload included) beside phase 12's synthetic batch: "
        + ", ".join(f"{r['what']} {r['median_ms']:.2f}" for r in runs)
        + ("" if synthetic_ms is None else f"; phase 12 synthetic step {synthetic_ms:.2f}"))
    keep = ("what", "losses", "step_ms", "median_ms", "upload_ms", "degrade_ms", "peak_gib",
            "launches", "pipeline_ms")
    return dict(degradations=deg, runs=[{k: r[k] for k in keep} for r in runs],
                resume={k: resumed[k] for k in keep}, resume_bitwise=got == want,
                resume_max_diff=resume_diff, synthetic_ms=synthetic_ms)


# ---------------------------------------------------------------------------
# phase 14: the eval entry point (every mode, band-missing scoring, the
# pipelined loop, the classifier router)
# ---------------------------------------------------------------------------

EVAL_MODES = tuple(range(13))
EVAL_CUBES = 2
# the warm-up forward and one per cube, per run_mode
EVAL_FORWARDS = 1 + EVAL_CUBES
# pipelined against synchronous, float32 upload, then float16: PSNR dB, SSIM, SAM
PIPE_TOL = {"float32": (1e-4, 1e-5, 1e-4), "float16": (0.05, 1e-3, 0.05)}
PIPE_MODES, PIPE_DEPTH = (0, 7, 10), 3


def write_eval_cubes(d: str, size: int, bands: int) -> tuple:
    """Two quality cubes (seeds 991, 992) as HWC .mat files in ``d``/clean,
    and seeded noisy copies (sigma 30/255) in ``d``/degraded for mode 12."""
    import scipy.io as sio

    clean_dir, degrad_dir = os.path.join(d, "clean"), os.path.join(d, "degraded")
    os.makedirs(clean_dir)
    os.makedirs(degrad_dir)
    rng = np.random.default_rng(4321)
    for i, seed in enumerate((991, 992)):
        clean, _ = quality_cube(seed, size, bands)
        noisy = np.clip(clean + rng.normal(0, 30 / 255.0, clean.shape), 0, 1).astype(np.float32)
        sio.savemat(os.path.join(clean_dir, f"cube_{i}.mat"), {"data": clean.transpose(1, 2, 0)})
        sio.savemat(os.path.join(degrad_dir, f"cube_{i}.mat"), {"data": noisy.transpose(1, 2, 0)})
    return clean_dir, degrad_dir


def eval_run(dev, model, model_cfg, cfg, expected: Counter, what: str, router=None) -> dict:
    """One run_mode with the counters zeroed just before and read just
    after: every kernel launches EVAL_FORWARDS x its per-forward count with
    the enumerated signatures (the float32 tail tile once per apply call
    with the tail, tail_f32_specs; the float32 conv3, window, stats and
    apply tiles once per call of their kernel, f32_tile_specs), no plain
    version on the card. Its stdout is logged indented."""
    import io

    from mp_hsir_tpu_torch.cli import test_cli
    from mp_hsir_tpu_torch.ops.kernels import _route

    out = io.StringIO()
    _route.reset_counters()
    with contextlib.redirect_stdout(out):
        res = test_cli.run_mode(cfg, model_cfg, model=model, device=dev, task_router=router)
    counts = {name: cnt.launches for name, cnt in _route.COUNTERS.items() if cnt.launches}
    recorded = Counter()
    for cnt in _route.COUNTERS.values():
        recorded.update(cnt.specs)
    plain = _route.ROUTE.plain_cuda_calls
    for line in out.getvalue().strip().splitlines():
        log("    " + line)
    if plain:
        fail(f"eval CLI ({what}): {plain} plain-version calls on CUDA tensors")
    want = Counter({k: v * EVAL_FORWARDS for k, v in
                    (expected + tail_f32_specs(expected) + f32_tile_specs(expected)).items()})
    if recorded != want:
        fail(f"eval CLI ({what}) kernel calls differ from {EVAL_FORWARDS} x the enumerated "
             f"forward: extra {dict(recorded - want)}, missing {dict(want - recorded)}")
    if not all(np.isfinite([res["psnr"], res["ssim"], res["sam"]])):
        fail(f"eval CLI ({what}): metrics not finite: {res}")
    res.update(launches=counts, stdout=out.getvalue().strip().splitlines())
    return res


def kernel_vs_plain_per_prompt(dev, model, cfg, task_id: int, what: str) -> dict:
    """The mode's first cube through the kernel forward and the plain float32
    forward on the card with the mode's task id: max abs <= F32_TOL; and the
    degraded PSNR of the mode's cubes."""
    import io

    from mp_hsir_tpu_torch.data.eval_datasets import MODE_DATASETS
    from mp_hsir_tpu_torch.ops.kernels import _route
    from mp_hsir_tpu_torch.ops.metrics import compute_psnr_ssim_missing_bands

    with contextlib.redirect_stdout(io.StringIO()):
        items = list(MODE_DATASETS[cfg.mode](cfg))
    pairs = [(torch.from_numpy(it["degraded"])[None], torch.from_numpy(it["clean"])[None])
             for it in items]
    if cfg.mode == 10:  # the zeroed bands alone, as the mode scores
        deg = [compute_psnr_ssim_missing_bands(d, c, d)[0] for d, c in pairs]
    else:
        deg = [band_psnr(d, c) for d, c in pairs]
    x = torch.from_numpy(items[0]["degraded"])[None].to(dev)
    tid = torch.tensor([task_id], device=dev)
    with torch.inference_mode():
        out = model(x, tid)
        with _route.plain_reference():
            ref = model(x, tid)
    err = (out - ref).abs().max().item()
    if not err <= F32_TOL:
        fail(f"{what}: float32 kernel forward differs from the plain one by {err:.3e} "
             f"(bound {F32_TOL}) under task {task_id}")
    return dict(max_abs_err=err, psnr_degraded=statistics.mean(deg))


def float32_kernel_ms(specs: Counter, dev) -> dict:
    """Each float32 kernel call of the eval forward timed alone through its
    wrapper on seeded inputs (CUDA events, 5 calls), times its calls per
    forward, summed per kernel: where the CLI's float32 forward goes."""
    per_kernel = Counter()
    for spec, mult in specs.items():
        fn, args, kw, *_ = make_call(spec, dev, torch.float32)
        per_kernel[spec[0]] += time_ms(lambda: fn(*args, **kw), 5) * mult
        del args, kw
    return dict(per_kernel)


def eval_cli_path(dev, card: str) -> dict:
    """Phase 14: the eval entry point on the card, float32 as the JAX CLI."""
    import dataclasses
    import shutil

    from mp_hsir_tpu_torch.checkpoint import load_params_npz
    from mp_hsir_tpu_torch.cli import test_cli
    from mp_hsir_tpu_torch.config import EvalConfig, natural_scene_config, remote_sensing_config
    from mp_hsir_tpu_torch.models.mp_hsir import build_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix="mp_hsir_eval_cli_")
    res = dict(modes={}, pipelined={}, remote_sensing={})
    try:
        clean_dir, degrad_dir = write_eval_cubes(os.path.join(tmp, "flagship"), SIZE, 31)
        cfg_m = natural_scene_config()
        model = build_model(cfg_m, dev)
        load_params_npz(ART, model)
        specs = path_specs(cfg_m, SIZE, "torch.float32")
        base = EvalConfig(test_dir=clean_dir, test_degrad_dir=degrad_dir, save_images=False,
                          output_path=os.path.join(tmp, "out"))
        log(f"  flagship, trained weights, float32, {EVAL_CUBES} cubes 31 x {SIZE}^2 per mode "
            f"(synchronous loop)")
        for mode in EVAL_MODES:
            cfg = dataclasses.replace(base, mode=mode)
            r = eval_run(dev, model, cfg_m, cfg, specs, f"mode {mode}")
            kp = kernel_vs_plain_per_prompt(dev, model, cfg, test_cli.MODE_TASK_ID[mode],
                                            f"mode {mode}")
            r.update(kp, task_id=test_cli.MODE_TASK_ID[mode])
            log(f"  mode {mode:2d} (task {r['task_id']}): PSNR {r['psnr']:.3f} dB (degraded "
                f"{r['psnr_degraded']:.3f}), SSIM {r['ssim']:.4f}, SAM {r['sam']:.3f} deg, "
                f"{r['sec_per_cube'] * 1e3:.2f} ms/cube; kernels vs plain float32 max abs "
                f"{r['max_abs_err']:.3e}")
            res["modes"][mode] = r
        res["float32_kernel_ms"] = float32_kernel_ms(specs, dev)
        log("  float32 kernels per forward, each call alone through its wrapper x its calls: "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(res["float32_kernel_ms"].items()))
            + f"; sum {sum(res['float32_kernel_ms'].values()):.2f} ms against "
            f"{res['modes'][0]['sec_per_cube'] * 1e3:.2f} ms per cube")
        gain = res["modes"][0]["psnr"] - res["modes"][0]["psnr_degraded"]
        log(f"  mode 0: restored - degraded PSNR {gain:.3f} dB (floor 3)")
        if gain < 3.0:
            fail("mode 0 restores less than 3 dB above the degraded input")

        log(f"  pipelined (--pipeline {PIPE_DEPTH}) against the synchronous loop, under "
            f"set_sync_debug_mode('error') outside the drain's event wait")
        for mode in PIPE_MODES:
            sync = res["modes"][mode]
            for dtype, tol in PIPE_TOL.items():
                cfg = dataclasses.replace(base, mode=mode, pipeline=PIPE_DEPTH, upload_dtype=dtype)
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    r = eval_run(dev, model, cfg_m, cfg, specs, f"mode {mode} pipelined {dtype}")
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                diffs = [abs(r[k] - sync[k]) for k in ("psnr", "ssim", "sam")]
                log(f"  mode {mode:2d} pipelined x{PIPE_DEPTH} {dtype}: "
                    f"{r['sec_per_cube'] * 1e3:.2f} ms/cube (synchronous "
                    f"{sync['sec_per_cube'] * 1e3:.2f}); |diff| PSNR {diffs[0]:.2e} dB, SSIM "
                    f"{diffs[1]:.2e}, SAM {diffs[2]:.2e} (bounds {tol})")
                if any(d > t for d, t in zip(diffs, tol)):
                    fail(f"mode {mode}: the pipelined loop ({dtype} upload) differs from the "
                         f"synchronous one")
                res["pipelined"][f"{mode}/{dtype}"] = r

        log("  --auto_task: the seeded random classifier routes each cube, synchronous and "
            "pipelined")
        route = test_cli.make_classifier_router("", "natural_scene", dev)
        if next(route.classifier.parameters()).device.type != "cuda":
            fail("the classifier router is not on the card")
        calls = []

        def router(degraded):
            calls.append(route(degraded))
            return calls[-1]

        for pipe in (1, PIPE_DEPTH):
            cfg = dataclasses.replace(base, mode=5, pipeline=pipe)
            n0 = len(calls)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error" if pipe > 1 else 0)
            try:
                r = eval_run(dev, model, cfg_m, cfg, specs, f"mode 5 auto_task pipeline {pipe}",
                             router)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            log(f"  pipeline {pipe}: routed task ids {calls[n0:]}, "
                f"{r['sec_per_cube'] * 1e3:.2f} ms/cube")
            if len(calls) - n0 != EVAL_CUBES:
                fail(f"the router was consulted {len(calls) - n0} times for {EVAL_CUBES} cubes")
            res[f"auto_task_pipeline_{pipe}"] = dict(task_ids=calls[n0:], **r)
        del model, route
        torch.cuda.empty_cache()

        log("  the CLI in a subprocess: --mode 7 --pipeline 2 --upload_dtype float16")
        cmd = [sys.executable, "-m", "mp_hsir_tpu_torch.cli.test_cli", "--mode", "7",
               "--test_dir", clean_dir, "--ckpt_path", ART, "--no_save_images", "--pipeline", "2",
               "--upload_dtype", "float16"]
        t0 = time.perf_counter()
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        lines = p.stdout.strip().splitlines()
        log("    " + "\n    ".join(lines) + f"\n    ({time.perf_counter() - t0:.1f} s)")
        label = "Super resolution downsample factor=8"
        if (p.returncode != 0 or len(lines) != 4
                or lines[0] != "Start super-resolution testing downsampling factor=8"
                or lines[1] != f"Total Test HSIs Ids : {EVAL_CUBES}"
                or not lines[2].startswith(f"{label}: psnr: ")
                or not lines[3].startswith(f"{label}: sam: ")
                or not lines[3].endswith(" s/cube (pipelined x2)")):
            fail(f"CLI stdout differs from the contract (exit {p.returncode}): {lines} "
                 f"{p.stderr[-3000:]}")
        res["subprocess_stdout"] = lines

        log(f"  remote sensing, seeded random weights, float32, {EVAL_CUBES} cubes 100 x "
            f"{RS_SIZE}^2: modes 0 and 10 (task 6)")
        rs_clean, _ = write_eval_cubes(os.path.join(tmp, "rs"), RS_SIZE, 100)
        rs_cfg = remote_sensing_config()
        torch.manual_seed(RS_SEED)
        rs_model = build_model(rs_cfg, dev)
        rs_specs = path_specs(rs_cfg, RS_SIZE, "torch.float32")
        for mode, task in ((0, 0), (10, 6)):
            cfg = dataclasses.replace(base, mode=mode, test_dir=rs_clean)
            r = eval_run(dev, rs_model, rs_cfg, cfg, rs_specs, f"remote sensing mode {mode}")
            r.update(kernel_vs_plain_per_prompt(dev, rs_model, cfg, task,
                                                f"remote sensing mode {mode}"), task_id=task)
            log(f"  remote sensing mode {mode:2d} (task {task}): PSNR {r['psnr']:.3f} dB, SSIM "
                f"{r['ssim']:.4f}, SAM {r['sam']:.3f} deg, {r['sec_per_cube'] * 1e3:.2f} "
                f"ms/cube; kernels vs plain float32 max abs {r['max_abs_err']:.3e}")
            res["remote_sensing"][mode] = r
        res["rs_float32_kernel_ms"] = float32_kernel_ms(rs_specs, dev)
        log("  remote sensing: float32 kernels per forward, each call alone through its wrapper "
            "x its calls: " + ", ".join(f"{k} {v:.2f} ms" for k, v in
                                        sorted(res["rs_float32_kernel_ms"].items()))
            + f"; sum {sum(res['rs_float32_kernel_ms'].values()):.2f} ms against "
            f"{res['remote_sensing'][0]['sec_per_cube'] * 1e3:.2f} ms per cube")
        del rs_model
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(card)
    log("  s/cube (float32, 512^2 x 31, trained weights; net time as the CLI prints it): "
        + ", ".join(f"mode {m} {r['sec_per_cube']:.4f}" for m, r in res["modes"].items()))
    log("  pipelined x3: " + ", ".join(f"mode {k} {r['sec_per_cube']:.4f}"
                                       for k, r in res["pipelined"].items()))
    res["launches"] = Counter()  # the 13 modes' synchronous runs
    for r in res["modes"].values():
        res["launches"].update(r["launches"])
    return res


# ---------------------------------------------------------------------------
# phase 15: the row-sharded eval forward (--mesh_spatial N): the float32
# spectral tiles with halo rows, the sharded CLI on ranks sharing the card
# ---------------------------------------------------------------------------

MESH_SHARDS = (2, 4)
# the sharded CLI against --mesh_spatial 1: PSNR dB, SSIM (tests/test_eval_cli.py:44-45)
MESH_CLI_TOL = (1e-3, 1e-4)
MESH_RANKS = 2


def shard_call(args, kw, n: int, i: int, fault: str = ""):
    """Shard i of n of one call: (args, kw) with its rows, its gate rows and
    its halo (the neighbours' rows of cat(x, x2); the ring's wrapped rows at
    the image's edges). fault: "swapped" passes the halo rows top for
    bottom, "edge" inverts the top edge flag."""
    from mp_hsir_tpu_torch.ops.kernels.spectral import Halo

    x = args[0]
    h = x.shape[1]
    r0, r1 = i * h // n, (i + 1) * h // n
    u = x if "x2" not in kw else torch.cat([x, kw["x2"]], dim=-1)
    top, bot = u[:, (r0 - 1) % h][:, None], u[:, r1 % h][:, None]
    if fault == "swapped":
        top, bot = bot, top
    halo = Halo(top, bot, (i == 0) != (fault == "edge"), i == n - 1)
    a = (x[:, r0:r1].contiguous(),) + tuple(args[1:])
    k = dict(kw, halo=halo)
    for key in ("x2", "shortcut"):
        if key in kw:
            k[key] = kw[key][:, r0:r1].contiguous()
    if "gate" in kw:
        k["gate"] = kw["gate"][:, r0 // 8:r1 // 8].contiguous()
    return a, k


def composed(name, outs):
    """The shards' outputs as the whole call's: the stats summed in rank
    order, the apply outputs stacked."""
    if name != "spectral_stats":
        return torch.cat(outs, dim=1)
    acc = [t.clone() for t in outs[0]]
    for o in outs[1:]:
        for a, t in zip(acc, o):
            a += t
    return tuple(acc)


def errs(got, ref) -> tuple:
    """(max abs error, max abs error over the max abs of its output), the
    worst output of a call."""
    pairs = [((a.float() - r.float()).abs().max().item(), max(r.float().abs().max().item(), 1e-6))
             for a, r in zip(_flat(got), _flat(ref))]
    return max(e for e, _ in pairs), max(e / s for e, s in pairs)


def bf16_bound_ms(byts, flops) -> float:
    """A bf16 call's bound: its bytes at the HBM rate or its products at the
    bf16 tensor-core rate, the larger."""
    return max(byts / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3


def halo_tile_checks(dev, card: str, dt=torch.float32) -> dict:
    """Phase 15 (a): every distinct stats and apply call of the flagship
    forward in ``dt`` (phase 2's shapes, read in the unrolled frame) cut
    into 2 and 4 row shards, each shard launched with its halo rows: against
    its plain version (phase 2's tolerance of the type), the shards composed
    (stats summed in rank order, apply stacked) against the unsharded kernel
    call (1e-4 of max-abs; bf16's apply stacked bitwise: each pixel's
    arithmetic is the unsharded tile's), an apply shard with its gates
    expanded to a per-pixel gate map (a shifted block's operand on the mesh)
    bitwise the shard with per-window gates, a planted fault on shard 1 of 4
    (the halo rows swapped) and on shard 0 (its top edge flag inverted) that
    must break the bound (the faulty shard composed with the others against
    the unsharded call, above 1e-4); each halo call of 2 timed beside its
    unsharded call."""
    from mp_hsir_tpu_torch.config import natural_scene_config
    from mp_hsir_tpu_torch.ops.kernels._route import plain_reference
    from mp_hsir_tpu_torch.ops.kernels.spectral import _gate_map

    bf16 = dt == torch.bfloat16
    tol, bound = (BF16_TOL, bf16_bound_ms) if bf16 else (F32_TOL, f32_bound_ms)
    specs = path_specs(natural_scene_config(compute_dtype="bfloat16" if bf16 else "float32"),
                       SIZE, str(dt))
    calls = Counter()
    for spec, mult in specs.items():
        if spec[0] in ("spectral_stats", "spectral_apply"):
            key = spec[:7] + spec[8:] if spec[0] == "spectral_stats" else spec[:6] + spec[7:]
            calls[key] += mult
    rows = []
    for key, mult in sorted(calls.items(), key=repr):
        full = key[:7] + (0,) + key[7:] if key[0] == "spectral_stats" else key[:6] + (0,) + key[6:]
        name = key[0]
        fn, args, kw, _, byts, flops = make_call(full, dev, dt)
        kw.pop("shift")
        whole = fn(*args, **kw)
        row = dict(spec=full, calls=mult, shards={})
        for n in MESH_SHARDS:
            outs, worst, worst_abs = [], 0.0, 0.0
            for i in range(n):
                a, k = shard_call(args, kw, n, i)
                got = fn(*a, **k)
                with plain_reference():
                    ref = fn(*a, **k)
                e_abs, e = errs(got, ref)
                if not e <= tol:
                    fail(f"{name} {full[1:]} shard {i} of {n} with halo rows: {e:.3e} of max-abs "
                         f"off its plain version (bound {tol})")
                worst, worst_abs = max(worst, e), max(worst_abs, e_abs)
                if "gate" in k and not torch.equal(
                        fn(*a, **dict(k, gate=_gate_map(k["gate"], 0, a[0].shape[1]))), got):
                    fail(f"{name} {full[1:]} shard {i} of {n}: a gate map's output differs from "
                         "its per-window gates'")
                outs.append(got)
            ce = errs(composed(name, outs), whole)[1]
            cbound = 0.0 if bf16 and name == "spectral_apply" else F32_TOL  # bf16 apply: bitwise
            if not ce <= cbound:
                fail(f"{name} {full[1:]}: {n} shards composed differ from the unsharded kernel "
                     f"call by {ce:.3e} of max-abs (bound {cbound})")
            row["shards"][n] = dict(max_rel_err=worst, max_abs_err=worst_abs, composed_rel_err=ce)
        faults = {}
        for fault, (n, i) in (("swapped", (4, 1)), ("edge", (4, 0))):
            a, k = shard_call(args, kw, n, i, fault)
            got = fn(*a, **k)
            # composed with the other shards, against the unsharded call
            outs = [got if j == i else fn(*shard_call(args, kw, n, j)[0],
                                          **shard_call(args, kw, n, j)[1]) for j in range(n)]
            faults[fault] = errs(composed(name, outs), whole)[1]
            if not faults[fault] > F32_TOL:
                fail(f"{name} {full[1:]}: the planted fault ({fault} halo) went unseen: "
                     f"{faults[fault]:.3e} of max-abs")
        row["faults"] = faults
        a, k = shard_call(args, kw, 2, 0)
        row["halo_ms"] = time_ms(lambda: fn(*a, **k), 10)
        row["whole_ms"] = time_ms(lambda: fn(*args, **kw), 10)
        with plain_reference():
            row["plain_ms"] = time_ms(lambda: fn(*a, **k), 3)
        # one shard of 2: half the pixels, two halo rows more read
        x = args[0]
        cx = x.shape[3] + (kw["x2"].shape[3] if "x2" in kw else 0)
        halo_bytes = 2 * x.shape[0] * x.shape[2] * cx * x.element_size()
        row.update(bytes=byts / 2 + halo_bytes, flops=flops / 2,
                   bound_ms=bound(byts / 2 + halo_bytes, flops / 2))
        rows.append(row)
        log(f"  {name} {full[1:]} x{mult}: halo shards of 2 {row['shards'][2]['max_rel_err']:.2e}"
            f", of 4 {row['shards'][4]['max_rel_err']:.2e} of max-abs off plain; composed "
            f"{row['shards'][2]['composed_rel_err']:.2e} / {row['shards'][4]['composed_rel_err']:.2e}"
            f"; faults swapped {faults['swapped']:.2e}, edge {faults['edge']:.2e}; one shard of 2 "
            f"{row['halo_ms']:.3f} ms (unsharded {row['whole_ms']:.3f}, plain {row['plain_ms']:.3f}"
            f", bound {row['bound_ms']:.4f})")
        del fn, args, kw, whole
        torch.cuda.empty_cache()
    log(card)
    per = {}
    for name in ("spectral_stats", "spectral_apply"):
        rs = [r for r in rows if r["spec"][0] == name]
        per[name] = {k: sum(r[k] * r["calls"] for r in rs)
                     for k in ("halo_ms", "whole_ms", "plain_ms", "bound_ms", "bytes", "flops")}
        per[name]["bound_by"] = ("bytes" if per[name]["bytes"] / HBM_BYTES_PER_S
                                 >= (1 if bf16 else 3) * per[name]["flops"]
                                 / (BF16_FLOPS if bf16 else TF32_FLOPS) else "operations")
        per[name].update(calls=sum(r["calls"] for r in rs),
                         max_abs_err=max(r["shards"][n]["max_abs_err"] for r in rs
                                         for n in MESH_SHARDS),
                         rel_err=max(r["shards"][n]["max_rel_err"] for r in rs
                                     for n in MESH_SHARDS))
        log(f"  {name} per sharded forward (one shard of 2, its {per[name]['calls']} calls): "
            f"halo tile {per[name]['halo_ms']:.2f} ms, the unsharded calls "
            f"{per[name]['whole_ms']:.2f}, plain {per[name]['plain_ms']:.2f}, bound "
            f"{per[name]['bound_ms']:.4f}")
    return dict(rows=rows, per_forward=per)


def _mesh_cli_rank(info, cfg, model_cfg, n: int):
    """One rank of the sharded CLI under phase 15: the parent's float32
    settings (TF32 off in cuDNN and matmuls, as phase 14 sets them), then the
    CLI's own rank."""
    from mp_hsir_tpu_torch.cli import test_cli

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return test_cli._mesh_rank(info, cfg, model_cfg, n, False, "", "natural_scene",
                               keep_outputs=True)


def _gloo_probe_rank(info, op: str):
    """One gloo collective on CUDA tensors between two ranks (a probe of the
    library, not a path of the port: the port stages gloo's tensors through
    the host)."""
    import torch.distributed as dist

    t = torch.full((4,), float(info.rank + 1), device=info.device)
    if op == "all_reduce":
        dist.all_reduce(t)
    elif op == "broadcast":
        dist.broadcast(t, 0)
    elif op == "all_gather":
        dist.all_gather([torch.empty_like(t) for _ in range(2)], t)
    elif info.rank == 0:
        dist.send(t, 1)
    else:
        dist.recv(t, 0)
    torch.cuda.synchronize()
    return t.cpu().tolist()


def gloo_cuda_probe() -> dict:
    """Which gloo collectives take CUDA tensors on this machine: each op in
    two ranks of its own (one that fails can abort its process, as a CUDA
    tensor's send does). The finding is reported, not checked: the port
    never hands gloo a CUDA tensor."""
    from mp_hsir_tpu_torch.parallel import distributed

    got = {}
    for op in ("all_reduce", "broadcast", "all_gather", "send_recv"):
        try:
            out = distributed.spawn(_gloo_probe_rank, 2, op, timeout_s=60)
            got[op] = f"takes CUDA tensors (rank 0 holds {out})"
        except Exception as e:  # noqa: BLE001 - the probe's finding, reported
            got[op] = f"fails: {type(e).__name__}: {str(e).splitlines()[0][:160]}"
        log(f"    {op}: {got[op]}")
    return got


def mesh_cli_run(dev, tmp: str, preset: str, n: int, backend: str, own_cards: bool) -> dict:
    """The eval CLI's mode 0 with --mesh_spatial n (n ranks it spawns on this
    machine) on the preset's two quality cubes (the flagship on its trained
    weights at 512^2 x 31, remote sensing on seeded weights at 256^2 x 100)
    against --mesh_spatial 1 in this process (PSNR within 1e-3 dB, SSIM
    within 1e-4) and the gathered cubes against the unsharded kernel
    forward (max abs 1e-4); each rank: the backend, its card (rank r on
    card r where ``own_cards``, else all on card 0), its launches per
    forward (24 float32 stats and apply launches with halo rows, 22 window
    launches of which 11 with region labels, 8 conv3, 2 GDFN) and no plain
    call on the card; each rank's s per cube."""
    import io

    from mp_hsir_tpu_torch.cli import test_cli
    from mp_hsir_tpu_torch.config import EvalConfig, natural_scene_config, remote_sensing_config
    from mp_hsir_tpu_torch.data.eval_datasets import MODE_DATASETS
    from mp_hsir_tpu_torch.parallel import distributed

    size, bands, ckpt = (SIZE, 31, ART) if preset == "natural_scene" else (RS_SIZE, 100, "")
    d = os.path.join(tmp, preset)
    clean_dir = os.path.join(d, "clean") if os.path.isdir(d) else write_eval_cubes(d, size,
                                                                                    bands)[0]
    model_cfg = (natural_scene_config if preset == "natural_scene" else remote_sensing_config)()
    cfg = EvalConfig(mode=0, test_dir=clean_dir, ckpt_path=ckpt, save_images=False,
                     output_path=os.path.join(tmp, "out"))
    model = test_cli.load_model(ckpt, model_cfg, dev)
    with contextlib.redirect_stdout(io.StringIO()):
        single = test_cli.run_mode(cfg, model_cfg, model=model, device=dev)
        items = list(MODE_DATASETS[0](cfg))
    with torch.inference_mode():
        whole = [model(torch.from_numpy(it["degraded"])[None].to(dev),
                       torch.tensor([0], device=dev)).cpu().numpy() for it in items]
    del model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        sharded = distributed.spawn(_mesh_cli_rank, n, cfg, model_cfg, n)
    secs = time.perf_counter() - t0
    for line in out.getvalue().strip().splitlines():
        log("    " + line)
    dpsnr, dssim = abs(sharded["psnr"] - single["psnr"]), abs(sharded["ssim"] - single["ssim"])
    err = max(float(np.abs(a - b).max()) for a, b in zip(sharded.pop("outputs"), whole))
    log(f"  {preset} {bands} x {size}^2 mode 0, --mesh_spatial {n} ({secs:.1f} s with the ranks' "
        f"start): PSNR {sharded['psnr']:.4f} dB (one card {single['psnr']:.4f}, |diff| "
        f"{dpsnr:.2e}), SSIM {sharded['ssim']:.5f} (|diff| {dssim:.2e}); gathered cubes vs the "
        f"unsharded kernel forward max abs {err:.3e}")
    if not (dpsnr <= MESH_CLI_TOL[0] and dssim <= MESH_CLI_TOL[1]):
        fail(f"{preset}: the sharded CLI's metrics differ from the one-card run")
    if not err <= MODEL_F32_TOL:
        fail(f"{preset}: the sharded forward differs from the unsharded one by {err:.3e}")
    nb = (*model_cfg.num_blocks, *model_cfg.num_blocks[:2], model_cfg.num_refinement_blocks)
    n_pg, n_shift = sum(nb), sum(k // 2 for k in nb)
    want = {"spectral_stats_halo": n_pg + 2, "spectral_apply_halo": n_pg + 2,
            "spectral_stats_f32": n_pg + 2, "spectral_apply_f32": n_pg + 2,
            "window_attention_f32": n_pg, "window_attention_shard": n_shift,
            "conv3_f32": 8, "gdfn_f32": 2}
    shared = "" if own_cards else f" ({n} ranks sharing one card, not a multi-card figure)"
    for r, rk in enumerate(sharded["ranks"]):
        if rk["plain_cuda_calls"]:
            fail(f"{preset}: rank {r} ran {rk['plain_cuda_calls']} plain calls on the card")
        card_r = f"cuda:{r if own_cards else 0}"
        if rk["device"] != card_r or rk["backend"] != backend:
            fail(f"{preset}: rank {r} ran on {rk['device']} over {rk['backend']}, expected "
                 f"{card_r} over {backend}")
        per = {k: rk["launches"].get(k, 0) / rk["forwards"] for k in want}
        if per != {k: float(v) for k, v in want.items()}:
            fail(f"{preset}: rank {r}'s launches per forward {per}, expected {want}")
        log(f"    rank {r} ({rk['device']}, {rk['backend']}): {rk['sec_per_cube']:.4f} s per cube"
            f"{shared}; one card alone {single['sec_per_cube']:.4f}; per forward "
            + ", ".join(f"{k} {int(v)}" for k, v in per.items()))
    return dict(single={k: single[k] for k in ("psnr", "ssim", "sam", "sec_per_cube")},
                sharded=sharded, max_abs_err=err, seconds=secs)


def mesh_cli_checks(dev, card: str) -> dict:
    """Phase 15 (b): the eval CLI with --mesh_spatial 2 on this one card (two
    ranks over gloo), the flagship and the remote-sensing preset
    (mesh_cli_run)."""
    import shutil

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix="mp_hsir_mesh_cli_")
    try:
        res = {p: mesh_cli_run(dev, tmp, p, MESH_RANKS, "gloo", False)
               for p in ("natural_scene", "remote_sensing")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(card)
    return res


def mesh_cards_checks(dev, card: str) -> dict:
    """--mesh-cards: the sharded CLI on a machine with several cards, one
    rank a card over NCCL (2 ranks, then one per card), the flagship
    (mesh_cli_run); then the same command under torchrun (2 processes) held
    to the stdout lines and to the one-card metrics; then phase 16's 1 x 2
    steps and phase 17's 1 x 1 x 2 step with one rank a card."""
    import shutil

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        fail(f"--mesh-cards needs two cards or more, this machine has {n_cards}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix="mp_hsir_mesh_cards_")
    res = {}
    try:
        for n in sorted({2, n_cards}):
            res[f"natural_scene/{n}"] = mesh_cli_run(dev, tmp, "natural_scene", n, "nccl", True)
        clean_dir = os.path.join(tmp, "natural_scene", "clean")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
               "2", "-m", "mp_hsir_tpu_torch.cli.test_cli", "--mode", "0", "--test_dir",
               clean_dir, "--ckpt_path", ART, "--no_save_images", "--mesh_spatial", "2"]
        t0 = time.perf_counter()
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        lines = p.stdout.strip().splitlines()
        log("  torchrun --nproc_per_node 2 ... --mesh_spatial 2:\n    " + "\n    ".join(lines)
            + f"\n    ({time.perf_counter() - t0:.1f} s)")
        single = res["natural_scene/2"]["single"]
        want = f"Denoise sigma=70: psnr: {single['psnr']:.2f}, ssim: {single['ssim']:.4f}"
        if p.returncode != 0 or len(lines) != 4 or lines[2] != want:
            fail(f"torchrun CLI: exit {p.returncode}, stdout {lines}, expected {want!r} "
                 f"{p.stderr[-3000:]}")
        res["torchrun_stdout"] = lines
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("  phase 16's 1 x 2 float32 train step, one rank a card over NCCL:")
    res["train_1x2"] = mesh_step_checks(dev, card, (("1x2 nccl", 1, 2, True),))
    log("  phase 16 (e)'s 1 x 2 bf16 train step, one rank a card over NCCL:")
    res["train_1x2_bf16"] = mesh_bf16_step_checks(dev, card, True)
    log("  phase 17 (d)'s 1 x 1 x 2 float32 train step, one rank a card over NCCL:")
    res["train_1x1x2"] = tp_mesh_checks(dev, card, True, ("float32",))["float32"]
    log(card)
    return res


# ---------------------------------------------------------------------------
# phase 10: the window MSA kernel (K14) through SpatialAttention
# ---------------------------------------------------------------------------

# (map side, C, heads): flagship level 1 and latent, remote-sensing latent
K14_SIGS = ((SIZE, 64, 2), (SIZE // 4, 256, 8), (RS_SIZE // 4, 384, 8))


# ---------------------------------------------------------------------------
# phase 16: the row- and data-sharded float32 train step (--mesh_data N
# --mesh_spatial M): the float32 spectral backwards with halo cotangents
# (K10a / K10b), the 1 x 2 and 2 x 1 steps on ranks sharing the card, the
# train CLI on a 1 x 2 mesh
# ---------------------------------------------------------------------------

MESH_TRAIN_BATCH, MESH_TRAIN_STEPS, MESH_BF16_BATCH = 8, 3, 32
MESH_GRAD_TOL = 1e-5  # mesh vs one rank: float32 gradients, norm-wise per tensor
# bf16 halo backwards: the shards composed against the unsharded bf16 kernel
# backward, dx row by row (bwd_row_errs): within BF16_COMPOSED_TOL, between
# the sound compositions' largest reading on the card (3.73e-3: one bf16
# rounding of a row's largest value where a halo cotangent lands) and the
# planted faults' smallest (a top / bottom swap of the stats backward,
# 6.29e-3), both from the flagship step's calls at batch 32 on an NVIDIA
# H100 80GB HBM3 at 700 W. A planted fault must read above that bound and
# FAULT_FACTOR times the call's own composition error (both types)
BF16_COMPOSED_TOL, FAULT_FACTOR = 5e-3, 3.0
MESH_CLI_STEPS = 4
HALO_BWD_KERNELS = {
    "spectral_stats_bwd_halo": dict(
        source="mp_hsir_tpu_torch/csrc/spectral.cu", tpu=["K10a"],
        replaces="mp_hsir_tpu/ops/pallas_vjp.py:1671", of="spectral_stats_bwd"),
    "spectral_apply_bwd_halo": dict(
        source="mp_hsir_tpu_torch/csrc/spectral.cu", tpu=["K10b"],
        replaces="mp_hsir_tpu/ops/pallas_vjp.py:1758", of="spectral_apply_bwd"),
}


def capture_spectral_bwd(dev, batch, dtype: str = "float32") -> list:
    """One kernel backward of the flagship train step in ``dtype`` on this
    card (one rank, the whole map, trained weights), the inputs of each
    spectral stats and apply backward launch (K10a, K10b) recorded in the
    sharded route's frame: a shifted block's input rolled back (the unrolled
    frame, shift 0), its per-window gates as the per-pixel gate map of that
    frame (the sharded route's gate operand)."""
    from mp_hsir_tpu_torch.checkpoint import load_params_npz
    from mp_hsir_tpu_torch.config import natural_scene_config
    from mp_hsir_tpu_torch.models.mp_hsir import build_model
    from mp_hsir_tpu_torch.ops.kernels import spectral as sp
    from mp_hsir_tpu_torch.ops.window import roll_hw
    from mp_hsir_tpu_torch.training.losses import l1_clamped

    model = build_model(natural_scene_config(compute_dtype=dtype), dev, train=True)
    load_params_npz(ART, model)
    calls = []
    orig = sp._stats_bwd_launch, sp._apply_bwd_launch

    def recorder(kind, fn):
        def rec(*a):
            r = [t.detach().clone() if torch.is_tensor(t) else t for t in a[:-1]]
            shift = r[4]
            if shift:
                if kind == "apply" and r[8] is not None:
                    r[8] = sp._gate_map(r[8], shift, r[0].shape[1])
                r[0], r[4] = roll_hw(r[0], shift, shift), 0
            calls.append((kind, r))
            return fn(*a)
        return rec

    sp._stats_bwd_launch, sp._apply_bwd_launch = recorder("stats", orig[0]), recorder("apply",
                                                                                       orig[1])
    try:
        gen = torch.Generator(device=dev).manual_seed(5)
        pred = model(batch["degraded"], batch["task_id"], gen)
        l1_clamped(pred, batch["clean"]).backward()
    finally:
        sp._stats_bwd_launch, sp._apply_bwd_launch = orig
    del model, pred
    return calls


def bwd_shard(args, n: int, i: int, edges=None):
    """Shard i of n of a recorded backward call: its rows of x (and of the
    apply's gate and dy), its halo rows with the given edge flags (the true
    ones by default; the ring's wrapped rows at an image edge), its rows."""
    from mp_hsir_tpu_torch.ops.kernels.spectral import Halo

    x = args[0]
    h = x.shape[1]
    r0, r1 = i * h // n, (i + 1) * h // n
    a = list(args)
    a[0] = x[:, r0:r1].contiguous()
    if len(args) == 12:
        if args[8] is not None:  # per-window gates (8 rows a gate row) or a gate map
            g = 1 if args[8].shape[1] == h else 8
            a[8] = args[8][:, r0 // g:r1 // g].contiguous()
        a[11] = args[11][:, r0:r1].contiguous()
    edges = (i == 0, i == n - 1) if edges is None else edges
    return a + [Halo(x[:, (r0 - 1) % h][:, None], x[:, r1 % h][:, None], *edges)], (r0, r1)


def bwd_compose(outs, rows, fault: str = ""):
    """The shards' backward outputs as the whole call's: dx stacked, each
    shard's halo cotangents added to the neighbours' rows (fault "swapped":
    shard 1's top and bottom cotangents trade rows; "edge": shard 0's top
    cotangent dropped), the weight gradients, d comb and d dp summed, d gate
    and d shortcut stacked."""
    dx = torch.cat([o[0] for o in outs], dim=1)
    h = dx.shape[1]
    for j, (o, (r0, r1)) in enumerate(zip(outs, rows)):
        top, bot = o[-2], o[-1]
        if fault == "swapped" and j == 1:
            top, bot = bot, top
        if fault == "edge" and j == 0:
            top = None
        if top is not None:
            dx[:, (r0 - 1) % h] += top[:, 0]
        if bot is not None:
            dx[:, r1 % h] += bot[:, 0]
    res = [dx]
    stacked = (6, 7) if len(outs[0]) == 11 else ()
    for k in range(1, len(outs[0]) - 2):
        parts = [o[k] for o in outs]
        res.append(None if parts[0] is None else torch.cat(parts, dim=1) if k in stacked
                   else torch.stack(parts).sum(dim=0))
    return tuple(res)


def bwd_errs(got, ref) -> tuple:
    """errs over the outputs both sides have."""
    pairs = [(a, r) for a, r in zip(got, ref) if r is not None]
    return errs(tuple(a for a, _ in pairs), tuple(r for _, r in pairs))


def bwd_row_errs(got, ref) -> tuple:
    """bwd_errs with dx (the first output) held row by row: each row's error
    over that row's max-abs (a halo cotangent lands on one row)."""
    g0, r0 = got[0].float(), ref[0].float()
    dims = tuple(d for d in range(r0.dim()) if d != 1)
    row = ((g0 - r0).abs().amax(dim=dims) / r0.abs().amax(dim=dims).clamp_min(1e-6)).max().item()
    e_abs, e = bwd_errs(got[1:], ref[1:])
    return max(e_abs, (g0 - r0).abs().max().item()), max(e, row)


def bwd_cost(args, rows: int) -> tuple:
    """(bytes, flops) of one K10a / K10b backward on ``rows`` rows of x plus
    its halo rows: each input and output read or written once (activations
    in x's type, the float32 cotangents of the stats and comb in float32),
    the products of the forward it recomputes and of its cotangents
    (make_bwd_call's count, per pixel of the rows and the halo rows)."""
    x = args[0]
    b, _, w, c = x.shape
    e = x.element_size()
    p, ph = b * rows * w, b * 2 * w
    if len(args) == 11:
        dh = args[8].shape[-1]
        return (2 * (p + ph) * c * e + (2 * c * c + 18 * c) * 2 * e + 3 * b * c * dh * 4,
                2 * (p + ph) * (4 * c * c + 36 * c) + 2 * p * (2 * c * dh + 4 * c))
    gate = args[8]  # per-window gates or a gate map: read once, its cotangent written once
    gate_px = 0 if gate is None else 64 if gate.shape[1] < args[0].shape[1] else 1
    return (3 * (p + ph) * c * e + 2 * b * c * c * 4 + (c * c + 9 * c) * 2 * e
            + (2 * p // gate_px * c * e if gate_px else 0), 2 * (p + ph) * (4 * c * c + 18 * c))


def halo_bwd_checks(dev, card: str, dtype: str = "float32") -> dict:
    """Phase 16 (a): every distinct K10a / K10b call of the flagship step in
    ``dtype`` (one card's whole-map backward, recorded in the sharded frame;
    float32 at batch MESH_TRAIN_BATCH, bf16 at MESH_BF16_BATCH) cut into 2
    and 4 row shards: each shard's kernel backward with its halo rows
    against its plain backward (F32_TOL / BF16_TOL of each output's max-abs:
    dx, the halo cotangents, the weight gradients), the shards composed
    against the unsharded kernel backward (F32_TOL / BF16_COMPOSED_TOL), and
    three planted faults, composed, that must break the bound and stand
    FAULT_FACTOR times above the call's own composition error: shard 1 of
    4's top and bottom cotangents folded into each other's rows, shard 0's
    top cotangent computed through the ring's wrap and sent there, shard 0
    with its top edge flag inverted (its top cotangent dropped). bf16 holds
    dx in the compositions and the faults row by row (bwd_row_errs). An
    apply shard with per-window gates gives the same dx, halo cotangents and
    weight gradients, bitwise, with its gates expanded to a per-pixel gate
    map. Each call's shard 0 of 2 is timed beside its plain backward, its
    unsharded call and its bound."""
    from mp_hsir_tpu_torch.ops.kernels import spectral as sp

    bf16 = dtype == "bfloat16"
    tol, ctol = (BF16_TOL, BF16_COMPOSED_TOL) if bf16 else (F32_TOL, F32_TOL)
    bound = bf16_bound_ms if bf16 else f32_bound_ms
    nb = MESH_BF16_BATCH if bf16 else MESH_TRAIN_BATCH
    batch = train_batch(dev, nb, TRAIN_SIZE)
    calls = capture_spectral_bwd(dev, batch, dtype)
    distinct = {}
    for kind, a in calls:
        key = (kind, tuple(a[0].shape)) + ((a[3], a[5] is not None) if kind == "stats" else
                                          (a[5] is not None, a[7],
                                           sp._gate_kind(a[8], a[0].shape[1]), a[9] is not None))
        distinct.setdefault(key, [a, 0])[1] += 1
    log(f"  {len(calls)} K10a / K10b calls per flagship {dtype} step (batch {nb} x 31 x "
        f"{TRAIN_SIZE}^2), {len(distinct)} distinct")
    rows, problems = [], []  # every call checked and logged before the phase fails
    for key, (args, mult) in sorted(distinct.items(), key=repr):
        kern, plain = ((sp._stats_bwd_launch, sp.spectral_stats_bwd_plain) if key[0] == "stats"
                       else (sp._apply_bwd_launch, sp.spectral_apply_bwd_plain))
        whole = kern(*args, None)
        row = dict(key=list(key), calls=mult, shards={})
        # shards of whole 8-row tiles (the latent's 16 rows take 2, not 4)
        counts = [n for n in MESH_SHARDS if args[0].shape[1] % (8 * n) == 0]
        for n in counts:
            outs, rr, worst, worst_abs = [], [], 0.0, 0.0
            for i in range(n):
                a, r = bwd_shard(args, n, i)
                got = kern(*a)
                e_abs, e = bwd_errs(got, plain(*a))
                if not e <= tol:
                    problems.append(f"{key}: shard {i} of {n}'s halo backward is {e:.3e} of "
                                    f"max-abs off its plain version (bound {tol})")
                if (got[-2] is None) != (i == 0) or (got[-1] is None) != (i == n - 1):
                    fail(f"{key}: shard {i} of {n} returned halo cotangents at the wrong sides")
                worst, worst_abs = max(worst, e), max(worst_abs, e_abs)
                if key[0] == "apply" and key[4] is True:
                    am = list(a)
                    am[8] = sp._gate_map(a[8], 0, a[0].shape[1])
                    gm = kern(*am)
                    if not all(torch.equal(x, y) for j, (x, y) in enumerate(zip(got, gm))
                               if j != 6 and x is not None):
                        problems.append(f"{key}: shard {i} of {n} with a gate map differs from "
                                        "its per-window gates'")
                outs.append(got)
                rr.append(r)
            def cerr(parts, fault=""):
                """A composition's error against the unsharded call (bf16: dx row by row)."""
                return (bwd_row_errs if bf16 else bwd_errs)(bwd_compose(parts, rr, fault), whole)[1]

            ce = cerr(outs)
            if not ce <= ctol:
                problems.append(f"{key}: {n} shards composed are {ce:.3e} off the unsharded "
                                f"kernel backward (bound {ctol})")
            row["shards"][n] = dict(max_rel_err=worst, max_abs_err=worst_abs, composed_rel_err=ce)
            if n == counts[-1]:
                faults = {"swapped": cerr(outs, "swapped")}
                a, _ = bwd_shard(args, n, 0, (False, n == 1))  # the wrapped row taken as real
                faulty = kern(*a)
                faults["wrap"] = cerr([faulty] + outs[1:])
                faults["edge"] = cerr([faulty] + outs[1:], "edge")
                seen = max(FAULT_FACTOR * ce, ctol)
                problems += [f"{key}: the planted fault ({f_}) went unseen: {v:.3e} of max-abs "
                             f"(needs {seen:.3e})" for f_, v in faults.items() if not v > seen]
                row["faults"] = faults
        a, _ = bwd_shard(args, 2, 0)
        row["halo_ms"] = time_ms(lambda: kern(*a), 10)
        row["whole_ms"] = time_ms(lambda: kern(*args, None), 10)
        row["plain_ms"] = time_ms(lambda: plain(*a), 3)
        byts, flops = bwd_cost(args, args[0].shape[1] // 2)
        row.update(bytes=byts, flops=flops, bound_ms=bound(byts, flops))
        if bf16:  # where shard 0 of 2's time goes, beside the whole map's
            split = f"spectral_{key[0]}_bwd"
            row["split"] = {side: bwd_split(split, fn, flops, row[ms])["split"]
                            for side, fn, ms in (("shard", lambda: kern(*a), "halo_ms"),
                                                 ("whole", lambda: kern(*args, None),
                                                  "whole_ms"))}
            row["profile"] = profile_call(lambda: kern(*a))
        rows.append(row)
        log(f"  {key} x{mult}: " + "; ".join(
            f"shards of {n} {v['max_rel_err']:.2e} of max-abs off plain, composed "
            f"{v['composed_rel_err']:.2e}" for n, v in row["shards"].items())
            + "; faults " + ", ".join(f"{k} {v:.2e}" for k, v in row["faults"].items())
            + f"; shard 0 of 2 {row['halo_ms']:.3f} ms (unsharded {row['whole_ms']:.3f}, plain "
            f"{row['plain_ms']:.3f}, bound {row['bound_ms']:.4f})")
        torch.cuda.empty_cache()
    del calls, distinct
    torch.cuda.empty_cache()
    if problems:
        fail("; ".join(problems))
    log(card)
    per = {}
    for kind, name in (("stats", "spectral_stats_bwd_halo"), ("apply", "spectral_apply_bwd_halo")):
        rs = [r for r in rows if r["key"][0] == kind]
        per[name] = {k: sum(r[k] * r["calls"] for r in rs)
                     for k in ("halo_ms", "whole_ms", "plain_ms", "bound_ms", "bytes", "flops")}
        per[name]["bound_by"] = ("bytes" if per[name]["bytes"] / HBM_BYTES_PER_S
                                 >= (1 if bf16 else 3) * per[name]["flops"]
                                 / (BF16_FLOPS if bf16 else TF32_FLOPS) else "operations")
        per[name].update(calls=sum(r["calls"] for r in rs),
                         max_abs_err=max(v["max_abs_err"] for r in rs
                                         for v in r["shards"].values()),
                         rel_err=max(v["max_rel_err"] for r in rs for v in r["shards"].values()))
        log(f"  {name} per sharded step (shard 0 of 2, its {per[name]['calls']} calls): "
            f"{per[name]['halo_ms']:.2f} ms, the unsharded calls {per[name]['whole_ms']:.2f}, "
            f"plain {per[name]['plain_ms']:.2f}, bound {per[name]['bound_ms']:.4f}")
        if bf16:
            per[name]["split"] = {side: _weighted(rs, lambda r: r["split"][side])
                                  for side in ("shard", "whole")}
            per[name]["profile"] = _weighted(rs, lambda r: r["profile"])
            for side, sp_ in per[name]["split"].items():
                log(f"    {side} by C entry (CUDA events, device ms a step): "
                    + ", ".join(f"{k} {v:.2f}" for k, v in sorted(sp_.items(),
                                                                  key=lambda kv: -kv[1])))
            log("    shard 0 of 2 by device kernel (torch.profiler, ms a step): "
                + (", ".join(f"{k} {v:.2f}" for k, v in sorted(per[name]["profile"].items(),
                                                               key=lambda kv: -kv[1])[:10])
                   or "the profiler saw no device time"))
    return dict(rows=rows, per_step=per)


def _weighted(rows, get) -> dict:
    """sum over the rows of calls x get(row)'s values, key by key."""
    out: dict = {}
    for r in rows:
        for k, v in get(r).items():
            out[k] = out.get(k, 0.0) + v * r["calls"]
    return out


def profile_call(fn, reps: int = 3) -> dict:
    """Device ms per call of each kernel ``fn`` launches (torch.profiler's
    CUDA activity, its key averages; the card's own kernels and PyTorch's
    fills, copies and casts alike): {kernel name: ms}, empty where the
    profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        us = getattr(e, "cuda_time_total", 0.0) if us is None else us
        if us > 0:
            out[e.key[:60]] = out.get(e.key[:60], 0.0) + us / 1e3 / reps
    return out


def _psum_grads(model, ax) -> dict:
    """Each parameter's gradient summed over the axis's members in order
    (the whole batch's from the blocks'), on the host."""
    from mp_hsir_tpu_torch.parallel.mesh import all_gather

    out = {}
    for k, p in model.named_parameters():
        parts = all_gather(p.grad, ax)
        acc = parts[0].clone()
        for q in parts[1:]:
            acc += q
        out[k] = acc.cpu()
    return out


def _mesh_train_rank(info, data: int, spatial: int, batch: dict, cot, seed: int, steps: int,
                     drop_path: bool, bf16_batch):
    """One rank of phase 16 (b) / (c): the flagship float32 model on the
    trained weights; (1) the gradients of its block with the given loss
    cotangent (grad_check's method: the one-rank step's sign cotangent),
    summed over the ranks, with the backward's launches and plain calls; (2)
    ``steps`` float32 AdamW steps of make_train_step on the global batch
    (launches, ms per step, losses); (3) with ``bf16_batch``, 3 bf16 steps
    on it. Returns rank 0's view: every rank's counts and times, whether
    their parameters end bitwise equal."""
    import dataclasses

    import torch.distributed as dist

    from mp_hsir_tpu_torch.checkpoint import load_params_npz
    from mp_hsir_tpu_torch.config import TrainConfig, natural_scene_config
    from mp_hsir_tpu_torch.models.mp_hsir import build_model
    from mp_hsir_tpu_torch.ops.kernels import _route
    from mp_hsir_tpu_torch.parallel.mesh import (
        DATA_AXIS, MESH_AXES, SPATIAL_AXIS, all_gather, axis_index, make_mesh,
    )
    from mp_hsir_tpu_torch.training.trainer import (
        batch_block, create_train_state, fold_seed, make_train_step, sync_parameters,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = info.device
    cfg = natural_scene_config(compute_dtype="float32")
    if not drop_path:
        cfg = dataclasses.replace(cfg, drop_path_max=0.0)
    model = build_model(cfg, dev, train=True)
    load_params_npz(ART, model)
    mesh = make_mesh(data, spatial)
    sp_ax, dp_ax, every = (mesh.axis(a) for a in (SPATIAL_AXIS, DATA_AXIS, MESH_AXES))
    gb = {k: v.to(dev) for k, v in batch.items()}
    block = batch_block(gb, mesh)
    b0 = axis_index(dp_ax) * block["degraded"].shape[0]
    r0 = axis_index(sp_ax) * block["degraded"].shape[2]
    cb = cot.to(dev)[b0:b0 + block["degraded"].shape[0], :, r0:r0 + block["degraded"].shape[2]]
    mine = {}
    gen = torch.Generator(device=dev).manual_seed(fold_seed(seed, axis_index(dp_ax)))
    pred = model(block["degraded"], block["task_id"], gen, axis=sp_ax)
    torch.cuda.synchronize()
    _route.reset_counters()
    pred.backward(cb.contiguous())
    torch.cuda.synchronize()
    mine["bwd_launches"] = {k: c.launches for k, c in _route.COUNTERS.items() if c.launches}
    mine["bwd_plain_calls"] = _route.ROUTE.plain_cuda_calls
    grads = _psum_grads(model, every)
    model.zero_grad(set_to_none=True)
    del pred

    tc = TrainConfig(warmup_frac=0.0, batch_size=gb["degraded"].shape[0],
                     patch_size=gb["degraded"].shape[2])
    st = create_train_state(cfg, tc, device=dev, model=model)
    sync_parameters(st, mesh)
    step = make_train_step(cfg, tc, mesh)

    def run(n, batch_):
        losses, times = [], []
        _route.reset_counters()
        for s in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(st, batch_, seed + s)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
        return dict(losses=losses, ms=times,
                    launches={k: c.launches for k, c in _route.COUNTERS.items() if c.launches},
                    plain_calls=_route.ROUTE.plain_cuda_calls)

    mine["f32"] = run(steps, gb)
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    mine["same_params"] = all(torch.equal(p, flat) for p in all_gather(flat, every))
    if bf16_batch is not None:
        cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
        model.cfg = cfg16
        tc16 = dataclasses.replace(tc, batch_size=bf16_batch["degraded"].shape[0])
        step = make_train_step(cfg16, tc16, mesh)
        mine["bf16"] = run(3, {k: v.to(dev) for k, v in bf16_batch.items()})
        flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
        mine["same_params_bf16"] = all(torch.equal(p, flat) for p in all_gather(flat, every))
    mine.update(device=str(dev), backend=info.backend)
    ranks = [None] * info.world_size
    dist.all_gather_object(ranks, mine)
    return dict(grads=grads, ranks=ranks) if info.rank == 0 else None


def one_rank_grads(dev, batch, drop_path: bool) -> tuple:
    """The flagship float32 step's gradients on one card: the loss
    cotangent of the plain step (grad_check's method), then the kernel
    path's and the plain path's gradients with it."""
    import dataclasses

    from mp_hsir_tpu_torch.checkpoint import load_params_npz
    from mp_hsir_tpu_torch.config import natural_scene_config
    from mp_hsir_tpu_torch.models.mp_hsir import build_model
    from mp_hsir_tpu_torch.ops.kernels import _route
    from mp_hsir_tpu_torch.training.losses import l1_clamped

    cfg = natural_scene_config(compute_dtype="float32")
    if not drop_path:
        cfg = dataclasses.replace(cfg, drop_path_max=0.0)
    model = build_model(cfg, dev, train=True)
    load_params_npz(ART, model)

    def grads(cot=None):
        model.zero_grad(set_to_none=True)
        gen = torch.Generator(device=dev).manual_seed(5)
        pred = model(batch["degraded"], batch["task_id"], gen)
        if cot is None:
            p = pred.detach().requires_grad_(True)
            l1_clamped(p, batch["clean"]).backward()
            cot = p.grad
        pred.backward(cot)
        return {k: q.grad.detach().cpu().clone() for k, q in model.named_parameters()}, cot

    with _route.plain_reference():
        g_plain, cot = grads()
    g_kern, _ = grads(cot)
    del model
    torch.cuda.empty_cache()
    return g_kern, g_plain, cot


def grad_rel(got: dict, want: dict) -> list:
    """(norm-wise relative difference, name) per tensor, worst first."""
    return sorted((((got[k] - w).norm() / w.norm().clamp_min(1e-30)).item(), k)
                  for k, w in want.items())[::-1]


def mesh_step_checks(dev, card: str, meshes=(("1x2", 1, 2, True), ("2x1", 2, 1, False))) -> dict:
    """Phase 16 (b) and (c): the 1 x 2 float32 step (two ranks sharing this
    card over gloo, batch 8 x 31 x 64^2, trained weights, drop-path on):
    its gradients (summed over the ranks' blocks) against the one-rank
    kernel step (MESH_GRAD_TOL) and the plain float32 step (GRAD_TOL); per
    rank per step the halo backward launches (24 K10a + 24 K10b), the 11
    window backwards with region labels, no plain call; the parameters
    bitwise equal across the ranks after MESH_TRAIN_STEPS AdamW steps; ms
    per step. Then the 2 x 1 data mesh (drop-path off, so that both data
    groups draw what one rank draws): float32 gradients against one rank
    (MESH_GRAD_TOL), then 3 bf16 steps at batch 32 with finite losses."""
    from mp_hsir_tpu_torch.parallel import distributed

    res = {}
    batch = train_batch(dev, MESH_TRAIN_BATCH, TRAIN_SIZE)
    host = {k: v.cpu() for k, v in batch.items()}
    for what, data, spatial, drop_path in meshes:
        g_kern, g_plain, cot = one_rank_grads(dev, batch, drop_path)
        bf16_batch = None
        if data > 1:
            bf16_batch = {k: v.cpu() for k, v in train_batch(dev, MESH_BF16_BATCH,
                                                              TRAIN_SIZE).items()}
        torch.cuda.empty_cache()
        out = distributed.spawn(_mesh_train_rank, data * spatial, data, spatial, host, cot.cpu(),
                                5, MESH_TRAIN_STEPS, drop_path, bf16_batch, device="cuda",
                                timeout_s=600)
        vs_one, vs_plain = grad_rel(out["grads"], g_kern), grad_rel(out["grads"], g_plain)
        log(f"  {what} ({'drop-path on' if drop_path else 'drop-path off'}): gradients vs one rank"
            f" worst {vs_one[0][0]:.2e} ({vs_one[0][1]}; bound {MESH_GRAD_TOL}), vs the plain "
            f"step worst {vs_plain[0][0]:.2e} ({vs_plain[0][1]}; bound {GRAD_TOL})")
        if vs_one[0][0] > MESH_GRAD_TOL:
            fail(f"{what}: gradient of {vs_one[0][1]} differs from one rank's by {vs_one[0][0]:.2e}")
        if vs_plain[0][0] > GRAD_TOL:
            fail(f"{what}: gradient of {vs_plain[0][1]} differs from the plain step by "
                 f"{vs_plain[0][0]:.2e}")
        row = dict(grad_vs_one_rank=vs_one[:5], grad_vs_plain=vs_plain[:5], ranks=[])
        for r, rk in enumerate(out["ranks"]):
            f = rk["f32"]
            per = {k: v // MESH_TRAIN_STEPS for k, v in f["launches"].items()}
            bl = rk["bwd_launches"]
            if rk["bwd_plain_calls"] or f["plain_calls"]:
                fail(f"{what} rank {r}: plain-version calls on CUDA tensors")
            if spatial > 1:
                want = {"spectral_stats_bwd_halo": 24, "spectral_apply_bwd_halo": 24,
                        "window_attention_bwd_shard": 11}
                if any(bl.get(k, 0) != v or per.get(k, 0) != v for k, v in want.items()):
                    fail(f"{what} rank {r}: halo / label backward launches per step "
                         f"{ {k: (bl.get(k, 0), per.get(k, 0)) for k in want} }, expected {want}")
            if not rk["same_params"] or not rk.get("same_params_bf16", True):
                fail(f"{what}: rank {r}'s parameters differ from rank 0's after the steps")
            if not all(np.isfinite(f["losses"])):
                fail(f"{what} rank {r}: losses {f['losses']}")
            med = statistics.median(f["ms"][1:])
            shared = ("ranks sharing one card: not a multi-card figure" if rk["backend"] == "gloo"
                      else "one card a rank")
            line = (f"  {what} rank {r} ({rk['device']}, {rk['backend']}): float32 ms per step "
                    f"{med:.1f} (steps {', '.join(f'{t:.1f}' for t in f['ms'])}; {shared}), "
                    f"losses "
                    + " ".join(f"{v:.5f}" for v in f["losses"])
                    + f"; backward launches {json.dumps(bl)}")
            rrow = dict(rank=r, f32_ms=f["ms"], f32_median_ms=med, losses=f["losses"],
                        launches_per_step=per, bwd_launches=bl)
            if "bf16" in rk:
                b16 = rk["bf16"]
                if not all(np.isfinite(b16["losses"])) or b16["plain_calls"]:
                    fail(f"{what} rank {r}: bf16 steps {b16['losses']}, plain calls "
                         f"{b16['plain_calls']}")
                rrow.update(bf16_ms=b16["ms"], bf16_losses=b16["losses"])
                line += (f"; bf16 batch {MESH_BF16_BATCH} ms per step "
                         + ", ".join(f"{t:.1f}" for t in b16["ms"]) + " losses "
                         + " ".join(f"{v:.5f}" for v in b16["losses"]))
            log(line)
            row["ranks"].append(rrow)
        res[what] = row
        del g_kern, g_plain, out
        torch.cuda.empty_cache()
    log(card)
    return res


# phase 16 (e): the bf16 1 x 2 step at batch MESH_BF16_BATCH on trained
# weights against the one-rank bf16 kernel step: every parameter's gradient
# concatenated, norm-wise (the tiny model's plain 1 x 2 step read 1.02e-2 on
# the CPU, tests/test_torch_mesh_bf16.py; bf16's own noise against float32
# 1.88e-2), and per tensor within MESH_BF16_TENSOR_TOL (the bf16 tiles'
# bound) where bf16 resolves the tensor's gradient: where the one-rank bf16
# kernel step's gradient lies within MESH_BF16_NOISE_TOL of the one-rank
# float32 kernel step's (elsewhere the gradient cancels and bf16 resolves it
# only to 0.04 to 0.83 on the CPU); its loss over MESH_BF16_STEPS steps
MESH_BF16_GRAD_TOL, MESH_BF16_TENSOR_TOL, MESH_BF16_NOISE_TOL = 2e-2, BF16_TOL, 1e-2
MESH_BF16_STEPS = 20
# per rank per bf16 step: the halo launches of the forward and the backward
# (K7a, K7b, K10a, K10b: 24 each) and the window backwards with region labels
MESH_BF16_LAUNCHES = {"spectral_stats_halo": 24, "spectral_apply_halo": 24,
                      "spectral_stats_bwd_halo": 24, "spectral_apply_bwd_halo": 24,
                      "window_attention_bwd_shard": 11}


def _bf16_launches(counters) -> dict:
    """The halo counters' bf16 launches (their specs end with the type) and
    the labelled window backwards."""
    out = {}
    for name in MESH_BF16_LAUNCHES:
        c = counters.get(name)
        out[name] = 0 if c is None else sum(n for spec, n in c.specs.items()
                                            if spec[-1] == "torch.bfloat16")
    return out


def _mesh_bf16_rank(info, batch: dict, cot, seed: int, steps: int):
    """One rank of phase 16 (e): the flagship bf16 model on the trained
    weights on a 1 x n mesh; (1) the gradients of its rows with the given
    loss cotangent, summed over the ranks, with the launches of that forward
    and backward; (2) ``steps`` bf16 AdamW steps of make_train_step on the
    global batch: the launches and plain calls of the first
    MESH_TRAIN_STEPS, the parameters' bits across the ranks after them and
    at the end, the losses, ms per step. Returns rank 0's view: every rank's
    counts and times."""
    import torch.distributed as dist

    from mp_hsir_tpu_torch.checkpoint import load_params_npz
    from mp_hsir_tpu_torch.config import TrainConfig, natural_scene_config
    from mp_hsir_tpu_torch.models.mp_hsir import build_model
    from mp_hsir_tpu_torch.ops.kernels import _route
    from mp_hsir_tpu_torch.parallel.mesh import (
        MESH_AXES, SPATIAL_AXIS, all_gather, axis_index, make_mesh,
    )
    from mp_hsir_tpu_torch.training.trainer import (
        batch_block, create_train_state, make_train_step, sync_parameters,
    )

    dev = info.device
    cfg = natural_scene_config(compute_dtype="bfloat16")
    model = build_model(cfg, dev, train=True)
    load_params_npz(ART, model)
    mesh = make_mesh(1, info.world_size)
    sp_ax, every = mesh.axis(SPATIAL_AXIS), mesh.axis(MESH_AXES)
    gb = {k: v.to(dev) for k, v in batch.items()}
    block = batch_block(gb, mesh)
    h = block["degraded"].shape[2]
    r0 = axis_index(sp_ax) * h
    mine = {}
    gen = torch.Generator(device=dev).manual_seed(seed)
    _route.reset_counters()
    pred = model(block["degraded"], block["task_id"], gen, axis=sp_ax)
    pred.backward(cot.to(dev)[:, :, r0:r0 + h].to(pred.dtype).contiguous())
    torch.cuda.synchronize()
    mine["grad_launches"] = _bf16_launches(_route.COUNTERS)
    mine["grad_plain_calls"] = _route.ROUTE.plain_cuda_calls
    grads = _psum_grads(model, every)
    model.zero_grad(set_to_none=True)
    del pred

    tc = TrainConfig(warmup_frac=0.0, batch_size=gb["degraded"].shape[0],
                     patch_size=gb["degraded"].shape[2])
    st = create_train_state(cfg, tc, device=dev, model=model)
    sync_parameters(st, mesh)
    step = make_train_step(cfg, tc, mesh)

    def same() -> bool:
        flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
        return all(torch.equal(p, flat) for p in all_gather(flat, every))

    losses, times = [], []
    _route.reset_counters()
    for s in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(st, gb, seed + s)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        if s == MESH_TRAIN_STEPS - 1:
            mine["launches"] = _bf16_launches(_route.COUNTERS)
            mine["plain_calls"] = _route.ROUTE.plain_cuda_calls
            mine["same_params_3"] = same()
    mine.update(losses=losses, ms=times, same_params=same(), device=str(dev),
                backend=info.backend)
    ranks = [None] * info.world_size
    dist.all_gather_object(ranks, mine)
    return dict(grads=grads, ranks=ranks) if info.rank == 0 else None


def one_rank_bf16_grads(dev, batch, seed: int) -> tuple:
    """The flagship bf16 kernel step's gradients on one card (trained
    weights, drop-path from ``seed``) with the loss cotangent of its own
    forward, and the float32 kernel step's with the same cotangent (how far
    bf16 resolves each gradient)."""
    from mp_hsir_tpu_torch.checkpoint import load_params_npz
    from mp_hsir_tpu_torch.config import natural_scene_config
    from mp_hsir_tpu_torch.models.mp_hsir import build_model
    from mp_hsir_tpu_torch.training.losses import l1_clamped

    out, cot = [], None
    for dtype in ("bfloat16", "float32"):
        model = build_model(natural_scene_config(compute_dtype=dtype), dev, train=True)
        load_params_npz(ART, model)
        gen = torch.Generator(device=dev).manual_seed(seed)
        pred = model(batch["degraded"], batch["task_id"], gen)
        if cot is None:
            p = pred.detach().float().requires_grad_(True)
            l1_clamped(p, batch["clean"]).backward()
            cot = p.grad
        pred.backward(cot.to(pred.dtype))
        out.append({k: q.grad.detach().float().cpu().clone() for k, q in model.named_parameters()})
        del model, pred
        torch.cuda.empty_cache()
    return out[0], out[1], cot


def mesh_bf16_step_checks(dev, card: str, backend_cards: bool = False) -> dict:
    """Phase 16 (e): the bf16 1 x 2 step at batch MESH_BF16_BATCH x 31 x 64^2
    on the trained weights, drop-path on, two ranks sharing this card over
    gloo (``backend_cards``: one rank a card over NCCL): its gradients (the
    one-rank bf16 step's own loss cotangent) against the one-rank bf16 kernel
    step, every tensor concatenated (MESH_BF16_GRAD_TOL) and per tensor
    (MESH_BF16_TENSOR_TOL where the tensor's one-rank bf16 gradient lies
    within MESH_BF16_NOISE_TOL of its float32 one); per rank the forward's
    and backward's bf16 halo launches (MESH_BF16_LAUNCHES), no
    plain call; the parameters bitwise equal across the ranks after
    MESH_TRAIN_STEPS AdamW steps and at the end; the loss over
    MESH_BF16_STEPS steps falls; ms per step a rank."""
    from mp_hsir_tpu_torch.parallel import distributed

    what = "1x2 bf16" + (" nccl" if backend_cards else "")
    batch = train_batch(dev, MESH_BF16_BATCH, TRAIN_SIZE)
    g16, g32, cot = one_rank_bf16_grads(dev, batch, 5)
    host = {k: v.cpu() for k, v in batch.items()}
    torch.cuda.empty_cache()
    out = distributed.spawn(_mesh_bf16_rank, 2, host, cot.cpu(), 5, MESH_BF16_STEPS,
                            device="cuda", timeout_s=900)
    keys = sorted(g16)
    mesh_flat = torch.cat([out["grads"][k].float().reshape(-1) for k in keys])
    one_flat = torch.cat([g16[k].reshape(-1) for k in keys])
    flat_err = ((mesh_flat - one_flat).norm() / one_flat.norm()).item()
    noise = {k: e for e, k in grad_rel(g16, g32)}
    per = grad_rel({k: out["grads"][k].float() for k in keys}, g16)
    # the bounded tensors' readings over the bound, worst first
    over = sorted(((e / MESH_BF16_TENSOR_TOL, e, k) for e, k in per
                   if noise[k] <= MESH_BF16_NOISE_TOL), reverse=True)
    log(f"  {what}: gradients vs one rank, every tensor concatenated {flat_err:.2e} (bound "
        f"{MESH_BF16_GRAD_TOL}); per tensor worst {per[0][0]:.2e} ({per[0][1]}; its bf16 noise "
        f"{noise[per[0][1]]:.2e}); of the {len(over)} of {len(per)} tensors whose bf16 noise is "
        f"within {MESH_BF16_NOISE_TOL}, worst {over[0][1]:.2e} ({over[0][2]}; bound "
        f"{MESH_BF16_TENSOR_TOL})")
    if not flat_err <= MESH_BF16_GRAD_TOL:
        fail(f"{what}: gradients {flat_err:.2e} off one rank's, concatenated")
    if over[0][0] > 1:
        fail(f"{what}: gradient of {over[0][2]} {over[0][1]:.2e} off one rank's")
    want3 = {k: v * MESH_TRAIN_STEPS for k, v in MESH_BF16_LAUNCHES.items()}
    row = dict(grad_vs_one_rank=flat_err, grad_per_tensor=per[:5], nearest_bound=over[:5],
               bf16_noise={k: noise[k] for _, _, k in over[:5]}, ranks=[])
    for ratio, e, k in over[:5]:
        log(f"    {k}: {e:.2e} off one rank, its bf16 noise {noise[k]:.2e} ({ratio:.2f} of the "
            "bound)")
    for e, k in per[:5]:
        log(f"    {k}: {e:.2e} off one rank, its bf16 noise {noise[k]:.2e}")
    for r, rk in enumerate(out["ranks"]):
        if rk["grad_launches"] != MESH_BF16_LAUNCHES or rk["launches"] != want3:
            fail(f"{what} rank {r}: bf16 halo / label launches {rk['grad_launches']} a step, "
                 f"{rk['launches']} in {MESH_TRAIN_STEPS} steps; expected {MESH_BF16_LAUNCHES}")
        if rk["grad_plain_calls"] or rk["plain_calls"]:
            fail(f"{what} rank {r}: plain-version calls on CUDA tensors")
        if not rk["same_params_3"] or not rk["same_params"]:
            fail(f"{what}: rank {r}'s parameters differ from rank 0's")
        losses = rk["losses"]
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            fail(f"{what} rank {r}: losses {losses[0]} -> {losses[-1]} over {len(losses)} steps")
        med = statistics.median(rk["ms"][3:])
        shared = ("ranks sharing one card: not a multi-card figure" if rk["backend"] == "gloo"
                  else "one card a rank")
        log(f"  {what} rank {r} ({rk['device']}, {rk['backend']}): bf16 ms per step {med:.1f} "
            f"(first 3 {', '.join(f'{t:.1f}' for t in rk['ms'][:3])}; {shared}), losses "
            f"{losses[0]:.5f} -> {losses[-1]:.5f} over {len(losses)} steps; launches a step "
            f"{json.dumps(rk['grad_launches'])}")
        row["ranks"].append(dict(rank=r, ms=rk["ms"], median_ms=med, losses=losses,
                                 launches_per_step=rk["grad_launches"],
                                 launches=rk["launches"]))
    log(card)
    return row


# phase 16 (d): the sharded CLI's losses against one rank's, float32 and
# bf16 (the tiny bf16 CLI on the CPU read 9.9e-5 over 4 steps)
MESH_CLI_LOSS_TOL = {"float32": 1e-4, "bfloat16": 1e-3}


def mesh_train_cli_checks(dev, dtype: str = "float32") -> dict:
    """Phase 16 (d): the remote-sensing train CLI on phase 13's store, in
    ``dtype`` (bf16 is its default), batch 8, MESH_CLI_STEPS steps, on one
    rank and with --mesh_spatial 2 (two ranks it spawns on this card, gloo):
    the logged losses within MESH_CLI_LOSS_TOL of one rank's, the parameters
    bitwise equal across the ranks, rank 0's checkpoint."""
    import tempfile

    from mp_hsir_tpu_torch.cli import train_cli

    # float32 on both sides: this process has TF32 off (main); the spawned
    # ranks start with torch's defaults, which leave cuDNN's convolutions in
    # TF32, so the CUDA libraries' own switch turns it off there
    tf32 = os.environ.get("NVIDIA_TF32_OVERRIDE")
    os.environ["NVIDIA_TF32_OVERRIDE"] = "0"
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        write_store(store, 16, 100)
        base = ["--db_path", store, "--compute_dtype", dtype, "--batch_size", "8",
                "--patch_size", str(TRAIN_SIZE), "--epochs", "1", "--steps_per_epoch",
                str(MESH_CLI_STEPS), "--log_every", "1", "--ckpt_every_epochs", "1"]
        one = train_cli.main(base + ["--ckpt_dir", os.path.join(tmp, "one")])
        torch.cuda.empty_cache()
        two = train_cli.main(base + ["--ckpt_dir", os.path.join(tmp, "two"),
                                     "--mesh_spatial", "2"])
    if tf32 is None:
        del os.environ["NVIDIA_TF32_OVERRIDE"]
    else:
        os.environ["NVIDIA_TF32_OVERRIDE"] = tf32
    l1, l2 = ([r["train_loss"] for r in res["losses"]] for res in (one, two))
    err = max(abs(a - b) for a, b in zip(l1, l2))
    tol = MESH_CLI_LOSS_TOL[dtype]
    log(f"  train CLI --mesh_spatial 2 ({dtype}, batch 8, {MESH_CLI_STEPS} steps): losses "
        + " ".join(f"{v:.6f}" for v in l2) + f"; one rank " + " ".join(f"{v:.6f}" for v in l1)
        + f"; max diff {err:.2e}; ms per step {statistics.median(two['step_ms'][1:]):.1f} "
        f"(one rank {statistics.median(one['step_ms'][1:]):.1f}; ranks sharing one card)")
    if len(l1) != MESH_CLI_STEPS or len(l2) != MESH_CLI_STEPS or not err <= tol:
        fail(f"train CLI --mesh_spatial 2 ({dtype}): losses {l2} vs one rank's {l1}")
    if not two["same_params"] or not two["checkpoints"]:
        fail(f"train CLI --mesh_spatial 2 ({dtype}): parameters differ across ranks, or no "
             "checkpoint")
    return dict(losses_one=l1, losses_mesh=l2, max_diff=err, step_ms_one=one["step_ms"],
                step_ms_mesh=two["step_ms"])


def mesh_train_phase(dev, card: str) -> dict:
    """Phase 16: (a), (b) + (c), (d); the summary rows of the halo backward
    kernels (launches from the 1 x 2 step, times from (a))."""
    log("== phase 16: the row- and data-sharded train step: the spectral backwards with halo "
        "cotangents (float32, bf16), the float32 1 x 2 and 2 x 1 steps and the bf16 1 x 2 step "
        "on ranks sharing this card, the train CLI with --mesh_spatial 2 (float32, bf16)")
    log(card)
    t0 = time.perf_counter()
    res = dict(halo_bwd=halo_bwd_checks(dev, card))
    log("  (a) in bf16:")
    res["halo_bwd_bf16"] = halo_bwd_checks(dev, card, "bfloat16")
    res["steps"] = mesh_step_checks(dev, card)
    log("  (e) the bf16 1 x 2 step:")
    res["bf16_step"] = mesh_bf16_step_checks(dev, card)
    res["cli"] = mesh_train_cli_checks(dev)
    res["cli_bf16"] = mesh_train_cli_checks(dev, "bfloat16")
    ranks = res["steps"]["1x2"]["ranks"]
    res["kernels"] = []
    for name, meta in HALO_BWD_KERNELS.items():
        p = res["halo_bwd"]["per_step"][name]
        n = ranks[0]["launches_per_step"].get(name, 0) * MESH_TRAIN_STEPS
        res["kernels"].append(dict(
            name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
            tpu=meta["tpu"], launches=n, launches_per_step=p["calls"],
            max_abs_err=p["max_abs_err"], rel_err=p["rel_err"], ms=p["halo_ms"],
            plain_ms=p["plain_ms"], bound_ms=p["bound_ms"], bound_by=p["bound_by"],
            library_ms=None, unsharded_ms=p["whole_ms"],
            mesh_step=dict(ranks=len(ranks), launches=n, steps=MESH_TRAIN_STEPS)))
    res["bf16_halo_rows"] = bf16_halo_kernels(res)
    log(f"  phase 16 in {time.perf_counter() - t0:.1f} s")
    return res


# the four bf16 halo instances of the summary line: their path is phase 16
# (e)'s bf16 1 x 2 step (rank 0's launches in its first MESH_TRAIN_STEPS
# steps); times per sharded flagship forward (phase 15 (a) in bf16, one shard
# of 2, batch 1 x 512^2) or step (phase 16 (a) in bf16, shard 0 of 2, batch 32)
BF16_HALO_KERNELS = {
    "spectral_stats_bf16_halo": dict(
        source="mp_hsir_tpu_torch/csrc/spectral_stats.cuh", tpu=["K7a"], of="spectral_stats",
        replaces="mp_hsir_tpu/ops/pallas_attention.py:2053", counter="spectral_stats_halo"),
    "spectral_apply_bf16_halo": dict(
        source="mp_hsir_tpu_torch/csrc/spectral.cu", tpu=["K7b"], of="spectral_apply",
        replaces="mp_hsir_tpu/ops/pallas_attention.py:2114", counter="spectral_apply_halo"),
    "spectral_stats_bwd_bf16_halo": dict(
        source="mp_hsir_tpu_torch/csrc/spectral_stats.cuh", tpu=["K10a"],
        of="spectral_stats_bwd_halo", replaces="mp_hsir_tpu/ops/pallas_vjp.py:1671",
        counter="spectral_stats_bwd_halo"),
    "spectral_apply_bwd_bf16_halo": dict(
        source="mp_hsir_tpu_torch/csrc/spectral_apply_bwd.cuh", tpu=["K10b"],
        of="spectral_apply_bwd_halo", replaces="mp_hsir_tpu/ops/pallas_vjp.py:1758",
        counter="spectral_apply_bwd_halo"),
}


def bf16_halo_kernels(res: dict, fwd: dict | None = None) -> list:
    """The summary rows of the four bf16 halo instances: launches from
    phase 16 (e), the backward's times from phase 16 (a) in bf16, the
    forward's from ``fwd`` (phase 15 (a) in bf16's per_forward; None: the
    forward rows are left out)."""
    rank0 = res["bf16_step"]["ranks"][0]
    rows = []
    for name, meta in BF16_HALO_KERNELS.items():
        if meta["of"].endswith("_halo"):
            p, per = res["halo_bwd_bf16"]["per_step"][meta["of"]], "launches_per_step"
        elif fwd is not None:
            p, per = fwd[meta["of"]], "launches_per_forward"
        else:
            continue
        n = rank0["launches"][meta["counter"]]
        if n == 0:
            fail(f"the bf16 halo instance {name} was not launched by the bf16 1 x 2 step")
        rows.append(dict(
            name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
            tpu=meta["tpu"], launches=n, max_abs_err=p["max_abs_err"], rel_err=p["rel_err"],
            ms=p["halo_ms"], plain_ms=p["plain_ms"], bound_ms=p["bound_ms"],
            bound_by=p["bound_by"], library_ms=None, unsharded_ms=p["whole_ms"],
            mesh_step=dict(ranks=len(res["bf16_step"]["ranks"]), launches=n,
                           steps=MESH_TRAIN_STEPS), **{per: p["calls"]}))
    return rows


def k14_library(layer, x, lab):
    """One PyTorch call that computes K14's function on the same windows, as
    a yardstick: ``F.multi_head_attention_forward`` on the (64, NW, C)
    tokens with the layer's packed qkv and output projections and their
    biases, and a float ``attn_mask`` (NW * nH, 64, 64) carrying the
    relative-position bias and -inf where the tokens' labels differ. The
    mask and the weights in the input's dtype are made here, outside the
    returned call."""
    nw, n, c = x.shape
    nh = layer.num_heads
    with torch.no_grad():
        mask = layer.rel_bias().float()[None].expand(nw, nh, n, n)
        if lab is not None:
            tok = lab.to(x.device).repeat(nw // lab.shape[0], 1)
            mask = mask.masked_fill((tok[:, :, None] != tok[:, None, :])[:, None], float("-inf"))
        mask = mask.reshape(nw * nh, n, n).to(x.dtype).contiguous()
        wq, bq, wp, bp = (t.detach().to(x.dtype) for t in (layer.qkv.weight, layer.qkv.bias,
                                                            layer.proj.weight, layer.proj.bias))
    tokens = x.transpose(0, 1)

    def call():
        out, _ = torch.nn.functional.multi_head_attention_forward(
            tokens, tokens, tokens, c, nh, wq, bq, None, None, False, 0.0, wp, bp,
            training=False, need_weights=False, attn_mask=mask)
        return out.transpose(0, 1)

    return call


def k14_path(dev) -> tuple:
    """SpatialAttention.forward (K14's route) at K14_SIGS with and without
    labels, counted; then each call against its plain version. Returns
    (rows, launches)."""
    from mp_hsir_tpu_torch.models.layers import SpatialAttention
    from mp_hsir_tpu_torch.ops.kernels import _route
    from mp_hsir_tpu_torch.ops.kernels._route import plain_reference
    from mp_hsir_tpu_torch.ops.kernels.window_msa import window_msa
    from mp_hsir_tpu_torch.ops.window import shifted_window_labels

    torch.manual_seed(14)
    calls = []
    for side, c, nh in K14_SIGS:
        layer = SpatialAttention(c, 8, nh).to(dev).eval()
        g = Inputs(zlib.crc32(repr(("window_msa", side, c, nh)).encode()), dev, torch.bfloat16)
        x = g.n(((side // 8) ** 2, 64, c))
        lab = torch.as_tensor(shifted_window_labels(side, side, 8, 4)).to(dev)
        calls += [(layer, x, None), (layer, x, lab)]
    with torch.inference_mode():
        _route.reset_counters()
        for layer, x, lab in calls:
            layer(x, lab)
        torch.cuda.synchronize()
        launches = _route.COUNTERS["window_msa"].launches
        plain_calls = _route.ROUTE.plain_cuda_calls
    log(f"  SpatialAttention forwards: {len(calls)}; window_msa launches {launches}; plain "
        f"versions on CUDA tensors: {plain_calls}")
    if plain_calls or launches != len(calls):
        fail(f"window_msa: {launches} launches and {plain_calls} plain calls for {len(calls)} forwards")

    rows = []
    for layer, x, lab in calls:
        nw, _, c = x.shape
        nh = layer.num_heads
        with torch.inference_mode():
            w = (layer.qkv.weight, layer.qkv.bias, layer.rel_bias(), layer.proj.weight,
                 layer.proj.bias, nh)
            kw = dict(labels=lab)
            err, rel = compare(window_msa, (x,) + w, kw, BF16_TOL)
            err32, rel32 = compare(window_msa, (x.float(),) + w, kw, F32_TOL)
            ms = time_ms(lambda: window_msa(x, *w, **kw), 10)

            def plain():
                with plain_reference():
                    return window_msa(x, *w, **kw)

            plain_ms = time_ms(plain, 3)
            library = k14_library(layer, x, lab)
            lib_err, lib_rel = compare_library(library, window_msa, (x,) + w, kw)
            lib_ms = time_ms(library, 10)
            del library
        p = nw * 64
        byts = 2 * p * c * 2 + 4 * c * c * 2 + 4 * c * 4 + nh * 4096 * 4 + (0 if lab is None else lab.numel() * 4)
        flops = 2 * p * (4 * c * c + 128 * c)
        bound_ms = max(byts / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
        spec = ("window_msa", nw, c, nh, 0 if lab is None else lab.shape[0], "torch.bfloat16")
        plan = plan_of(spec)
        with torch.inference_mode():
            rates = tflops(spec, (x,) + w, kw, flops, ms, lib_ms)
        rows.append(dict(spec=list(spec), per_run=1, max_abs_err=err, rel_err=rel,
                         max_abs_err_f32=err32, rel_err_f32=rel32, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, library_rel_err=lib_rel, bound_ms=bound_ms, bytes=byts,
                         flops=flops,
                         bound_by="bytes" if byts / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations",
                         smem=plan["smem"], smem_whole=plan["smem_whole"], kc=plan["kc"],
                         blocks_per_window=plan["blocks_per_window"], **rates))
        log(f"  window_msa {str(spec[1:-1]):24s} err {err:.2e} (rel {rel:.1e}, f32 rel {rel32:.1e})  "
            f"{ms:8.3f} ms  plain {plain_ms:8.3f}  lib {lib_ms:.3f} (rel err {lib_rel:.1e})  "
            f"bound {bound_ms:.4f} ({rows[-1]['bound_by']})  " + log_plan(plan)
            + log_tflops(rows[-1]))
        torch.cuda.empty_cache()
    return rows, launches


def summarize(rows, launches, kernels, per) -> list:
    summary = []
    for name, meta in kernels.items():
        mine = [r for r in rows if r["spec"][0] == name]
        tot = lambda k: sum(r[k] * r[per] for r in mine)  # noqa: E731
        lib = None if any(r["library_ms"] is None for r in mine) else tot("library_ms")
        byts, flops = tot("bytes"), tot("flops")
        alone = {}
        if mine and all("kernel_ms" in r for r in mine):
            alone = dict(kernel_alone_ms=tot("kernel_ms"), tflops=flops / tot("ms") / 1e9,
                         kernel_tflops=flops / tot("kernel_ms") / 1e9)
            tails = [r for r in mine if "front_ms" in r]
            if tails:  # the apply calls with the PGSSTB tail: front and tail
                tot_t = lambda k: sum(r[k] * r[per] for r in tails)  # noqa: E731
                alone.update(tail_calls_ms=tot_t("ms"), tail_calls_front_ms=tot_t("front_ms"),
                             tail_calls_kernel_ms=tot_t("kernel_ms"),
                             tail_calls_front_kernel_ms=tot_t("front_kernel_ms"),
                             tail_calls_front_plain_ms=tot_t("front_plain_ms"),
                             tail_calls_front_bound_ms=tot_t("front_bound_ms"))
        summary.append(dict(
            name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
            tpu=meta["tpu"], launches=launches[name],
            **{f"launches_{per}": sum(r[per] for r in mine)},
            max_abs_err=max(r["max_abs_err"] for r in mine),
            rel_err=max(r["rel_err"] for r in mine), ms=tot("ms"), plain_ms=tot("plain_ms"),
            bound_ms=tot("bound_ms"),
            bound_by="bytes" if byts / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations",
            library_ms=lib, **alone))
    return summary


def log_kernel_ms(what: str, summary: list, calls_key: str, total_ms: float) -> None:
    log(f"  kernel ms {what}: ms, plain ms, bound ms, library ms")
    for k in sorted(summary, key=lambda k: -k["ms"]):
        lib = "-" if k["library_ms"] is None else f"{k['library_ms']:.2f}"
        log(f"    {k['name']:22s} {k['ms']:8.2f}  plain {k['plain_ms']:8.2f}  bound "
            f"{k['bound_ms']:.4f} ({k['bound_by']})  library {lib}  calls {k[calls_key]}")
    log(f"    sum {sum(k['ms'] for k in summary if k['name'] not in INSIDE):.2f} of the "
        f"median's {total_ms:.2f} ms ({', '.join(INSIDE)} inside the others, not added)")


def log_streamed_call(st) -> str:
    return ("" if st is None else f"  {st['dtype']} resident {st['ms_resident']:.3f} ms, "
            f"streamed kc 64: {st['ms_streamed']:.3f} ms")


def log_streamed(what: str, rows, per: str) -> dict:
    """Per staged kernel: its resident calls' time (each call's isolated
    time x its calls, in the instance streamed_ms ran) beside the same calls
    with the input streamed in 64-channel chunks."""
    out = {}
    log(f"  resident vs streamed (kc 64) plans {what}:")
    for name in STAGED:
        mine = [r for r in rows if r["spec"][0] == name and r.get("streamed") is not None]
        if mine:
            res = sum(r["streamed"]["ms_resident"] * r[per] for r in mine)
            st = sum(r["streamed"]["ms_streamed"] * r[per] for r in mine)
            out[name] = dict(resident_ms=res, streamed_ms=st, calls=sum(r[per] for r in mine),
                             dtype=mine[0]["streamed"]["dtype"])
            log(f"    {name:16s} ({out[name]['dtype']}) resident {res:8.2f} ms  streamed {st:8.2f} ms  "
                f"({st / res - 1:+.1%}, {out[name]['calls']} calls)")
    return out


def log_front_plans(_build) -> dict:
    """The bf16 spectral apply tile's shared-memory plan (bytes, static
    included) at every width of the presets' apply calls, with and without
    the tail, beside the float32 tile's (or an older checkout's SIMT layout
    at its own chunk)."""
    plans = {}
    for c in (64, 96, 128, 192, 256, 384):
        for tail in (1, 0):
            if has_apply_f32_tile():
                f32 = _build.plan_bytes("mp_spectral_apply_smem", c, c, tail, 0)
                bf16 = _build.plan_bytes("mp_spectral_apply_smem", c, c, tail, 1)
            else:
                f32 = _build.plan_bytes("mp_spectral_apply_smem", c, tail, 0,
                                        _build.chunk("mp_spectral_apply_chunk", c, tail, 0))
                bf16 = _build.plan_bytes("mp_spectral_apply_smem", c, tail, 1, c)
            plans[f"C={c}{'+tail' if tail else ''}"] = dict(bf16=bf16, f32=f32)
    log("  bf16 spectral apply plans (B; float32's in brackets): " + ", ".join(
        f"{k} {v['bf16']} ({v['f32']})" for k, v in plans.items()))
    return plans


def stats_shapes(cfgs) -> list:
    """Every (C, heads) of the presets' stats calls (eval and train)."""
    shapes = set()
    for cfg in cfgs:
        for specs in (path_specs(cfg, SIZE, "bf16"), train_path_specs(cfg, 1, 64, "bf16")):
            shapes |= {(s[4] + s[5], s[6]) for s in specs if s[0] == "spectral_stats"}
    return sorted(shapes)


def log_stats_plans(_build, cfgs) -> dict:
    """The bf16 spectral stats tile's shared-memory plan (bytes, static
    included) at every (C, heads) of the presets' stats calls, beside the
    float32 kernel's (the float32 tile's one plan, or an older checkout's
    SIMT kernel at its own chunk)."""
    plans = {}
    for c, nh in stats_shapes(cfgs):
        if has_stats_f32_tile():
            kc, f32 = c, _build.plan_bytes("mp_spectral_stats_smem", c, c, nh)
        else:
            kc = _build.chunk("mp_spectral_stats_chunk", c, nh)
            f32 = _build.plan_bytes("mp_spectral_stats_smem", c, nh, kc)
        plans[f"C={c}/{nh}"] = dict(bf16=_build.plan_bytes("mp_spectral_stats_tc_smem", c, c, nh),
                                    f32=f32, f32_kc=kc)
    log("  bf16 spectral stats plans (B; float32's at its chunk in brackets): " + ", ".join(
        f"{k} {v['bf16']} ({v['f32']} kc {v['f32_kc']})" for k, v in plans.items()))
    return plans


# the float32 GDFN tile's widths beside the presets': rows not 16-byte
# multiples (27 odd, 54) and WIDE_C (two output groups, no exit 1x1)
GDFN_ODD = (27, 54, WIDE_C)


def log_gdfn_plans(_build, cfgs) -> dict:
    """The GDFN tiles' registers and spills (the float32 tile beside the
    bf16 tile, or an older checkout's SIMT kernel), and their shared-memory
    plans (bytes, static included) at every width of the presets' GDFN calls
    (eval and train) and GDFN_ODD: the bf16 tile's beside the float32
    tile's, each float32 plan the mirror's (gdfn_f32_plan, with the exit
    1x1 at Co = C / 2 where C <= 384) and within the limit; an older
    checkout's float32 plan at its own chunk."""
    names = (("gdfn_f32_kernel", "gdfn_f32_kernel"), ("gdfn_tc_kernel (bf16)", "gdfn_tc_kernel"),
             ("gdfn_kernel<float> (SIMT)", "gdfn_kernelIfE"))
    regs = {k: r for k, m in names if (r := ptxas_report(m))}
    log("  GDFN tiles (ptxas): " + ", ".join(
        f"{k} {v.get('registers', '?')} regs, spills {v.get('spill_stores', '?')}/"
        f"{v.get('spill_loads', '?')} B" for k, v in regs.items()))
    widths = set()
    for cfg in cfgs:
        for specs in (path_specs(cfg, SIZE, "bf16"), train_path_specs(cfg, 1, 64, "bf16")):
            widths |= {s[4] for s in specs if s[0] == "gdfn"}
    tile = has_gdfn_f32_tile()
    limit, plans = _build.smem_limit(), {}
    for c in sorted(widths | (set(GDFN_ODD) if tile else set())):
        bf16 = _build.plan_bytes("mp_gdfn_tc_smem", c) if c <= 384 else None
        if not tile:
            kc = _build.chunk("mp_gdfn_chunk", c)
            plans[f"C={c}"] = dict(bf16=bf16, f32=_build.plan_bytes("mp_gdfn_smem", c, kc),
                                   f32_kc=kc)
            continue
        from mp_hsir_tpu_torch.ops.kernels.gdfn import gdfn_f32_plan

        n = _build.plan_bytes("mp_gdfn_f32_smem", c)
        mirror = gdfn_f32_plan(c, c // 2 if c <= 384 else 0)
        plans[f"C={c}"] = dict(bf16=bf16, f32=n, f32_kc=c, stages=mirror["ws"],
                               exit_stages=mirror["cs"])
        if n != mirror["smem"]:
            fail(f"float32 gdfn plan at C={c}: {n} B, gdfn_f32_plan's {mirror}")
        if not 0 < n <= limit:
            fail(f"float32 gdfn plan at C={c}: {n} B over the limit {limit}")
    log(f"  gdfn plans (B; bf16, then float32's{' at its chunk' if not tile else ''} in "
        f"brackets; limit {limit}): " + ", ".join(
            f"{k} {v['bf16']} ({v['f32']} kc {v['f32_kc']})" for k, v in plans.items()))
    return dict(ptxas=regs, plans=plans)


def simt_f32_plans(c: int, limit: int) -> tuple:
    """The float32 plans (bytes, static included) of the SIMT tail that the
    tensor-core tile replaced, at width c: the apply kernel with the tail
    (the front's halo / v stage or y [64][C + 1] | v [64][C + 1] | the hidden
    chunk [64][2 khc + 1]; mu, rs 800 B static) at the chunk it picked (C
    where that fit ``limit``, else 64 with the streamed chunks), and the mlp
    kernel (x | LN(x) [64][C + 1] | the hidden chunk [64][129])."""
    def apply(kc):
        khc, nv = (64, 32) if kc >= c else (32, 128)
        front = max(100 * (kc + 1) + 100 * (nv + 1), 64 * (c + 1))
        return 4 * (front + 64 * (c + 1) + 64 * (2 * khc + 1)) + 800
    return apply(c if apply(c) <= limit else 64), 4 * (2 * 64 * (c + 1) + 64 * 129)


def log_f32_tail_plans(_build) -> dict:
    """The float32 tail tile's registers and spills (mlp_f32_kernel and the
    float32 apply tile that run it, or an older checkout's two SIMT apply
    instances), and the float32 plans with the tail at every width of the
    presets' tail calls and at WIDE_C: the apply kernel's (at its chunk in
    an older checkout) and the mlp kernel's, beside the SIMT tail's."""
    regs = {k: r for k, m in (
        ("mlp_f32_kernel", "mlp_f32_kernel"), ("spectral_apply_f32_kernel",
                                               "spectral_apply_f32_kernel"),
        ("spectral_apply_kernel<float, resident>", "spectral_apply_kernelIfLb0E"),
        ("spectral_apply_kernel<float, streamed>", "spectral_apply_kernelIfLb1E"))
        if (r := ptxas_report(m))}
    log("  float32 tail tile (ptxas): " + ", ".join(
        f"{k} {v.get('registers', '?')} regs, spills {v.get('spill_stores', '?')}/"
        f"{v.get('spill_loads', '?')} B" for k, v in regs.items()))
    limit, plans = _build.smem_limit(), {}
    for c in (64, 96, 128, 192, 256, 384, WIDE_C):
        if has_apply_f32_tile():
            kc, apply = c, _build.plan_bytes("mp_spectral_apply_smem", c, c, 1, 0)
        else:
            kc = _build.chunk("mp_spectral_apply_chunk", c, 1, 0)
            apply = _build.plan_bytes("mp_spectral_apply_smem", c, 1, 0, kc)
        old_apply, old_mlp = simt_f32_plans(c, limit)
        plans[c] = dict(apply=apply, kc=kc,
                        mlp=_build.plan_bytes("mp_mlp_smem", c, 0), simt_apply=old_apply,
                        simt_mlp=old_mlp)
        if has_tail_f32():
            from mp_hsir_tpu_torch.ops.kernels.mlp import tail_f32_plan

            plans[c]["stages"] = tail_f32_plan(c)["ws"]
    log(f"  float32 plans with the tail (B; the SIMT tail's in brackets; limit {limit}): "
        + ", ".join(f"C={c} apply {v['apply']} at kc {v['kc']} ({v['simt_apply']}), mlp "
                    f"{v['mlp']} ({v['simt_mlp']}), {v.get('stages', '-')} stages"
                    for c, v in plans.items()))
    return dict(ptxas=regs, plans=plans)


def simt_window_f32_plan(c: int, heads: int, limit: int) -> int:
    """The float32 plan (bytes, static included) of the SIMT window kernel
    that the float32 window tile replaced (window_attention_kernel<float>:
    the input chunk [64][kc + 1], O [64][C + 1], q|k|v [64][3 dh + 1], the
    scores [64][65]; the labels, LN mean and rstd 768 B static) at the chunk
    it picked (C where that fit ``limit``, else 64)."""
    def plan(kc):
        return 4 * 64 * ((kc + 1) + (c + 1) + (3 * (c // heads) + 1) + 65) + 768
    return plan(c) if plan(c) <= limit else plan(64)


# the SIMT float32 conv3 plan the tile replaced: three stages of the halo
# [324][17] and the slab [9][16][64]
SIMT_CONV3_F32_PLAN = 3 * 4 * (324 * 17 + 9 * 16 * 64)


def log_f32_tile_plans(_build, cfgs) -> dict:
    """The float32 conv3 and window tiles' registers and spills (every
    instance) beside those of the bf16 tiles of the same kernels, and their
    plans at every (C, heads) of the presets' window calls and conv3's one
    plan, beside the SIMT plans they replaced; where the package has no
    such tiles (an older checkout), the SIMT kernels' registers alone."""
    names = [("conv3_kernel<float, vec>", "conv3_kernelIfLb1E"),
             ("conv3_kernel<float, element>", "conv3_kernelIfLb0E"),
             ("conv3_kernel<bf16, vec>", "conv3_kernelI13__nv_bfloat16Lb1E")]
    names += [(f"window_f32_kernel<{d}>", f"window_f32_kernelILi{d}E") for d in (16, 32, 48, 64,
                                                                                96, 128)]
    names += [("window_tc_kernel<K1, 32>", "window_tc_kernelILb1ELi32E"),
              ("window_tc_kernel<K1, 64>", "window_tc_kernelILb1ELi64E"),
              ("window_attention_kernel<float> (SIMT)", "window_attention_kernelIfE")]
    regs = {k: r for k, m in names if (r := ptxas_report(m))}
    log("  float32 conv3 / window tiles (ptxas, the bf16 tiles beside them): " + ", ".join(
        f"{k} {v.get('registers', '?')} regs, spills {v.get('spill_stores', '?')}/"
        f"{v.get('spill_loads', '?')} B" for k, v in regs.items()))
    if not has_f32_tiles():
        log("  float32 conv3 / window: no tensor-core tiles in this package (SIMT)")
        return dict(ptxas=regs)
    import ctypes

    from mp_hsir_tpu_torch.ops.kernels.window_attention import window_f32_plan

    limit, plans = _build.smem_limit(), {}
    fn = _build.lib().mp_window_cluster
    fn.argtypes, fn.restype = [ctypes.c_int] * 5, ctypes.c_int
    widths = sorted({s[4:6] for cfg in cfgs for s in path_specs(cfg, 64, "torch.float32")
                     if s[0] == "window_attention"})
    for c, heads in widths:
        mirror = window_f32_plan(c, heads, limit - 256)
        plans[f"C={c}/{heads}"] = dict(
            f32=_build.plan_bytes("mp_window_attention_smem", c, heads, 0),
            bf16=_build.plan_bytes("mp_window_attention_smem", c, heads, 1),
            simt=simt_window_f32_plan(c, heads, limit), stages=mirror["stages"],
            blocks=fn(c, heads, 0, 1, 0))
        if (plans[f"C={c}/{heads}"]["f32"], plans[f"C={c}/{heads}"]["blocks"]) != (
                mirror["bytes"] + 256, mirror["blocks"]):
            fail(f"float32 window plan at C={c}/{heads} differs from window_f32_plan's {mirror}")
    conv = dict(f32=_build.plan_bytes("mp_conv3_smem", 0), bf16=_build.plan_bytes("mp_conv3_smem", 1),
                simt=SIMT_CONV3_F32_PLAN)
    log(f"  float32 window plans (B; the bf16 tile's, then the SIMT kernel's in brackets; limit "
        f"{limit}): " + ", ".join(
            f"{k} {v['f32']} ({v['bf16']}, {v['simt']}), {v['stages']} stages, {v['blocks']} "
            f"block(s) per window" for k, v in plans.items()))
    log(f"  float32 conv3 plan {conv['f32']} B (bf16 {conv['bf16']}, SIMT {conv['simt']})")
    for k, v in plans.items():
        if not 0 < v["f32"] <= limit:
            fail(f"float32 window plan at {k}: {v['f32']} B over the limit {limit}")
    return dict(ptxas=regs, window=plans, conv3=conv)


def simt_stats_f32_plan(c: int, heads: int, limit: int) -> int:
    """The float32 plan (bytes, static included) of the SIMT stats kernel
    that the float32 stats tile replaced (spectral_stats_kernel<float>: the
    halo chunk [100][kc + 1], one head's 1x1 output [100][2 dh + 1] and q|k
    tile [64][2 dh + 1], the Gram partial [C dh] and the norms [2C]; the LN
    mean and rstd 800 B static) at the chunk it picked (C where that fit
    ``limit``, else 64)."""
    dh = c // heads

    def plan(kc):
        return 4 * (100 * (kc + 1) + 164 * (2 * dh + 1) + c * dh + 2 * c) + 800
    return plan(c) if c <= 64 or plan(c) <= limit else plan(64)


# the float32 stats tile's widths beside the presets': dh 18 and 9 (rows not
# 16-byte multiples: the halo by 4-byte copies) and 8 heads of 50 at C =
# WIDE_C (past the bf16 tile's C = 384)
STATS_ODD = ((36, 2), (27, 3), (WIDE_C, 8))


def log_stats_f32_plans(_build, cfgs) -> dict:
    """The float32 stats tile's registers and spills beside the bf16 tile's
    (and an older checkout's SIMT kernel's), and its plans at every (C,
    heads) of the presets' stats calls and STATS_ODD (bytes, static
    included, with its column groups and ring stages) beside the SIMT plan
    it replaced, each the mirror's (stats_f32_plan) and within the limit."""
    names = (("spectral_stats_f32_kernel", "spectral_stats_f32_kernel"),
             ("spectral_stats_tc_kernel (bf16)", "spectral_stats_tc_kernel"),
             ("spectral_stats_kernel<float> (SIMT)", "spectral_stats_kernelIfE"))
    regs = {k: r for k, m in names if (r := ptxas_report(m))}
    log("  float32 stats tile (ptxas, the bf16 tile beside it): " + ", ".join(
        f"{k} {v.get('registers', '?')} regs, spills {v.get('spill_stores', '?')}/"
        f"{v.get('spill_loads', '?')} B" for k, v in regs.items()))
    if not has_stats_f32_tile():
        log("  float32 spectral stats: no tensor-core tile in this package (SIMT)")
        return dict(ptxas=regs)
    from mp_hsir_tpu_torch.ops.kernels.spectral import stats_f32_plan

    limit, plans = _build.smem_limit(), {}
    for c, heads in stats_shapes(cfgs) + list(STATS_ODD):
        mirror = stats_f32_plan(c, heads)
        n = _build.plan_bytes("mp_spectral_stats_smem", c, c, heads)
        plans[f"C={c}/{heads}"] = dict(f32=n, simt=simt_stats_f32_plan(c, heads, limit),
                                       groups=mirror["groups"], heads_a_group=mirror["hg"],
                                       stages=mirror["ws"])
        if n != mirror["bytes"]:
            fail(f"float32 stats plan at C={c}/{heads}: {n} B, stats_f32_plan's {mirror}")
        if not 0 < n <= limit:
            fail(f"float32 stats plan at C={c}/{heads}: {n} B over the limit {limit}")
    log(f"  float32 stats plans (B; the SIMT kernel's in brackets; limit {limit}): " + ", ".join(
        f"{k} {v['f32']} ({v['simt']}), {v['groups']} group(s) of {v['heads_a_group']} head(s), "
        f"{v['stages']} stages" for k, v in plans.items()))
    return dict(ptxas=regs, plans=plans)


def simt_apply_f32_plan(c: int, tail: int, limit: int) -> int:
    """The float32 plan (bytes, static included) of the SIMT apply front
    that the float32 apply tile replaced (spectral_apply_kernel<float>: the
    halo chunk [100][kc + 1] and the v 1x1 chunk [100][nv + 1] sharing one
    region with y, [64][C + 1] or with the tail [64][CK + 4]; v [64][C +
    1]; with the tail the tail tile's scratch over the dead front where
    larger; the LN mean and rstd 800 B static) at the chunk it picked (C
    where that fit ``limit``, else 64)."""
    from mp_hsir_tpu_torch.ops.kernels.mlp import tail_f32_plan

    def plan(kc):
        nv = 32 if kc >= c else 128
        y = 64 * (-(-c // 64) * 64 + 4 if tail else c + 1)
        front = 4 * (max(100 * (kc + 1) + 100 * (nv + 1), y) + 64 * (c + 1))
        return max(front, tail_f32_plan(c)["bytes"] if tail else 0) + 800
    return plan(c) if c <= 64 or plan(c) <= limit else plan(64)


# the float32 apply tile's widths beside the presets': rows not 16-byte
# multiples (27 odd, 36, 54) and WIDE_C (two comb passes)
APPLY_ODD = (27, 36, 54, WIDE_C)


def log_apply_f32_plans(_build, cfgs) -> dict:
    """The float32 apply tile's registers and spills beside the bf16 tile's
    (and an older checkout's SIMT instances'), and its plans at every (C,
    tail) of the presets' float32 apply calls (eval and train) and at
    APPLY_ODD with and without the tail (bytes, static included, with its
    column groups, comb passes and ring stages) beside the SIMT plan it
    replaced, each the mirror's (apply_f32_plan) and within the limit."""
    names = (("spectral_apply_f32_kernel", "spectral_apply_f32_kernel"),
             ("spectral_apply_tc_kernel (bf16)", "spectral_apply_tc_kernel"),
             ("spectral_apply_kernel<float, resident> (SIMT)", "spectral_apply_kernelIfLb0E"),
             ("spectral_apply_kernel<float, streamed> (SIMT)", "spectral_apply_kernelIfLb1E"))
    regs = {k: r for k, m in names if (r := ptxas_report(m))}
    log("  float32 apply tile (ptxas, the bf16 tile beside it): " + ", ".join(
        f"{k} {v.get('registers', '?')} regs, spills {v.get('spill_stores', '?')}/"
        f"{v.get('spill_loads', '?')} B" for k, v in regs.items()))
    if not has_apply_f32_tile():
        log("  float32 spectral apply: no tensor-core tile in this package (SIMT front)")
        return dict(ptxas=regs)
    from mp_hsir_tpu_torch.ops.kernels.spectral import apply_f32_plan

    shapes = {(c, t) for c in APPLY_ODD for t in (0, 1)}
    for cfg in cfgs:
        for specs in (path_specs(cfg, SIZE, "bf16"), train_path_specs(cfg, 1, 64, "bf16")):
            shapes |= {(s[4] + s[5], int(s[11] > 0)) for s in specs if s[0] == "spectral_apply"}
    limit, plans = _build.smem_limit(), {}
    for c, tail in sorted(shapes):
        mirror = apply_f32_plan(c, bool(tail))
        n = _build.plan_bytes("mp_spectral_apply_smem", c, c, tail, 0)
        key = f"C={c}{'+tail' if tail else ''}"
        plans[key] = dict(f32=n, simt=simt_apply_f32_plan(c, tail, limit),
                          groups=mirror["groups"], passes=mirror["passes"], stages=mirror["ws"],
                          comb_stages=mirror["cs"])
        if n != mirror["bytes"]:
            fail(f"float32 apply plan at {key}: {n} B, apply_f32_plan's {mirror}")
        if not 0 < n <= limit:
            fail(f"float32 apply plan at {key}: {n} B over the limit {limit}")
    log(f"  float32 apply plans (B; the SIMT front's in brackets; limit {limit}): " + ", ".join(
        f"{k} {v['f32']} ({v['simt']}), {v['groups']} group(s), {v['passes']} pass(es), "
        f"{v['stages']}/{v['comb_stages']} stages" for k, v in plans.items()))
    return dict(ptxas=regs, plans=plans)


def k6_f32_checks(specs: Counter, dev) -> list:
    """K6's float32 calls (the mlp calls of a train step, float32: the
    float32 tail tile) against their plain versions (F32_TOL), timed as in
    phase 2 (f32_times), with their calls per step."""
    rows = []
    for spec in sorted(s for s in specs if s[0] == "mlp"):
        f32spec = spec[:-1] + ("torch.float32",)
        fn, args, kw, _, byts, flops = make_train_fwd_call(f32spec, dev, torch.float32)
        err, rel = compare(fn, args, kw, F32_TOL)
        rows.append(dict(spec=list(f32spec), per_step=specs[spec], max_abs_err_f32=err,
                         rel_err_f32=rel, **f32_times(f32spec, fn, args, kw, byts, flops)))
        log(f"  {spec[0]:16s} {str(spec[1:-1]):58s} x{specs[spec]:<2d} float32 err {err:.2e} "
            f"(rel {rel:.1e})" + log_f32(rows[-1]))
        del args, kw
    return rows


def wide_f32_checks(dev) -> list:
    """Float32 calls at C = WIDE_C, past fc2's 384-channel register slice
    (the tail tile in two output groups): the spectral apply with the tail
    after a shifted block's gate and shortcut epilogue, and K6 with its
    residual and drop-path, on 1 x 64 x 64, against their plain versions
    (F32_TOL), timed with their bounds. The mlp call is left out where the
    package has no float32 tail tile (the SIMT plan does not fit there).
    Where it has the float32 stats tile, its STATS_ODD widths too (C =
    WIDE_C shifted, dh 18 shifted, dh 9, and the PromptFusion entry at C =
    18 + 18 with LN): one spectral_stats_f32 launch each, no plain call.
    Where it has the float32 apply tile, its APPLY_ODD widths too (C = 36
    shifted with the tail, 27 unshifted without it, 54 shifted with the
    tail, the PromptFusion entry at 27 + 27 with LN and residual), and the
    WIDE_C call: one spectral_apply_f32 launch each, no plain call. Where it
    has the float32 GDFN tile, its GDFN_ODD widths too (C = 54 and 27 with
    the residual and the exit 1x1 at Co = 27 and 13, WIDE_C with the
    residual and without the exit, in two output groups): one gdfn_f32
    launch each, no plain call."""
    from mp_hsir_tpu_torch.ops.kernels import _route

    hid = int(WIDE_C * 2.66)
    rows = []
    specs = [("spectral_apply", 1, 64, 64, WIDE_C, 0, 4, False, False, True, True, hid,
              "torch.float32"),
             ("mlp", 1, 64, 64, WIDE_C, hid, True, True, "torch.float32")]
    if has_apply_f32_tile():
        specs += [("spectral_apply", 1, 64, 64, 36, 0, 4, False, False, True, True, int(36 * 2.66),
                   "torch.float32"),
                  ("spectral_apply", 1, 64, 64, 27, 0, 0, False, False, True, True, 0,
                   "torch.float32"),
                  ("spectral_apply", 1, 64, 64, 54, 0, 4, False, False, True, True, int(54 * 2.66),
                   "torch.float32"),
                  ("spectral_apply", 1, 64, 64, 27, 27, 0, True, True, False, False, 0,
                   "torch.float32")]
    if has_stats_f32_tile():
        specs += [("spectral_stats", 1, 64, 64, WIDE_C, 0, 8, 4, False, "torch.float32"),
                  ("spectral_stats", 1, 64, 64, 36, 0, 2, 4, False, "torch.float32"),
                  ("spectral_stats", 1, 64, 64, 27, 0, 3, 0, False, "torch.float32"),
                  ("spectral_stats", 1, 64, 64, 18, 18, 2, 0, True, "torch.float32")]
    if has_gdfn_f32_tile():
        specs += [("gdfn", 1, 64, 64, 54, 143, 27, True, "torch.float32"),
                  ("gdfn", 1, 64, 64, 27, 71, 13, True, "torch.float32"),
                  ("gdfn", 1, 64, 64, WIDE_C, int(WIDE_C * 2.66), 0, True, "torch.float32")]
    for spec in specs:
        if spec[0] == "mlp" and not has_tail_f32():
            log(f"  {spec[0]} {spec[1:-1]}: no float32 tail tile in this package (skipped)")
            continue
        fn, args, kw, _, byts, flops = make_train_fwd_call(spec, dev, torch.float32)
        err, rel = compare(fn, args, kw, F32_TOL)
        tile = dict(spectral_stats="spectral_stats_f32", spectral_apply="spectral_apply_f32",
                    gdfn="gdfn_f32")
        if spec[0] in ("spectral_stats", "gdfn") or spec[0] == "spectral_apply" and \
                has_apply_f32_tile():
            _route.reset_counters()
            fn(*args, **kw)
            n, plain = _route.COUNTERS[tile[spec[0]]].launches, _route.ROUTE.plain_cuda_calls
            if (n, plain) != (1, 0):
                fail(f"float32 {spec[0]} {spec[1:-1]}: {n} tile launches, {plain} plain calls")
        row = dict(spec=list(spec), max_abs_err_f32=err, rel_err_f32=rel, per_call=1,
                   **f32_times(spec, fn, args, kw, byts, flops))
        rows.append(row)
        log(f"  {spec[0]:16s} {str(spec[1:-1]):58s} float32 err {err:.2e} (rel {rel:.1e}, "
            f"bound {F32_TOL})" + log_f32(row))
        del args, kw
    return rows


def log_mlp_bwd_plans(_build, cfgs) -> dict:
    """The bf16 MLP backward tile's shared-memory plan (bytes, static
    included) at every width of the presets' train steps, beside the float32
    backward's at its own chunk."""
    widths = sorted({s[4] for cfg in cfgs for s in train_path_specs(cfg, 1, 64, "bf16")
                     if s[0] == "mlp_bwd"})
    plans = {}
    for c in widths:
        kc = _build.chunk("mp_mlp_bwd_chunk", c)
        plans[f"C={c}"] = dict(bf16=_build.plan_bytes("mp_mlp_bwd_tc_smem", c),
                               f32=_build.plan_bytes("mp_mlp_bwd_smem", c, kc), f32_kc=kc)
    log("  bf16 mlp_bwd plans (B; float32's at its chunk in brackets): " + ", ".join(
        f"{k} {v['bf16']} ({v['f32']} kc {v['f32_kc']})" for k, v in plans.items()))
    return plans


def ptxas_report(kernel: str) -> dict:
    """Registers and spill bytes of one kernel from nvcc's ``-Xptxas -v``
    report of this process's build (empty where the library was cached)."""
    from mp_hsir_tpu_torch.ops.kernels import _build

    lines = _build.BUILD_INFO.get("log", "").splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            rep = {}
            for nxt in lines[i + 1:i + 6]:
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", nxt)
                if m:
                    rep.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
                m = re.search(r"Used (\d+) registers", nxt)
                if m:
                    rep["registers"] = int(m.group(1))
                    break
            return rep
    return {}


def log_stats_bwd_plans(_build, cfgs) -> dict:
    """The bf16 spectral stats backward's two tiles: their registers and
    spills, and their shared-memory plans (bytes, static included) at every
    (C, heads) of the presets' train steps, beside the float32 kernel's."""
    regs = {k: ptxas_report(k) for k in ("spectral_stats_bwd_tc_kernel",
                                         "dwconv_dx_tc_kernelILb1ELb0ELb0E")}
    log("  bf16 spectral_stats_bwd tiles (ptxas): " + ", ".join(
        f"{k} {v.get('registers', '?')} registers, spills {v.get('spill_stores', '?')}/"
        f"{v.get('spill_loads', '?')} B" for k, v in regs.items()))
    shapes = sorted({(s[4], s[5]) for cfg in cfgs for s in train_path_specs(cfg, 1, 64, "bf16")
                     if s[0] == "spectral_stats_bwd"})
    plans = {}
    for c, nh in shapes:
        plans[f"C={c}/{nh}"] = dict(
            tile1=_build.plan_bytes("mp_spectral_stats_bwd_tc_smem", c, c, nh),
            tile2=_build.plan_bytes("mp_dwconv_dx_tc_smem", c, 2 * c),
            f32=_build.plan_bytes("mp_spectral_stats_bwd_smem", c, c, nh))
    log("  bf16 spectral_stats_bwd plans (B: tile 1, tile 2; float32's in brackets): "
        + ", ".join(f"{k} {v['tile1']}, {v['tile2']} ({v['f32']})" for k, v in plans.items()))
    return dict(ptxas=regs, plans=plans)


def log_window_bwd_plans(_build, cfgs) -> dict:
    """The bf16 window-attention backward's two tiles: their registers and
    spills (tile 1 per head width), and their shared-memory plans (bytes,
    static included) at every (C, heads) of the presets' train steps, beside
    the float32 kernel's at its chunk."""
    from mp_hsir_tpu_torch.ops.kernels.window_attention import HEAD_WIDTHS

    regs = {f"tile 1 DHP {d}": ptxas_report(f"window_attention_bwd_tc_kernelILi{d}E")
            for d in HEAD_WIDTHS}
    regs["tile 2"] = ptxas_report("dwconv_dx_tc_kernelILb0ELb0ELb0E")
    log("  bf16 window_attention_bwd tiles (ptxas): " + ", ".join(
        f"{k} {v.get('registers', '?')} registers, spills {v.get('spill_stores', '?')}/"
        f"{v.get('spill_loads', '?')} B" for k, v in regs.items()))
    shapes = sorted({(s[4], s[5]) for cfg in cfgs for s in train_path_specs(cfg, 1, 64, "bf16")
                     if s[0] == "window_attention_bwd"})
    plans = {}
    for c, nh in shapes:
        kc = _build.chunk("mp_window_attention_bwd_chunk", c, nh)
        plans[f"C={c}/{nh}"] = dict(
            tile1=_build.plan_bytes("mp_window_attention_bwd_tc_smem", c, nh),
            tile2=_build.plan_bytes("mp_window_attention_dx_tc_smem", c),
            f32=_build.plan_bytes("mp_window_attention_bwd_smem", c, nh, kc), f32_kc=kc)
    log("  bf16 window_attention_bwd plans (B: tile 1, tile 2; float32's at its chunk in "
        "brackets): " + ", ".join(f"{k} {v['tile1']}, {v['tile2']} ({v['f32']} kc {v['f32_kc']})"
                                  for k, v in plans.items()))
    return dict(ptxas=regs, plans=plans)


def log_apply_bwd_plans(_build, cfgs) -> dict:
    """The bf16 spectral apply backward's two tiles: their registers and
    spills, and their shared-memory plans (bytes, static included) at every
    width of the presets' train steps, beside the float32 kernel's at its
    chunk."""
    regs = {"tile 1": ptxas_report("spectral_apply_bwd_tc_kernel"),
            "tile 2": ptxas_report("dwconv_dx_tc_kernelILb1ELb1ELb0E")}
    log("  bf16 spectral_apply_bwd tiles (ptxas): " + ", ".join(
        f"{k} {v.get('registers', '?')} registers, spills {v.get('spill_stores', '?')}/"
        f"{v.get('spill_loads', '?')} B" for k, v in regs.items()))
    widths = sorted({s[4] for cfg in cfgs for s in train_path_specs(cfg, 1, 64, "bf16")
                     if s[0] == "spectral_apply_bwd"})
    plans = {}
    for c in widths:
        kc = _build.chunk("mp_spectral_apply_bwd_chunk", c, c)
        plans[f"C={c}"] = dict(
            tile1=_build.plan_bytes("mp_spectral_apply_bwd_tc_smem", c, c, 1),
            tile2=_build.plan_bytes("mp_spectral_apply_bwd_tc_smem", c, c, 2),
            f32=_build.plan_bytes("mp_spectral_apply_bwd_smem", c, c, kc), f32_kc=kc)
    log("  bf16 spectral_apply_bwd plans (B: tile 1, tile 2; float32's at its chunk in "
        "brackets): " + ", ".join(f"{k} {v['tile1']}, {v['tile2']} ({v['f32']} kc {v['f32_kc']})"
                                  for k, v in plans.items()))
    return dict(ptxas=regs, plans=plans)


def log_gdfn_bwd_plans(_build, cfgs) -> dict:
    """The bf16 GDFN backward's two tiles: their registers and spills, and
    their shared-memory plans (bytes, static included) at every width of the
    presets' train steps, beside the float32 kernel's at its chunk."""
    regs = {"tile 1": ptxas_report("gdfn_bwd_tc_kernel"),
            "tile 2": ptxas_report("dwconv_dx_tc_kernelILb1ELb1ELb1E")}
    log("  bf16 gdfn_bwd tiles (ptxas): " + ", ".join(
        f"{k} {v.get('registers', '?')} registers, spills {v.get('spill_stores', '?')}/"
        f"{v.get('spill_loads', '?')} B" for k, v in regs.items()))
    widths = sorted({s[4] for cfg in cfgs for s in train_path_specs(cfg, 1, 64, "bf16")
                     if s[0] == "gdfn_bwd"})
    plans = {}
    for c in widths:
        kc = _build.chunk("mp_gdfn_bwd_chunk", c)
        plans[f"C={c}"] = dict(tile1=_build.plan_bytes("mp_gdfn_bwd_tc_smem", c),
                               tile2=_build.plan_bytes("mp_gdfn_dx_tc_smem", c),
                               f32=_build.plan_bytes("mp_gdfn_bwd_smem", c, kc), f32_kc=kc)
    log("  bf16 gdfn_bwd plans (B: tile 1, tile 2; float32's at its chunk in brackets): "
        + ", ".join(f"{k} {v['tile1']}, {v['tile2']} ({v['f32']} kc {v['f32_kc']})"
                    for k, v in plans.items()))
    return dict(ptxas=regs, plans=plans)


def split_only(dev, cfgs, out: str, names) -> None:
    """``--bwd-split``: only the named backward kernels' stage splits, at
    every bf16 call signature of both presets' train steps (no check against
    the plain version, no other phase): the same measurement run against
    another checkout of the package (this file copied to its root and run
    there)."""
    res = {}
    for name in names:
        for cfg, what in zip(cfgs, ("flagship", "remote sensing")):
            rows = []
            specs = train_path_specs(cfg, TRAIN_BATCH, TRAIN_SIZE, "torch.bfloat16")
            for spec in sorted(s for s in specs if s[0] == name):
                kern, _, _, flops = make_bwd_call(spec, dev, torch.bfloat16)
                ms = time_ms(kern, 10)
                rows.append(dict(spec=list(spec), per_step=specs[spec], ms=ms,
                                 **bwd_split(name, kern, flops, ms)))
                log(f"  {name} {str(spec[1:-1]):40s} x{specs[spec]:<2d} {ms:8.3f} ms  alone "
                    f"{rows[-1]['kernel_ms']:.4f}" + log_split(rows[-1]))
                torch.cuda.empty_cache()
            res[f"{name} {what}"] = dict(rows=rows, per_step=log_bwd_split(
                name, f"per {what} train step", rows, "per_step"))
    for what in ("flagship", "remote sensing"):
        res[f"wgrad {what}"] = log_wgrad_stages(f"per {what} train step", {
            name: res[f"{name} {what}"]["per_step"] for name in names})
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as fh:
            json.dump(res, fh, indent=1)


def log_wgrad_ptxas() -> dict:
    """The bf16 weight product's shared-memory plan and the registers and
    spills of its instances (copy widths VA x VB), and the guard of the
    headers' shared helpers: the stencil tile dwconv_dx_tc_kernel<true> at
    128 registers or fewer with no spills."""
    from mp_hsir_tpu_torch.ops.kernels import _build

    regs = {f"wgrad_tc<{va},{vb}>": ptxas_report(f"wgrad_tc_kernelILi{va}ELi{vb}E")
            for va in (8, 4, 2, 1) for vb in (8, 4, 2, 1)}
    smem = _build.plan_bytes("mp_wgrad_tc_smem")
    log(f"  bf16 wgrad plan: {smem} B of dynamic shared memory per block (two blocks per SM); "
        "instances (ptxas): " + ", ".join(
        f"{k} {v.get('registers', '?')} regs, spills {v.get('spill_stores', '?')}/"
        f"{v.get('spill_loads', '?')} B" for k, v in regs.items()))
    guard = ptxas_report("dwconv_dx_tc_kernelILb1ELb0ELb0E")
    held = None  # no report: the library was built by an earlier process
    if guard:
        held = guard.get("registers", 999) <= 128 and not guard.get("spill_stores", 1)
    verdict = {None: "no ptxas report in this process", True: "holds", False: "BROKEN"}[held]
    k10b = ptxas_report("dwconv_dx_tc_kernelILb1ELb1ELb0E")
    k11 = ptxas_report("dwconv_dx_tc_kernelILb1ELb1ELb1E")
    log(f"  dwconv_dx_tc_kernel<true, false, false> (K10a): {guard} ({verdict}: <= 128 "
        f"registers, no spills); <true, true, false> (K10b): {k10b}; <true, true, true> (K11): "
        f"{k11}")
    return dict(wgrad=regs, wgrad_smem=smem, dwconv_dx_true=guard, guard_holds=held,
                dwconv_dx_extra=k10b, dwconv_dx_f32t=k11)


# ---------------------------------------------------------------------------
# phase 17: the head-parallel spectral mesh axis (make_mesh(data, spatial,
# spectral)) in float32, then in bf16: the four spectral kernels on a
# member's head block (K7a / K7b / K10a / K10b with CL = C / 2), the eval and
# train steps on ranks sharing the card
# ---------------------------------------------------------------------------

TP_N = 2  # members of the spectral axis
TP_BATCH, TP_BITWISE_STEPS, TP_STEPS = 8, 3, 10
# the steps' rate: a tenth of the preset's 2e-4. From the trained weights
# the first AdamW steps at 2e-4 raise the loss (phase 16 (b)'s float32
# steps, batch 8: 0.05308, 0.16398, 0.36353); at 2e-5 it falls over the 10
TP_LR = 2e-5
# the mesh steps' float32 gradients against one rank's, norm-wise per tensor:
# the plain 1 x 1 x 2 and 1 x 2 x 2 flagship steps read 3.17e-5 and 2.02e-5
# against the plain one-rank step on the CPU (batch 2, trained weights;
# chip_smoke's derivation in PERF.md section 2), so 1e-4 (within GRAD_TOL)
TP_GRAD_TOL = 1e-4
# per rank: each spectral attention of the flagship once per forward (22
# PGSSTBs and 2 PromptFusions), forward and backward
TP_LAUNCHES = {"spectral_stats_tp": 24, "spectral_apply_tp": 24}
# bf16 (derived on the CPU before the first chip run, PERF.md section 2;
# `python tests/tp_bounds.py 128 2 --bf16`): the members composed against
# the whole attention's bf16 call, every flagship spectral attention's
# shape in plain bf16 at 2 x 64^2: applies summed 4.46e-3 of max-abs, the
# backwards composed 4.87e-3 (K10a) and 4.74e-3 (K10b): about one bf16
# rounding of the largest value (2^-8); 1.2e-2 is three
TP_BF16_COMPOSE_TOL = 1.2e-2
# the stats stacked where a member's parts per image differ from the whole
# call's (the sums then add in another order)
TP_BF16_STATS_TOL = 1e-5
# the bf16 eval step against one rank's bf16 kernel forward: the plain bf16
# 1 x 1 x 2 and 1 x 2 x 2 forwards read 2.48e-2 and 2.59e-2 of max-abs
# against one rank on the CPU (trained weights, 128^2): each member's
# partial projection rounds to bf16 before the sum, one rank's once; twice
# the readings. The restored cube's PSNR within MODEL_PSNR_TOL of the
# one-rank float32 forward's
TP_BF16_EVAL_TOL = 5e-2
# the bf16 steps' gradients against one rank's bf16 step: every parameter's
# concatenated within MESH_BF16_GRAD_TOL (phase 16 (e)'s; the plain 1 x 1 x 2
# and 1 x 2 x 2 steps read 8.92e-3 and 8.85e-3 on the CPU, batch 2), and per
# tensor, where bf16 resolves it (MESH_BF16_NOISE_TOL), within
# TP_BF16_TENSOR_TOL: there the CPU read 3.76e-2 (1 x 1 x 2, a PromptFusion
# temperature) and 1.92e-2 (1 x 2 x 2), past phase 16 (e)'s 3e-2: twice the
# worst
TP_BF16_TENSOR_TOL = 7.5e-2
TP_BF16_BATCH = TRAIN_BATCH
TP_BWD_LAUNCHES = {"spectral_stats_bwd_tp": 24, "spectral_apply_bwd_tp": 24}
TP_BF16_KERNELS = {
    "spectral_stats_bf16_tp": dict(
        source="mp_hsir_tpu_torch/csrc/spectral_stats.cuh", tpu=["K7a"], of="stats",
        replaces="mp_hsir_tpu/ops/pallas_attention.py:2053", counter="spectral_stats_tp"),
    "spectral_apply_bf16_tp": dict(
        source="mp_hsir_tpu_torch/csrc/spectral.cu", tpu=["K7b"], of="apply",
        replaces="mp_hsir_tpu/ops/pallas_attention.py:2114", counter="spectral_apply_tp"),
    "spectral_stats_bwd_bf16_tp": dict(
        source="mp_hsir_tpu_torch/csrc/spectral_stats.cuh", tpu=["K10a"], of="stats_bwd",
        replaces="mp_hsir_tpu/ops/pallas_vjp.py:1671", counter="spectral_stats_bwd_tp"),
    "spectral_apply_bwd_bf16_tp": dict(
        source="mp_hsir_tpu_torch/csrc/spectral_apply_bwd.cuh", tpu=["K10b"], of="apply_bwd",
        replaces="mp_hsir_tpu/ops/pallas_vjp.py:1758", counter="spectral_apply_bwd_tp"),
}
TP_KERNELS = {
    "spectral_stats_f32_tp": dict(
        source="mp_hsir_tpu_torch/csrc/spectral_stats_f32.cuh", tpu=["K7a"], of="stats",
        replaces="mp_hsir_tpu/ops/pallas_attention.py:2053", counter="spectral_stats_tp"),
    "spectral_apply_f32_tp": dict(
        source="mp_hsir_tpu_torch/csrc/spectral.cu", tpu=["K7b"], of="apply",
        replaces="mp_hsir_tpu/ops/pallas_attention.py:2114", counter="spectral_apply_tp"),
    "spectral_stats_bwd_f32_tp": dict(
        source="mp_hsir_tpu_torch/csrc/spectral.cu", tpu=["K10a"], of="stats_bwd",
        replaces="mp_hsir_tpu/ops/pallas_vjp.py:1671", counter="spectral_stats_bwd_tp"),
    "spectral_apply_bwd_f32_tp": dict(
        source="mp_hsir_tpu_torch/csrc/spectral.cu", tpu=["K10b"], of="apply_bwd",
        replaces="mp_hsir_tpu/ops/pallas_vjp.py:1758", counter="spectral_apply_bwd_tp"),
}


def tp_member(t: int):
    """Member t of the spectral axis of TP_N, as the head-block slicing sees
    it (no process group: phase 17 (a) and (b) compose the members in one
    process)."""
    from mp_hsir_tpu_torch.parallel.mesh import SPECTRAL_AXIS, Axis

    return Axis(SPECTRAL_AXIS, t, TP_N, None, False)


def tp_eval_calls(cfg, size: int) -> Counter:
    """The flagship eval forward's spectral attentions as the head-parallel
    route runs them, with their counts: (B, side, C, heads, gate), gate
    "window" (an unshifted PGSSTB's per-window gates), "map" (a shifted one's
    per-pixel gate map) or "" (a PromptFusion: no gate, its LayerNorm
    outside)."""
    calls = Counter()
    for spec, mult in path_specs(cfg, size, "torch.float32").items():
        if spec[0] == "spectral_stats":
            _, b, h, _, c1, c2, nh, shift = spec[:8]
            calls[(b, h, c1 + c2, nh, "" if c2 else "map" if shift else "window")] += mult
    return calls


def tp_inputs(key, dev, dt=torch.float32) -> dict:
    """Seeded operands of one whole attention: the map, the full-size
    weights, the temperature, the projection and the gate of ``key``; the
    map and the gate in ``dt`` (the float32 draws rounded), the weights
    float32 as the model holds them."""
    b, h, c, nh, gate = key
    g = Inputs(zlib.crc32(repr(key).encode()), dev, torch.float32)
    d = dict(x=g.n((b, h, h, c)).to(dt), wq=g.u((3 * c, c, 1, 1), c),
             wd=g.u((3 * c, 1, 3, 3), 9), temp=1 + g.n((nh, 1, 1), 0.2),
             wout=g.u((c, c, 1, 1), c), gate=None)
    if gate:
        d["gate"] = g.n((b, h // 8 if gate == "window" else h, h // 8 if gate == "window" else h,
                         c), 0.5).to(dt)
    return d


def tp_bound_ms(dt, byts, flops) -> float:
    """A head-block call's bound in its type (bf16_bound_ms, f32_bound_ms)."""
    return (bf16_bound_ms if dt == torch.bfloat16 else f32_bound_ms)(byts, flops)


def tp_bound_by(dt, byts, flops) -> str:
    """Which of bytes and operations bounds a call of type ``dt``."""
    ops = flops / BF16_FLOPS if dt == torch.bfloat16 else 3 * flops / TF32_FLOPS
    return "bytes" if byts / HBM_BYTES_PER_S >= ops else "operations"


def tp_fwd_cost(x, cl: int, heads: int, gate) -> tuple:
    """(bytes, flops) of one member's stats and apply calls on x: each input
    read once and each output written once (the map, the gate, the output
    and the weight packs in x's type, the stats float32), the q|k and v 1x1s
    (C deep, 2CL and CL wide), the depthwise taps, the Gram and norms, the
    comb product (CL deep, C wide)."""
    b, h, w, c = x.shape
    p = b * h * w
    dh = cl // heads
    es = x.element_size()
    stats = (p * c * es + (2 * cl * c + 18 * cl) * es + b * (cl * dh + 2 * cl) * 4,
             p * (4 * c * cl + 36 * cl + 2 * cl * dh + 4 * cl))
    gb = 0 if gate is None else gate.numel() * es
    apply = (2 * p * c * es + b * cl * c * es + (cl * c + 9 * cl) * es + gb,
             p * (2 * c * cl + 18 * cl + 2 * cl * c))
    return stats, apply


def tp_forward_checks(dev, card: str, dt=torch.float32) -> dict:
    """Phase 17 (a): every distinct stats and apply call of the flagship
    forward on the head-parallel route (tp_eval_calls; phase 2's 512^2
    shapes) in ``dt`` as TP_N members' head blocks: each member's stats and
    apply kernels against their plain versions (F32_TOL of max-abs, BF16_TOL
    in bf16); the members composed against the whole attention's kernel
    calls: their stats stacked bitwise equal to the whole call's (in bf16
    within TP_BF16_STATS_TOL where a member's parts per image differ from
    the whole call's), their applies (each folded with its temperature and
    projection columns, the gate over n) summed within F32_TOL
    (TP_BF16_COMPOSE_TOL); the same at 2 row shards x TP_N members with halo
    rows (each member's stats summed over the shards, each shard's apply
    summed over the members); planted faults that must break the bound:
    member 1 on member 0's weights with its own temperature, the gate not
    scaled by 1/n. Member 0's calls timed beside their plain versions, the
    whole calls and their bounds."""
    from mp_hsir_tpu_torch.config import natural_scene_config
    from mp_hsir_tpu_torch.ops.kernels import spectral as sp
    from mp_hsir_tpu_torch.ops.kernels._route import plain_reference
    from mp_hsir_tpu_torch.ops.kernels.spectral import (
        spectral_apply, spectral_fold, spectral_stats,
    )
    from mp_hsir_tpu_torch.parallel.tp import head_block

    bf16 = dt == torch.bfloat16
    tol, ctol = (BF16_TOL, TP_BF16_COMPOSE_TOL) if bf16 else (F32_TOL, F32_TOL)

    def member_y(x, hb, gate, stats=None, halo=None, scale=1.0 / TP_N):
        st = spectral_stats(x, hb.wqkv, hb.wdw, hb.heads, halo=halo) if stats is None else stats
        comb = spectral_fold(*st, hb.temperature, hb.wout)
        return spectral_apply(x, comb, hb.wqkv, hb.wdw, halo=halo,
                              gate=None if gate is None else gate * scale).float()

    calls = tp_eval_calls(natural_scene_config(compute_dtype="float32"), SIZE)
    rows = []
    for key, mult in sorted(calls.items(), key=repr):
        d = tp_inputs(key, dev, dt)
        x, gate = d["x"], d["gate"]
        hbs = [head_block(d["wq"], d["wd"], d["temp"], d["wout"], key[3], tp_member(t))
               for t in range(TP_N)]
        row = dict(key=list(key), calls=mult)
        worst = 0.0
        kind_err = dict(stats=[0.0, 0.0], apply=[0.0, 0.0])  # (max abs, max rel) off plain
        stats, ys = [], []
        for hb in hbs:
            got = spectral_stats(x, hb.wqkv, hb.wdw, hb.heads)
            with plain_reference():
                ref = spectral_stats(x, hb.wqkv, hb.wdw, hb.heads)
            comb = spectral_fold(*got, hb.temperature, hb.wout)
            g = None if gate is None else gate / TP_N
            y = spectral_apply(x, comb, hb.wqkv, hb.wdw, gate=g)
            with plain_reference():
                yref = spectral_apply(x, comb, hb.wqkv, hb.wdw, gate=g)
            for kind, a, r in (("stats", got, ref), ("apply", y, yref)):
                e_abs, e = errs(a, r)
                worst = max(worst, e)
                kind_err[kind] = [max(kind_err[kind][0], e_abs), max(kind_err[kind][1], e)]
            stats.append(got)
            ys.append(y.float())
        if not worst <= tol:
            fail(f"head block {key} {dt}: {worst:.3e} of max-abs off its plain version")
        whole_st = spectral_stats(x, d["wq"], d["wd"], key[3])
        stacked = tuple(torch.cat([s[i] for s in stats], dim=1) for i in range(3))
        bitwise = all(torch.equal(a, b) for a, b in zip(stacked, whole_st))
        st_err = errs(stacked, whole_st)[1]
        b_, h_, c_, nh_ = key[0], key[1], key[2], key[3]
        same_parts = sp._stats_parts(int(bf16), b_, h_, h_, c_, c_ // TP_N, nh_ // TP_N) == \
            sp._stats_parts(int(bf16), b_, h_, h_, c_, c_, nh_)
        whole = spectral_apply(x, spectral_fold(*whole_st, d["temp"], d["wout"]), d["wq"],
                               d["wd"], gate=gate)
        summed = ys[0].clone()
        for y in ys[1:]:
            summed += y
        if not (bitwise or (bf16 and not same_parts and st_err <= TP_BF16_STATS_TOL)):
            fail(f"head block {key} {dt}: the members' stats stacked are not bitwise the whole "
                 f"call's ({st_err:.3e} of max-abs; parts per image "
                 f"{'equal' if same_parts else 'differ'})")
        comp = errs(summed, whole)[1]
        if not comp <= ctol:
            fail(f"head block {key} {dt}: the members' applies summed differ from the whole "
                 f"attention by {comp:.3e} of max-abs")
        # 2 row shards x TP_N members, with halo rows
        shard = []
        for i in range(2):
            a, k = shard_call((x,), {} if gate is None else dict(gate=gate), 2, i)
            if gate is not None and key[4] == "map":
                r0, r1 = i * x.shape[1] // 2, (i + 1) * x.shape[1] // 2
                k["gate"] = gate[:, r0:r1].contiguous()
            shard.append((a[0], k))
        part = []
        for hb in hbs:
            st = [spectral_stats(xs, hb.wqkv, hb.wdw, hb.heads, halo=k["halo"]) for xs, k in shard]
            for xs, k in shard:
                got = spectral_stats(xs, hb.wqkv, hb.wdw, hb.heads, halo=k["halo"])
                with plain_reference():
                    ref = spectral_stats(xs, hb.wqkv, hb.wdw, hb.heads, halo=k["halo"])
                e_abs, e = errs(got, ref)
                worst = max(worst, e)
                kind_err["stats"] = [max(kind_err["stats"][0], e_abs),
                                     max(kind_err["stats"][1], e)]
            tot = tuple(st[0][j] + st[1][j] for j in range(3))
            part.append([member_y(xs, hb, k.get("gate"), tot, k["halo"]) for xs, k in shard])
        rows_y = torch.cat([part[0][i] + part[1][i] for i in range(2)], dim=1)
        comp_halo = errs(rows_y, whole)[1]
        if not (worst <= tol and comp_halo <= ctol):
            fail(f"head block {key} {dt} on 2 row shards: {worst:.3e} off plain, composed "
                 f"{comp_halo:.3e} off the whole attention")
        faults = {"swapped_weights": errs(
            ys[0] + member_y(x, hbs[1]._replace(wqkv=hbs[0].wqkv, wdw=hbs[0].wdw), gate),
            whole)[1]}
        if gate is not None:
            faults["gate_not_over_n"] = errs(
                ys[0] + member_y(x, hbs[1], gate, scale=1.0), whole)[1]
        for f, e in faults.items():
            if not e > ctol:
                fail(f"head block {key} {dt}: the planted fault {f} went unseen ({e:.3e} of "
                     "max-abs)")
        hb = hbs[0]
        comb0 = spectral_fold(*stats[0], hb.temperature, hb.wout)
        g0 = None if gate is None else gate / TP_N
        (sb, sf), (ab, af) = tp_fwd_cost(x, hb.wqkv.shape[0] // 3, hb.heads, gate)
        t = dict(stats_ms=time_ms(lambda: spectral_stats(x, hb.wqkv, hb.wdw, hb.heads), 5),
                 apply_ms=time_ms(lambda: spectral_apply(x, comb0, hb.wqkv, hb.wdw, gate=g0), 5),
                 stats_whole_ms=time_ms(lambda: spectral_stats(x, d["wq"], d["wd"], key[3]), 5))
        wcomb = spectral_fold(*whole_st, d["temp"], d["wout"])
        t["apply_whole_ms"] = time_ms(lambda: spectral_apply(x, wcomb, d["wq"], d["wd"],
                                                             gate=gate), 5)
        with plain_reference():
            t["stats_plain_ms"] = time_ms(lambda: spectral_stats(x, hb.wqkv, hb.wdw, hb.heads), 1)
            t["apply_plain_ms"] = time_ms(lambda: spectral_apply(x, comb0, hb.wqkv, hb.wdw,
                                                                 gate=g0), 1)
        t.update(stats_bound_ms=tp_bound_ms(dt, sb, sf), apply_bound_ms=tp_bound_ms(dt, ab, af),
                 stats_bytes=sb, stats_flops=sf, apply_bytes=ab, apply_flops=af)
        row.update(max_rel_err=worst, composed_rel_err=comp, stats_bitwise=bitwise,
                   stacked_rel_err=st_err, stacked_same_parts=same_parts,
                   shards_rel_err=comp_halo, faults=faults, **t,
                   **{f"{k}_{n}": v for k, (a, r) in kind_err.items()
                      for n, v in (("max_abs_err", a), ("rel_err", r))})
        rows.append(row)
        stacked_how = ("bitwise" if bitwise else
                       f"{st_err:.1e} (parts {'equal' if same_parts else 'differ'})")
        log(f"  {key} x{mult} {dt}: members {worst:.2e} of max-abs off plain; applies summed "
            f"{comp:.2e}, stats stacked {stacked_how}, 2 shards x {TP_N} {comp_halo:.2e}; faults "
            + ", ".join(f"{f} {e:.2e}" for f, e in faults.items())
            + f"; member 0 stats {t['stats_ms']:.3f} ms (whole {t['stats_whole_ms']:.3f}, plain "
            f"{t['stats_plain_ms']:.3f}, bound {t['stats_bound_ms']:.4f}), apply "
            f"{t['apply_ms']:.3f} (whole {t['apply_whole_ms']:.3f}, plain "
            f"{t['apply_plain_ms']:.3f}, bound {t['apply_bound_ms']:.4f})")
        del d, x, gate, hbs, stats, ys, whole, whole_st, shard, part, rows_y
        torch.cuda.empty_cache()
    per = {}
    for of in ("stats", "apply"):
        s = {k: sum(r[f"{of}_{k}"] * r["calls"] for r in rows)
             for k in ("ms", "whole_ms", "plain_ms", "bound_ms", "bytes", "flops")}
        s["bound_by"] = tp_bound_by(dt, s["bytes"], s["flops"])
        s.update(calls=sum(r["calls"] for r in rows),
                 max_abs_err=max(r[f"{of}_max_abs_err"] for r in rows),
                 rel_err=max(r[f"{of}_rel_err"] for r in rows))
        per[of] = s
        log(f"  {of} per flagship forward ({dt}, member 0 of {TP_N}, its {s['calls']} calls): "
            f"{s['ms']:.2f} ms (the whole calls {s['whole_ms']:.2f}, plain {s['plain_ms']:.2f}, "
            f"bound {s['bound_ms']:.4f}, by {s['bound_by']}); members {s['rel_err']:.2e} of "
            "max-abs off plain")
    log(card)
    return dict(rows=rows, per_forward=per)


def tp_member_bwd(kind: str, args, t: int):
    """Member t's head block of one recorded whole-attention backward call
    (capture_spectral_bwd's arguments, LayerNorm and residual left out, as
    the head-parallel route runs them): its weight rows, its heads' Gram
    and norm cotangents (stats), its comb rows and the gate over n (apply)."""
    from mp_hsir_tpu_torch.parallel.tp import qkv_rows

    a = list(args)
    c = a[0].shape[-1]
    cl = c // TP_N
    if kind == "stats":
        hh = a[3] // TP_N
        a[1], a[2], a[3] = qkv_rows(a[1], c, cl, t), qkv_rows(a[2], c, cl, t), hh
        a[8] = a[8][:, t * cl:(t + 1) * cl].contiguous()
        a[9], a[10] = (v[:, t * hh:(t + 1) * hh].contiguous() for v in (a[9], a[10]))
    else:
        a[1] = a[1][:, t * cl:(t + 1) * cl].contiguous()
        a[2], a[3] = qkv_rows(a[2], c, cl, t), qkv_rows(a[3], c, cl, t)
        a[8] = None if a[8] is None else a[8] / TP_N
    return a


def tp_bwd_cost(kind: str, args) -> tuple:
    """(bytes, flops) of one member's K10a / K10b backward: each input and
    output read or written once (x, dx, dy and the gate in x's type; the
    weights and their cotangents, the stats' or comb's cotangents and the
    gate's cotangent float32), the products of the forward it recomputes
    and of its cotangents (bwd_cost's count at q/k/v width CL)."""
    x = args[0]
    b, h, w, c = x.shape
    es = x.element_size()
    cl = args[1 if kind == "stats" else 2].shape[0] // 3
    p = b * h * w
    if kind == "stats":
        dh = args[8].shape[-1]
        return (2 * p * c * es + (2 * cl * c + 18 * cl) * 2 * 4 + 3 * b * cl * dh * 4,
                2 * p * (2 * c * 2 * cl + 36 * cl) + 2 * p * (2 * cl * dh + 4 * cl))
    gate = args[8]
    gb = 0 if gate is None else gate.numel() * (es + 4)
    return (3 * p * c * es + 2 * b * cl * c * 4 + (cl * c + 9 * cl) * 2 * 4 + gb,
            2 * p * (2 * c * cl + 2 * cl * c + 18 * cl))


def tp_backward_checks(dev, card: str, dt=torch.float32) -> dict:
    """Phase 17 (b): every K10a / K10b call of the flagship step in ``dt``
    at batch TP_BATCH (TP_BF16_BATCH in bf16; one card's whole-map backward
    on the trained weights, capture_spectral_bwd, as the head-parallel route
    runs it: no LayerNorm, no residual) as TP_N members: each member's
    kernel backward against its plain backward (F32_TOL of each output's
    max-abs, BF16_TOL in bf16: dx, the weight cotangents, d comb, d gate, d
    dp); the members' dx summed and their weight cotangents scattered into
    full-size tensors, their d comb stacked, d dp summed, against the whole
    attention's kernel backward (F32_TOL, TP_BF16_COMPOSE_TOL); member 0
    timed beside its plain backward, the whole call and its bound, summed
    per step."""
    from mp_hsir_tpu_torch.ops.kernels import spectral as sp
    from mp_hsir_tpu_torch.parallel.tp import qkv_rows

    bf16 = dt == torch.bfloat16
    tol, ctol = (BF16_TOL, TP_BF16_COMPOSE_TOL) if bf16 else (F32_TOL, F32_TOL)
    nb = TP_BF16_BATCH if bf16 else TP_BATCH
    batch = train_batch(dev, nb, TRAIN_SIZE)
    calls = capture_spectral_bwd(dev, batch, "bfloat16" if bf16 else "float32")
    del batch
    torch.cuda.empty_cache()
    kern = dict(stats=sp._stats_bwd_launch, apply=sp._apply_bwd_launch)
    plain = dict(stats=sp.spectral_stats_bwd_plain, apply=sp.spectral_apply_bwd_plain)
    rows = []
    for kind, args in calls:
        args = list(args)
        args[5] = args[6] = None  # the head-parallel route's LayerNorm is outside
        if kind == "apply":
            args[7] = False
        c = args[0].shape[-1]
        whole = kern[kind](*args, None)
        outs, worst, worst_abs = [], 0.0, 0.0
        for t in range(TP_N):
            a = tp_member_bwd(kind, args, t) + [None]
            got = kern[kind](*a)
            e_abs, e = bwd_errs(got, plain[kind](*a))
            worst, worst_abs = max(worst, e), max(worst_abs, e_abs)
            outs.append(got)
        if not worst <= tol:
            fail(f"head-block {kind} backward at {tuple(args[0].shape)} {dt}: {worst:.3e} of "
                 "max-abs off its plain backward")
        dx = outs[0][0].float() + outs[1][0].float()
        iw = (1, 2) if kind == "stats" else (2, 3)
        got, want = [dx], [whole[0]]
        for i in iw:
            full = torch.zeros_like(whole[i])
            for t in range(TP_N):
                full.index_add_(0, qkv_rows(torch.arange(3 * c, device=dev), c, c // TP_N, t),
                                outs[t][i])
            got.append(full)
            want.append(whole[i])
        if kind == "apply":
            got.append(torch.cat([o[1] for o in outs], dim=1))
            want.append(whole[1])
            if whole[8] is not None:
                got.append(outs[0][8] + outs[1][8])
                want.append(whole[8])
        comp = bwd_errs(got, want)[1]
        if not comp <= ctol:
            fail(f"head-block {kind} backward at {tuple(args[0].shape)} {dt}: the members "
                 f"composed differ from the whole backward by {comp:.3e} of max-abs")
        a0 = tp_member_bwd(kind, args, 0) + [None]
        byts, flops = tp_bwd_cost(kind, a0)
        row = dict(kind=kind, shape=list(args[0].shape), calls=1, max_rel_err=worst,
                   max_abs_err=worst_abs, composed_rel_err=comp,
                   ms=time_ms(lambda: kern[kind](*a0), 5),
                   whole_ms=time_ms(lambda: kern[kind](*args, None), 5),
                   plain_ms=time_ms(lambda: plain[kind](*a0), 1), bytes=byts, flops=flops,
                   bound_ms=tp_bound_ms(dt, byts, flops))
        rows.append(row)
        del whole, outs, got, want
    torch.cuda.empty_cache()
    per = {}
    for kind in ("stats", "apply"):
        rs = [r for r in rows if r["kind"] == kind]
        s = {k: sum(r[k] for r in rs) for k in ("ms", "whole_ms", "plain_ms", "bound_ms", "bytes",
                                                "flops")}
        s["bound_by"] = tp_bound_by(dt, s["bytes"], s["flops"])
        s.update(calls=len(rs), max_abs_err=max(r["max_abs_err"] for r in rs),
                 rel_err=max(r["max_rel_err"] for r in rs),
                 composed_rel_err=max(r["composed_rel_err"] for r in rs))
        per[kind + "_bwd"] = s
        log(f"  {kind} backward per flagship step ({dt}, batch {nb}, member 0 of {TP_N}, its "
            f"{s['calls']} calls): members {s['rel_err']:.2e} of max-abs off plain, composed "
            f"{s['composed_rel_err']:.2e}; {s['ms']:.2f} ms (the whole calls {s['whole_ms']:.2f}"
            f", plain {s['plain_ms']:.2f}, bound {s['bound_ms']:.4f}, by {s['bound_by']})")
    log(card)
    return dict(rows=rows, per_step=per)


def _tp_counts() -> dict:
    from mp_hsir_tpu_torch.ops.kernels import _route

    return {k: c.launches for k, c in _route.COUNTERS.items() if c.launches}


def _tp_eval_rank(info, preset: str, degraded, tid, mesh, dtype: str = "float32") -> dict:
    """Phase 17 (c) / (e) on this rank: make_eval_step on ``mesh`` in
    ``dtype``, the flagship's trained weights or the remote-sensing preset's
    seeded ones, one counted and timed call (the first: every kernel is
    built). Returns the output (rank 0) and every rank's launches, plain
    calls and ms."""
    import torch.distributed as dist

    from mp_hsir_tpu_torch.checkpoint import load_params_npz
    from mp_hsir_tpu_torch.config import natural_scene_config, remote_sensing_config
    from mp_hsir_tpu_torch.models.mp_hsir import build_model
    from mp_hsir_tpu_torch.ops.kernels import _route
    from mp_hsir_tpu_torch.training.trainer import make_eval_step

    dev = info.device
    if preset == "natural_scene":
        cfg = natural_scene_config(compute_dtype=dtype)
        model = build_model(cfg, dev)
        load_params_npz(ART, model)
    else:
        cfg = remote_sensing_config(compute_dtype=dtype)
        torch.manual_seed(RS_SEED)
        model = build_model(cfg, dev)
    step = make_eval_step(cfg, mesh)
    x, t = degraded.to(dev), tid.to(dev)
    torch.cuda.synchronize()
    _route.reset_counters()
    t0 = time.perf_counter()
    out = step(model, x, t)
    torch.cuda.synchronize()
    mine = dict(ms=(time.perf_counter() - t0) * 1e3, launches=_tp_counts(),
                plain_calls=_route.ROUTE.plain_cuda_calls, device=str(dev), backend=info.backend)
    ranks = [None] * info.world_size
    dist.all_gather_object(ranks, mine)
    del model
    torch.cuda.empty_cache()
    return dict(out=out.cpu(), ranks=ranks)


def tp_eval_inputs(dev, preset: str, dtype: str = "float32") -> dict:
    """One cube of ``preset`` (the flagship: phase 3's 512^2 quality cube on
    the trained weights; the remote-sensing preset: a 256^2 100-band cube
    on its seeded weights), the one-rank float32 forward on it and, for
    ``dtype`` bfloat16, the one-rank bf16 kernel forward (``one``; else the
    float32 one)."""
    from mp_hsir_tpu_torch.checkpoint import load_params_npz
    from mp_hsir_tpu_torch.config import natural_scene_config, remote_sensing_config
    from mp_hsir_tpu_torch.models.mp_hsir import build_model

    x, outs = None, {}
    for dt in ["float32"] + (["bfloat16"] if dtype == "bfloat16" else []):
        if preset == "natural_scene":
            clean, degraded = quality_cube(990, SIZE)
            model = build_model(natural_scene_config(compute_dtype=dt), dev)
            load_params_npz(ART, model)
            tid = 0
        else:
            clean, degraded = quality_cube(990, RS_SIZE, 100)
            torch.manual_seed(RS_SEED)
            model = build_model(remote_sensing_config(compute_dtype=dt), dev)
            tid = 6
        x, t = torch.from_numpy(degraded)[None], torch.tensor([tid])
        with torch.inference_mode():
            outs[dt] = model(x.to(dev), t.to(dev)).float().cpu()
        del model
        torch.cuda.empty_cache()
    return dict(preset=preset, x=x, t=t, one=outs[dtype], one_f32=outs["float32"],
                clean=torch.from_numpy(clean)[None], dtype=dtype)


def tp_eval_verdict(dev, job: dict, res: dict, shape) -> dict:
    """Phase 17 (c) / (e)'s checks: the mesh's output against the one-rank
    forward of its type (MODEL_F32_TOL of max-abs in float32; bf16:
    TP_BF16_EVAL_TOL against the one-rank bf16 kernel forward, and PSNR
    within MODEL_PSNR_TOL of the one-rank float32 forward's), PSNR and SSIM
    against the clean cube within MESH_CLI_TOL of one rank's in float32; per
    rank the head-block launches of one forward (the flagship: TP_LAUNCHES)
    and no plain call; ms per forward per rank (ranks sharing one card: not
    a multi-card figure)."""
    from mp_hsir_tpu_torch.ops.metrics import compute_psnr_ssim

    preset, out, one = job["preset"], res["out"].float(), job["one"]
    bf16 = job["dtype"] == "bfloat16"
    err = ((out - one).abs().max() / one.abs().max()).item()
    c = job["clean"].to(dev)
    p1, s1, _ = compute_psnr_ssim(one.to(dev), c)
    p2, s2, _ = compute_psnr_ssim(out.to(dev), c)
    what = f"{preset} {job['dtype']} {'x'.join(map(str, shape))}"
    if bf16:
        p32, s32, _ = compute_psnr_ssim(job["one_f32"].to(dev), c)
        log(f"  {what} eval step: {err:.2e} of max-abs off one rank's bf16 forward (bound "
            f"{TP_BF16_EVAL_TOL}); PSNR {p2:.4f} / one rank bf16 {p1:.4f} / float32 {p32:.4f} "
            f"(bound {MODEL_PSNR_TOL} dB), SSIM {s2:.5f} / {s1:.5f} / {s32:.5f}")
        if not (err <= TP_BF16_EVAL_TOL and abs(p2 - p32) <= MODEL_PSNR_TOL):
            fail(f"{what} spectral-axis eval step: {err:.3e} off one rank, PSNR {p2} vs float32 "
                 f"{p32}")
    else:
        log(f"  {what} eval step: {err:.2e} of max-abs off one rank (bound {MODEL_F32_TOL}); "
            f"PSNR {p2:.4f} / one rank {p1:.4f}, SSIM {s2:.5f} / {s1:.5f}")
        if not (err <= MODEL_F32_TOL and abs(p2 - p1) <= MESH_CLI_TOL[0]
                and abs(s2 - s1) <= MESH_CLI_TOL[1]):
            fail(f"{preset} spectral-axis eval step: {err:.3e} off one rank, PSNR {p2} vs {p1}, "
                 f"SSIM {s2} vs {s1}")
    for r, rk in enumerate(res["ranks"]):
        got = {k: rk["launches"].get(k, 0) for k in TP_LAUNCHES}
        if rk["plain_calls"] or min(got.values()) == 0 or (
                preset == "natural_scene" and got != TP_LAUNCHES):
            fail(f"{what} rank {r}: head-block launches {got} (expected "
                 f"{TP_LAUNCHES if preset == 'natural_scene' else 'some of each'}), plain calls "
                 f"{rk['plain_calls']}")
        log(f"  {what} rank {r} ({rk['device']}, {rk['backend']}): {rk['ms']:.1f} ms for its "
            f"first forward (ranks sharing one card: not a multi-card figure); launches {got}")
    return dict(rel_err=err, psnr=(p2, p1), ssim=(s2, s1), ranks=res["ranks"])


def _tp_check_route_bwd(sp, out: dict):
    """Wrap the float32 spectral backward launches of ``sp`` so that each
    call the head-parallel route makes is held against its plain backward
    on the same arguments (the route's own shift, gate operand, drop-path
    scale and halo rows): per kind ("stats", "apply") the calls, the worst
    max-abs error, the shifts seen and, for the apply, the gate operands
    ("window", "map" or "none"). Returns the function that restores the
    launches."""
    orig = sp._stats_bwd_launch, sp._apply_bwd_launch
    plain = dict(stats=sp.spectral_stats_bwd_plain, apply=sp.spectral_apply_bwd_plain)

    def checked(kind, fn):
        def run(*a):
            got = fn(*a)
            rec = out.setdefault(kind, dict(calls=0, worst=0.0, worst_abs=0.0, shifts=[],
                                            head_blocks=0, gates=Counter()))
            e_abs, e = bwd_errs(got, plain[kind](*a))
            rec["calls"] += 1
            rec["worst"], rec["worst_abs"] = max(rec["worst"], e), max(rec["worst_abs"], e_abs)
            rec["shifts"] = sorted(set(rec["shifts"]) | {a[4]})
            wq = a[1] if kind == "stats" else a[2]
            rec["head_blocks"] += int(wq.shape[0] // 3 < a[0].shape[-1])
            if kind == "apply":
                g = a[8]
                rec["gates"]["none" if g is None else
                             "map" if g.shape[1] == a[0].shape[1] else "window"] += 1
            return got
        return run

    sp._stats_bwd_launch = checked("stats", orig[0])
    sp._apply_bwd_launch = checked("apply", orig[1])

    def restore():
        sp._stats_bwd_launch, sp._apply_bwd_launch = orig
    return restore


def _tp_train_rank(info, mesh, batch: dict, cot, seed: int, steps: int,
                   dtype: str = "float32") -> dict:
    """Phase 17 (d) on this rank: the flagship model in ``dtype`` on the
    trained weights on ``mesh``: (1) its block's gradients with the given loss
    cotangent, summed over every rank and divided by the spectral axis's
    size (each member holds the whole batch's replicated gradients and n
    times its head block's: the sum over the members is n times the whole
    batch's), with the backward's launches and plain calls; then the same
    backward again with every head-block backward launch held against its
    plain backward (_tp_check_route_bwd); (2) ``steps``
    AdamW steps at TP_LR of make_train_step on the global batch: losses,
    ms, launches, whether the parameters are bitwise equal across the ranks
    after TP_BITWISE_STEPS and after all."""
    import torch.distributed as dist

    from mp_hsir_tpu_torch.checkpoint import load_params_npz
    from mp_hsir_tpu_torch.config import TrainConfig, natural_scene_config
    from mp_hsir_tpu_torch.models.mp_hsir import build_model
    from mp_hsir_tpu_torch.ops.kernels import _route
    from mp_hsir_tpu_torch.ops.kernels import spectral as sp
    from mp_hsir_tpu_torch.parallel.mesh import (
        DATA_AXIS, MESH_AXES, SPATIAL_AXIS, SPECTRAL_AXIS, all_gather, axis_index,
    )
    from mp_hsir_tpu_torch.training.trainer import (
        batch_block, create_train_state, fold_seed, make_train_step, sync_parameters,
    )

    dev = info.device
    cfg = natural_scene_config(compute_dtype=dtype)
    model = build_model(cfg, dev, train=True)
    load_params_npz(ART, model)
    sp_ax, dp_ax, tp_ax, every = (mesh.axis(a) for a in (SPATIAL_AXIS, DATA_AXIS, SPECTRAL_AXIS,
                                                         MESH_AXES))
    gb = {k: v.to(dev) for k, v in batch.items()}
    block = batch_block(gb, mesh)
    b0 = axis_index(dp_ax) * block["degraded"].shape[0]
    r0 = axis_index(sp_ax) * block["degraded"].shape[2]
    cb = cot.to(dev)[b0:b0 + block["degraded"].shape[0], :, r0:r0 + block["degraded"].shape[2]]
    mine = {}
    gen = torch.Generator(device=dev).manual_seed(fold_seed(seed, axis_index(dp_ax)))
    pred = model(block["degraded"], block["task_id"], gen, axis=sp_ax, spectral=tp_ax)
    cb = cb.to(pred.dtype).contiguous()
    torch.cuda.synchronize()
    _route.reset_counters()
    pred.backward(cb)
    torch.cuda.synchronize()
    mine["bwd_launches"] = _tp_counts()
    mine["bwd_plain_calls"] = _route.ROUTE.plain_cuda_calls
    grads = {k: v / mesh.spectral for k, v in _psum_grads(model, every).items()}
    model.zero_grad(set_to_none=True)
    del pred
    # the same forward and backward again, each head-block backward launch
    # held against its plain backward on the route's own arguments
    gen = torch.Generator(device=dev).manual_seed(fold_seed(seed, axis_index(dp_ax)))
    pred = model(block["degraded"], block["task_id"], gen, axis=sp_ax, spectral=tp_ax)
    mine["route_bwd"] = {}
    restore = _tp_check_route_bwd(sp, mine["route_bwd"])
    try:
        pred.backward(cb)
    finally:
        restore()
    model.zero_grad(set_to_none=True)
    del pred
    tc = TrainConfig(warmup_frac=0.0, lr=TP_LR, batch_size=gb["degraded"].shape[0],
                     patch_size=gb["degraded"].shape[2])
    st = create_train_state(cfg, tc, device=dev, model=model)
    sync_parameters(st, mesh)
    step = make_train_step(cfg, tc, mesh)
    losses, times, same = [], [], []
    _route.reset_counters()
    for s in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(st, gb, seed + s)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        if s + 1 in (TP_BITWISE_STEPS, steps):
            flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
            same.append(all(torch.equal(p, flat) for p in all_gather(flat, every)))
    mine.update(losses=losses, ms=times, same_params=same, launches=_tp_counts(),
                plain_calls=_route.ROUTE.plain_cuda_calls, device=str(dev), backend=info.backend)
    ranks = [None] * info.world_size
    dist.all_gather_object(ranks, mine)
    return dict(grads=grads, ranks=ranks)


def _tp_rank(info, shape, runs):
    """One rank of phase 17 (c) - (e): on the (data, spatial, spectral) mesh
    ``shape``, for each (dtype, evals, train) of ``runs`` in order (one
    process for both compute types), each eval job of ``evals`` (preset,
    cube, task id), then ``train`` ((batch, cot, seed, steps) or None), in
    that dtype. Every rank runs the same collectives in the same order; rank
    0 returns the results by dtype."""
    from mp_hsir_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(*shape)
    res = {}
    for dtype, evals, train in runs:
        r = res[dtype] = dict(evals=[_tp_eval_rank(info, *job, mesh, dtype) for job in evals])
        if train is not None:
            r["train"] = _tp_train_rank(info, mesh, *train, dtype)
        torch.cuda.empty_cache()
    return res if info.rank == 0 else None


def tp_step_verdict(what: str, out: dict, g_kern: dict, steps: int, noise=None) -> dict:
    """Phase 17 (d)'s checks on one mesh's step: the gradients (the
    one-rank plain step's loss cotangent; bf16: the one-rank bf16 step's)
    against the one-rank kernel step in the same type (float32: TP_GRAD_TOL,
    norm-wise per tensor; bf16, where ``noise`` holds each tensor's one-rank
    bf16 gradient's distance from its float32 one: every tensor
    concatenated within MESH_BF16_GRAD_TOL, and per tensor within
    TP_BF16_TENSOR_TOL where that distance is within MESH_BF16_NOISE_TOL);
    per rank per step the head-block forward and
    backward launches (TP_LAUNCHES, TP_BWD_LAUNCHES) and no plain call; each of the route's
    head-block backward launches within F32_TOL (BF16_TOL) of its plain
    backward, at shift 0 and with the shifted blocks' gate maps; the
    parameters bitwise equal across the ranks after TP_BITWISE_STEPS and
    after ``steps``; where ``steps`` is TP_STEPS, the loss falls over them;
    ms per step per rank (ranks sharing one card: not a multi-card
    figure)."""
    bf16 = noise is not None
    vs_one = grad_rel({k: v.float() for k, v in out["grads"].items()}, g_kern)
    row = dict(grad_vs_one_rank=vs_one[:5], ranks=[])
    if bf16:
        keys = sorted(g_kern)
        mesh_flat = torch.cat([out["grads"][k].float().reshape(-1) for k in keys])
        one_flat = torch.cat([g_kern[k].reshape(-1) for k in keys])
        flat = ((mesh_flat - one_flat).norm() / one_flat.norm()).item()
        resolved = [(e, k) for e, k in vs_one if noise[k] <= MESH_BF16_NOISE_TOL]
        log(f"  {what}: gradients vs one rank's bf16 step, concatenated {flat:.2e} (bound "
            f"{MESH_BF16_GRAD_TOL}); per tensor where bf16 resolves it ({len(resolved)} of "
            f"{len(vs_one)}) worst {resolved[0][0]:.2e} ({resolved[0][1]}; bound "
            f"{TP_BF16_TENSOR_TOL}); overall worst {vs_one[0][0]:.2e} ({vs_one[0][1]})")
        if flat > MESH_BF16_GRAD_TOL or resolved[0][0] > TP_BF16_TENSOR_TOL:
            fail(f"{what}: gradients {flat:.2e} off one rank's concatenated, {resolved[0][1]} "
                 f"{resolved[0][0]:.2e}")
        row.update(grad_concat_vs_one_rank=flat, grad_resolved_vs_one_rank=resolved[:5])
    else:
        log(f"  {what}: gradients vs one rank worst {vs_one[0][0]:.2e} ({vs_one[0][1]}; bound "
            f"{TP_GRAD_TOL})")
        if vs_one[0][0] > TP_GRAD_TOL:
            fail(f"{what}: gradient of {vs_one[0][1]} differs from one rank's by "
                 f"{vs_one[0][0]:.2e}")
    tol = BF16_TOL if bf16 else F32_TOL
    for r, rk in enumerate(out["ranks"]):
        bl = {k: rk["bwd_launches"].get(k, 0) for k in TP_BWD_LAUNCHES}
        per = {k: rk["launches"].get(k, 0) / steps for k in TP_BWD_LAUNCHES}
        per_fwd = {k: rk["launches"].get(k, 0) / steps for k in TP_LAUNCHES}
        if rk["bwd_plain_calls"] or rk["plain_calls"]:
            fail(f"{what} rank {r}: plain-version calls on CUDA tensors")
        if bl != TP_BWD_LAUNCHES or per != TP_BWD_LAUNCHES or per_fwd != TP_LAUNCHES:
            fail(f"{what} rank {r}: head-block backward launches {bl}, per step {per}, "
                 f"expected {TP_BWD_LAUNCHES}; forward per step {per_fwd}, expected "
                 f"{TP_LAUNCHES}")
        for kind, rec in sorted(rk["route_bwd"].items()):
            n = TP_BWD_LAUNCHES[f"spectral_{kind}_bwd_tp"]
            if rec["worst"] > tol or rec["calls"] != n or rec["head_blocks"] != n:
                fail(f"{what} rank {r}: the route's head-block {kind} backwards: {rec['calls']} "
                     f"calls ({rec['head_blocks']} head blocks), {rec['worst']:.3e} of max-abs "
                     "off their plain backwards")
            if rec["shifts"] != [0] or (kind == "apply" and not rec["gates"]["map"]):
                fail(f"{what} rank {r}: the route's {kind} backwards ran with shifts "
                     f"{rec['shifts']}, gates {dict(rec['gates'])} (expected shift 0, gate maps)")
        if set(rk["route_bwd"]) != {"stats", "apply"}:
            fail(f"{what} rank {r}: the route's head-block backwards were not checked")
        log(f"  {what} rank {r}: the route's own head-block backwards against plain: "
            + "; ".join(f"{k} {v['calls']} calls, worst {v['worst']:.2e} of max-abs"
                        + (f", gates {dict(v['gates'])}" if k == "apply" else "")
                        for k, v in sorted(rk["route_bwd"].items())))
        if not all(rk["same_params"]):
            fail(f"{what}: rank {r}'s parameters differ from rank 0's after the steps")
        losses = rk["losses"]
        if not all(np.isfinite(losses)) or (steps == TP_STEPS and not losses[-1] < losses[0]):
            fail(f"{what} rank {r}: the loss did not fall over {steps} steps: {losses}")
        med = statistics.median(rk["ms"][1:])
        shared = ("ranks sharing one card: not a multi-card figure" if rk["backend"] == "gloo"
                  else "one card a rank")
        log(f"  {what} rank {r} ({rk['device']}, {rk['backend']}): "
            f"{'bf16' if bf16 else 'float32'} ms per step {med:.1f} ({shared}); head-block "
            f"launches a step {per_fwd} + {per}; losses " + " ".join(f"{v:.5f}" for v in losses))
        row["ranks"].append(dict(rank=r, ms=rk["ms"], median_ms=med, losses=losses,
                                 launches=rk["launches"], bwd_launches=bl))
    return row


def tp_mesh_checks(dev, card: str, backend_cards: bool = False,
                   dtypes=("float32", "bfloat16")) -> dict:
    """Phase 17 (c) - (e) in each of ``dtypes`` on ranks sharing this card
    over gloo (one card a rank over NCCL with ``backend_cards``: the 1 x 1 x
    2 step alone): one spawn of TP_N ranks on a 1 x 1 x TP_N mesh runs, in
    each type in turn, (c) the flagship eval step, (e) the remote-sensing
    eval step and (d) TP_STEPS train steps (batch TP_BATCH x 31 x 64^2,
    TP_BF16_BATCH in bf16, trained weights, drop-path on); then one spawn on
    a 1 x 2 x TP_N mesh runs (d) in each type, TP_BITWISE_STEPS steps.
    Returns the verdicts by dtype."""
    from mp_hsir_tpu_torch.parallel import distributed

    jobs = {}
    for dtype in dtypes:
        bf16 = dtype == "bfloat16"
        evals = [] if backend_cards else [tp_eval_inputs(dev, p, dtype)
                                          for p in ("natural_scene", "remote_sensing")]
        batch = train_batch(dev, TP_BF16_BATCH if bf16 else TP_BATCH, TRAIN_SIZE)
        host = {k: v.cpu() for k, v in batch.items()}
        noise = None
        if bf16:
            g_kern, g32, cot = one_rank_bf16_grads(dev, batch, 5)
            noise = {k: e for e, k in grad_rel(g_kern, g32)}
            del g32
        else:
            g_kern, _, cot = one_rank_grads(dev, batch, True)
        del batch
        torch.cuda.empty_cache()
        jobs[dtype] = dict(evals=evals, host=host, cot=cot.cpu(), g_kern=g_kern, noise=noise)
    shape = (1, 1, TP_N)
    out = distributed.spawn(
        _tp_rank, TP_N, shape,
        [(dt, [(j["preset"], j["x"], j["t"]) for j in jobs[dt]["evals"]],
          (jobs[dt]["host"], jobs[dt]["cot"], 5, TP_STEPS)) for dt in dtypes],
        device="cuda", timeout_s=900)
    res = {dt: {} for dt in dtypes}
    for dt in dtypes:
        j, o = jobs[dt], out[dt]
        for job, r in zip(j["evals"], o["evals"]):
            res[dt]["eval" if job["preset"] == "natural_scene" else "eval_rs"] = tp_eval_verdict(
                dev, job, r, shape)
        what = f"1x1x{TP_N} {dt}" + (" nccl" if backend_cards else "")
        res[dt]["steps"] = {f"1x1x{TP_N}": tp_step_verdict(what, o["train"], j["g_kern"],
                                                           TP_STEPS, j["noise"])}
    if not backend_cards:
        shape = (1, 2, TP_N)
        out = distributed.spawn(
            _tp_rank, 2 * TP_N, shape,
            [(dt, [], (jobs[dt]["host"], jobs[dt]["cot"], 5, TP_BITWISE_STEPS)) for dt in dtypes],
            device="cuda", timeout_s=900)
        for dt in dtypes:
            res[dt]["steps"][f"1x2x{TP_N}"] = tp_step_verdict(
                f"1x2x{TP_N} {dt}", out[dt]["train"], jobs[dt]["g_kern"], TP_BITWISE_STEPS,
                jobs[dt]["noise"])
    log(card)
    return res


def tp_kernel_rows(res: dict, kernels: dict, dtype: str) -> list:
    """The kernels line's rows of the four head-block instances of one type:
    launches from (c)'s and (d)'s 1 x 1 x 2 runs (rank 0), times per
    flagship forward from (a), per step from (b), the whole calls' beside
    them."""
    rank0_eval = res["eval"]["ranks"][0]["launches"]
    rank0_step = res["steps"][f"1x1x{TP_N}"]["ranks"][0]["launches"]
    rows = []
    for name, meta in kernels.items():
        fwd = meta["of"] in ("stats", "apply")
        p = res["fwd"]["per_forward"][meta["of"]] if fwd else res["bwd"]["per_step"][meta["of"]]
        n = (rank0_eval if fwd else rank0_step).get(meta["counter"], 0)
        if n == 0:
            fail(f"the head-block instance {name} was not launched on phase 17's path")
        rows.append(dict(
            name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
            tpu=meta["tpu"], launches=n, max_abs_err=p["max_abs_err"], rel_err=p["rel_err"],
            ms=p["ms"], plain_ms=p["plain_ms"], bound_ms=p["bound_ms"], bound_by=p["bound_by"],
            library_ms=None, unsharded_ms=p["whole_ms"],
            **{"launches_per_forward" if fwd else "launches_per_step": p["calls"]},
            mesh=dict(shape=f"1x1x{TP_N}", dtype=dtype, what="eval step" if fwd else
                      f"{TP_STEPS} train steps")))
    return rows


def tp_phase(dev, card: str) -> dict:
    """Phase 17: in float32, then in bf16: (a) the head-block forward tiles,
    (b) the head-block backwards, (c) the flagship 1 x 1 x 2 eval step, (d)
    the 1 x 1 x 2 and 1 x 2 x 2 train steps, (e) the remote-sensing 1 x 1 x
    2 eval step; the summary rows of the eight head-block instances
    (tp_kernel_rows)."""
    log("== phase 17: the head-parallel spectral mesh axis (float32, then bf16): the head-block "
        "tiles and backwards, the eval and train steps on ranks sharing this card")
    log(card)
    t0 = time.perf_counter()

    def since():
        return f"[{time.perf_counter() - t0:.1f} s into phase 17]"

    res = dict(fwd=tp_forward_checks(dev, card))
    log(f"  (b) the head-block backwards {since()}:")
    res["bwd"] = tp_backward_checks(dev, card)
    log(f"  (a) in bf16 {since()}:")
    bf = res["bf16"] = dict(fwd=tp_forward_checks(dev, card, torch.bfloat16))
    log(f"  (b) in bf16 {since()}:")
    bf["bwd"] = tp_backward_checks(dev, card, torch.bfloat16)
    log(f"  (c) - (e) the eval and train steps, float32 then bf16, in the same ranks {since()}:")
    mesh = tp_mesh_checks(dev, card)
    res.update(mesh["float32"])
    bf.update(mesh["bfloat16"])
    res["kernels"] = tp_kernel_rows(res, TP_KERNELS, "float32")
    res["kernels"] += tp_kernel_rows(bf, TP_BF16_KERNELS, "bfloat16")
    log(f"  phase 17 in {time.perf_counter() - t0:.1f} s")
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="", help="write the detailed results here (JSON)")
    ap.add_argument("--bwd-split", action="append", default=[], choices=sorted(BWD_SPLIT),
                    metavar="KERNEL", help="only time this backward kernel's stages at the train "
                    f"steps' shapes (one of {', '.join(sorted(BWD_SPLIT))}; repeatable)")
    ap.add_argument("--mlp-bwd-split", action="store_true", help="the same as --bwd-split mlp_bwd")
    ap.add_argument("--wgrad", action="store_true", help="only the wgrad checks at both train "
                    "steps' signatures (after the build)")
    ap.add_argument("--train-cli", action="store_true", help="only phase 13, the training entry "
                    "point (after the build)")
    ap.add_argument("--eval-cli", action="store_true", help="only phase 14, the eval entry "
                    "point (after the build)")
    ap.add_argument("--f32-eval", action="store_true", help="only phase 1, phase 2 (its "
                    "float32 times and the C = 400 calls), K6's float32 calls of phases 5 and "
                    "11, and phase 14: the float32 path, for this checkout or an older one")
    ap.add_argument("--mesh-eval", action="store_true", help="only phase 15, the row-sharded "
                    "eval forward (after the build)")
    ap.add_argument("--mesh-cards", action="store_true", help="only the row-sharded eval CLI, "
                    "the 1 x 2 and the 1 x 1 x 2 train steps with one rank a card over NCCL (a "
                    "machine with several cards)")
    ap.add_argument("--mesh-train", action="store_true", help="only phase 16, the row- and "
                    "data-sharded train step (after the build)")
    ap.add_argument("--mesh-tp", action="store_true", help="only phase 17, the head-parallel "
                    "spectral mesh axis in float32 (after the build)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs an NVIDIA GPU")
    t_start = time.perf_counter()
    try:
        from mp_hsir_tpu_torch.checkpoint import load_params_npz
        from mp_hsir_tpu_torch.config import natural_scene_config, remote_sensing_config
        from mp_hsir_tpu_torch.models.mp_hsir import build_model
        from mp_hsir_tpu_torch.ops.kernels import _build
    except ImportError as e:
        fail(f"the mp_hsir_tpu_torch package is not importable here ({e})")
    if not os.path.exists(ART):
        fail(f"{ART} not found: run from the root of the repository")
    dev = torch.device("cuda", 0)

    log("== phase 1: environment and build")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    log(card)
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.build()
    log(f"  kernels built in {time.perf_counter() - t0:.1f} s ({_build.BUILD_INFO.get('path')}, "
        f"cached={_build.BUILD_INFO.get('cached')}); each source's nvcc ended at (s): "
        f"{_build.BUILD_INFO.get('seconds_by_source')}")
    for line in _build.BUILD_INFO.get("log", "").splitlines():
        if "registers" in line or "spill" in line.lower() and "0 bytes spill" not in line:
            log("  ptxas: " + line.strip())

    cfg = natural_scene_config(compute_dtype="bfloat16")
    preset_cfgs = (cfg, remote_sensing_config(compute_dtype="bfloat16"))
    splits = args.bwd_split + ["mlp_bwd"] * args.mlp_bwd_split
    if splits:
        split_only(dev, preset_cfgs, args.out, list(dict.fromkeys(splits)))
        log(f"== done in {time.perf_counter() - t_start:.1f} s")
        return
    wgrad_ptxas = log_wgrad_ptxas()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if args.wgrad:
        res = {}
        for c_, what in zip(preset_cfgs, ("flagship", "remote sensing")):
            log(f"== wgrad: every weight product of the {what} train step")
            res[what] = wgrad_checks(train_path_specs(c_, TRAIN_BATCH, TRAIN_SIZE,
                                                      "torch.bfloat16"), dev, what)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump(dict(card=card, ptxas=wgrad_ptxas, **res), fh, indent=1)
        log(f"== done in {time.perf_counter() - t_start:.1f} s")
        return
    if args.train_cli:
        log("== phase 13 only: the training entry point")
        cli = train_cli_path(dev, train_path_specs(preset_cfgs[1], TRAIN_BATCH, TRAIN_SIZE,
                                                   "torch.bfloat16"), None)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump(dict(card=card, train_cli=cli), fh, indent=1)
        log(f"== done in {time.perf_counter() - t_start:.1f} s")
        return
    if args.mesh_cards:
        log("== the row-sharded eval CLI on this machine's cards, one rank a card")
        cards = mesh_cards_checks(dev, card)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump(dict(card=card, mesh_cards=cards), fh, indent=1, default=str)
        log(f"== done in {time.perf_counter() - t_start:.1f} s")
        return
    if args.mesh_train:
        mesh_train = mesh_train_phase(dev, card)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump(dict(card=card, mesh_train=mesh_train), fh, indent=1, default=str)
        log(f"== done in {time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"kernels": mesh_train["kernels"] + mesh_train["bf16_halo_rows"]}))
        return
    if args.mesh_tp:
        tp = tp_phase(dev, card)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump(dict(card=card, mesh_tp=tp), fh, indent=1, default=str)
        log(f"== done in {time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"kernels": tp["kernels"]}))
        return
    if args.mesh_eval:
        log("== phase 15 only: the row-sharded eval forward")
        mesh = dict(halo=halo_tile_checks(dev, card))
        log("  (a) in bf16:")
        mesh["halo_bf16"] = halo_tile_checks(dev, card, torch.bfloat16)
        mesh["cli"] = mesh_cli_checks(dev, card)
        log("  gloo with CUDA tensors (two ranks on this card, each op apart):")
        mesh["gloo_cuda"] = gloo_cuda_probe()
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump(dict(card=card, mesh=mesh), fh, indent=1, default=str)
        log(f"== done in {time.perf_counter() - t_start:.1f} s")
        return
    if args.eval_cli:
        log("== phase 14 only: the eval entry point")
        ev = eval_cli_path(dev, card)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump(dict(card=card, eval_cli=ev), fh, indent=1, default=str)
        log(f"== done in {time.perf_counter() - t_start:.1f} s")
        return
    front_plans = log_front_plans(_build)
    stats_plans = log_stats_plans(_build, preset_cfgs)
    gdfn_plans = log_gdfn_plans(_build, preset_cfgs)
    mlp_bwd_plans = log_mlp_bwd_plans(_build, preset_cfgs)
    stats_bwd_plans = log_stats_bwd_plans(_build, preset_cfgs)
    window_bwd_plans = log_window_bwd_plans(_build, preset_cfgs)
    apply_bwd_plans = log_apply_bwd_plans(_build, preset_cfgs)
    gdfn_bwd_plans = log_gdfn_bwd_plans(_build, preset_cfgs)
    f32_tail_plans = log_f32_tail_plans(_build)
    f32_tile_plans = log_f32_tile_plans(_build, preset_cfgs)
    f32_tile_plans["stats"] = log_stats_f32_plans(_build, preset_cfgs)
    f32_tile_plans["apply"] = log_apply_f32_plans(_build, preset_cfgs)
    f32_tile_plans["gdfn"] = gdfn_plans

    specs = path_specs(cfg, SIZE, "torch.bfloat16")

    log("== phase 2: kernels against their plain versions (bf16, path shapes)")
    rows = kernel_checks(specs, dev)
    streamed = dict(eval=log_streamed("per flagship forward", rows, "per_forward"))
    log_alone_sums("per flagship forward", rows, "per_forward")
    f32_eval = log_f32_sums("per flagship forward", rows, "per_forward")
    log(card)
    log(f"== phase 2 (C = {WIDE_C} and odd widths): float32 calls past the tail tile's register "
        f"slice, the float32 stats, apply and GDFN tiles' odd widths")
    wide = wide_f32_checks(dev)
    if args.f32_eval:
        k6 = {}
        for c_, what in zip(preset_cfgs, ("flagship", "remote-sensing")):
            log(f"== phases 5 and 11 (float32 K6): the mlp calls of the {what} train step")
            k6_rows = k6_f32_checks(train_path_specs(c_, TRAIN_BATCH, TRAIN_SIZE,
                                                     "torch.bfloat16"), dev)
            k6[what] = log_f32_sums(f"per {what} train step (K6's float32 calls)", k6_rows,
                                    "per_step")
        log("== phase 7 (GDFN only): the remote-sensing forward's gdfn calls "
            f"({RS_SIZE}x{RS_SIZE} path shapes)")
        rs_specs = path_specs(remote_sensing_config(compute_dtype="bfloat16"), RS_SIZE,
                              "torch.bfloat16")
        rs_gdfn = kernel_checks(Counter({s_: n for s_, n in rs_specs.items() if s_[0] == "gdfn"}),
                                dev)
        f32_rs = log_f32_sums("per remote-sensing forward (the gdfn calls)", rs_gdfn,
                              "per_forward")
        log(card)
        log("== phase 14: the eval entry point (float32)")
        ev = eval_cli_path(dev, card)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump(dict(card=card, rows=rows, f32_eval=f32_eval, wide=wide, k6_f32=k6,
                               rs_gdfn=rs_gdfn, f32_rs=f32_rs,
                               f32_tail_plans=f32_tail_plans, f32_tile_plans=f32_tile_plans,
                               eval_cli=ev), fh, indent=1, default=str)
        log(f"== done in {time.perf_counter() - t_start:.1f} s")
        return

    log("== phase 3: main path, flagship bf16 forward on the trained weights")
    model = build_model(cfg, dev)
    load_params_npz(ART, model)
    clean, degraded = quality_cube(990, SIZE)
    main_res = main_path(dev, specs, model, clean, degraded, f"bf16 {SIZE}x{SIZE}x31", 3.0,
                         model.encoder_level1.blocks_1, MODEL_BF16_TOL)
    del model
    torch.cuda.empty_cache()

    log("== phase 4: mode-0 CLI")
    cli_res = run_cli()

    tspecs = train_path_specs(cfg, TRAIN_BATCH, TRAIN_SIZE, "torch.bfloat16")
    log("== phase 5: training kernels against their plain versions (bf16 and f32, step shapes)")
    train_rows = train_kernel_checks(tspecs, dev)
    log("== phase 5 (wgrad): every weight product of the flagship train step against wgrad_plain")
    train_rows += wgrad_checks(tspecs, dev, "flagship")

    log("== phase 6: training main path, flagship bf16 train steps from the trained weights")
    train_res = train_path(dev, tspecs)
    # where the step's time goes, by kernel: each call's isolated time from
    # phase 5 times its calls per step
    step = summarize(train_rows, train_res["launches"], {n: KERNELS.get(n) or TRAIN_KERNELS[n]
                     for n in sorted({r["spec"][0] for r in train_rows})}, "per_step")
    train_res["kernel_ms_per_step"] = step
    log_kernel_ms("per train step (phase 5 calls x calls per step)", step, "launches_per_step",
                  train_res["median_ms"])
    streamed["train"] = log_streamed("per train step (forward kernels)", train_rows, "per_step")
    log_alone_sums("per train step", train_rows, "per_step")
    f32_train = log_f32_sums("per train step (K6's float32 calls)", train_rows, "per_step")
    for name in BWD_SPLIT:
        train_res[f"{name}_stages_per_step"] = log_bwd_split(name, "per train step", train_rows,
                                                              "per_step")
    train_res["wgrad_stages_ms_per_step"] = log_wgrad_stages("per train step", {
        name: train_res[f"{name}_stages_per_step"] for name in BWD_SPLIT})
    torch.cuda.empty_cache()

    rs_cfg = remote_sensing_config(compute_dtype="bfloat16")
    rs_specs = path_specs(rs_cfg, RS_SIZE, "torch.bfloat16")
    log("== phase 7: remote-sensing kernels against their plain versions (bf16 and f32, "
        f"{RS_SIZE}x{RS_SIZE} path shapes)")
    rs_rows = kernel_checks(rs_specs, dev)
    log_alone_sums("per remote-sensing forward", rs_rows, "per_forward")
    f32_rs = log_f32_sums("per remote-sensing forward", rs_rows, "per_forward")
    limit = _build.smem_limit()
    worst = max(rs_rows, key=lambda r: r["smem"])
    log(f"  shared memory: the device's opt-in limit {limit} B per block; largest plan "
        f"{worst['smem']} B ({worst['spec'][0]} {worst['spec'][1:-1]})")
    if worst["smem"] > limit:
        fail("a shared-memory plan exceeds the device's opt-in limit")
    log(f"== phase 8: remote-sensing main path, bf16 {RS_SIZE}x{RS_SIZE}x100 forward on "
        f"seeded random weights")
    torch.manual_seed(RS_SEED)
    rs_model = build_model(rs_cfg, dev)
    clean, degraded = quality_cube(990, RS_SIZE, 100)
    rs_res = main_path(dev, rs_specs, rs_model, clean, degraded, f"bf16 {RS_SIZE}x{RS_SIZE}x100",
                       None, rs_model.latent.blocks_1, MODEL_BF16_TOL)
    del rs_model
    torch.cuda.empty_cache()
    rs_res["kernel_ms_per_forward"] = summarize(rs_rows, rs_res["launches"], KERNELS, "per_forward")
    log_kernel_ms("per remote-sensing forward (phase 7 calls x calls per forward)",
                  rs_res["kernel_ms_per_forward"], "launches_per_forward", rs_res["median_ms"])

    log("== phase 9: mode-0 CLI, --data_type remote_sensing (random weights)")
    rs_cli = run_cli("remote_sensing", RS_SIZE, 100, "", None)

    log("== phase 10: window MSA kernel (K14) through SpatialAttention")
    k14_rows, k14_launches = k14_path(dev)
    log_alone_sums(f"over phase 10's {len(k14_rows)} calls", k14_rows, "per_run")

    rs_tspecs = train_path_specs(rs_cfg, TRAIN_BATCH, TRAIN_SIZE, "torch.bfloat16")
    log(f"== phase 11: remote-sensing training kernels against their plain versions (bf16 and "
        f"f32, batch {TRAIN_BATCH} x {TRAIN_SIZE}^2 step shapes)")
    # phase 11 times with fewer repetitions than phase 5 (5 kernel calls, 1
    # plain), to keep the script within its limit; its checks are phase 5's
    rs_train_rows = train_kernel_checks(rs_tspecs, dev, streamed=False, iters=5, plain_iters=1)
    log_alone_sums("per remote-sensing train step", rs_train_rows, "per_step")
    f32_rs_train = log_f32_sums("per remote-sensing train step (K6's float32 calls)",
                                rs_train_rows, "per_step")
    log("== phase 11 (wgrad): every weight product of the remote-sensing train step against "
        "wgrad_plain")
    rs_train_rows += wgrad_checks(rs_tspecs, dev, "remote sensing")
    worst = max(rs_train_rows, key=lambda r: r["smem"])
    log(f"  shared memory: the device's opt-in limit {limit} B per block; largest plan "
        f"{worst['smem']} B ({worst['spec'][0]} {worst['spec'][1:-1]})")
    if worst["smem"] > limit:
        fail("a shared-memory plan exceeds the device's opt-in limit")

    log(f"== phase 12: remote-sensing train step, bf16 batch {TRAIN_BATCH} x 100 x "
        f"{TRAIN_SIZE}^2 on seeded random weights")
    log(card)
    rs_train = rs_train_path(dev, rs_tspecs)
    rs_step = summarize(rs_train_rows, rs_train["launches"], {n: KERNELS.get(n) or TRAIN_KERNELS[n]
                        for n in sorted({r["spec"][0] for r in rs_train_rows})}, "per_step")
    rs_train["kernel_ms_per_step"] = rs_step
    log_kernel_ms("per remote-sensing train step (phase 11 calls x calls per step)", rs_step,
                  "launches_per_step", rs_train["median_ms"])
    for name in BWD_SPLIT:
        rs_train[f"{name}_stages_per_step"] = log_bwd_split(
            name, "per remote-sensing train step", rs_train_rows, "per_step")
    rs_train["wgrad_stages_ms_per_step"] = log_wgrad_stages("per remote-sensing train step", {
        name: rs_train[f"{name}_stages_per_step"] for name in BWD_SPLIT})

    log(f"== phase 13: the training entry point: degradations on the card, the pipeline "
        f"without a sync, the remote-sensing train CLI (bf16, batch {TRAIN_BATCH} x 100 x "
        f"{TRAIN_SIZE}^2)")
    log(card)
    cli = train_cli_path(dev, rs_tspecs, rs_train["median_ms"])

    log("== phase 14: the eval entry point: modes 0-12 (float32, trained weights), band-missing "
        "scoring, the pipelined loop, the classifier router, the remote-sensing preset")
    log(card)
    ev = eval_cli_path(dev, card)

    log("== phase 15: the row-sharded eval forward: the float32 spectral tiles with halo rows, "
        f"the CLI with --mesh_spatial {MESH_RANKS} on ranks sharing this card")
    log(card)
    mesh = dict(halo=halo_tile_checks(dev, card))
    log("  (a) in bf16:")
    mesh["halo_bf16"] = halo_tile_checks(dev, card, torch.bfloat16)
    mesh["cli"] = mesh_cli_checks(dev, card)
    mesh_train = mesh_train_phase(dev, card)
    tp = tp_phase(dev, card)

    summary = summarize(rows, main_res["launches"], KERNELS, "per_forward")
    summary += summarize([r for r in train_rows if r["spec"][0] in TRAIN_KERNELS],
                         train_res["launches"], TRAIN_KERNELS, "per_step")
    summary += summarize(k14_rows, {"window_msa": k14_launches}, K14_KERNEL, "per_run")
    # this slice's path beside each kernel's main-path numbers
    by_name = {k["name"]: k for k in rs_step}
    for k in summary:
        if k["name"] in by_name:
            k["remote_sensing_train"] = {key: by_name[k["name"]][key] for key in (
                "launches", "launches_per_step", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "kernel_alone_ms", "kernel_tflops") if key in by_name[k["name"]]}
            # this slice's path: the train CLI's first run
            n = cli["runs"][0]["launches"].get(k["name"], 0)
            k["train_cli"] = dict(launches=n, launches_per_step=n // (CLI_EPOCHS * CLI_STEPS))
        if k["name"] in KERNELS:
            # phase 14: the eval CLI's 13 synchronous mode runs, float32
            n = ev["launches"].get(k["name"], 0)
            k["eval_cli"] = dict(launches=n, launches_per_forward=n // (len(EVAL_MODES)
                                                                        * EVAL_FORWARDS))
    # the float32 tail tile: its own path is the float32 eval CLI (phase 14's
    # launches); ms, plain and bound per flagship float32 forward from phase
    # 2's split (the apply calls with the tail less the same calls without)
    split = f32_eval["spectral_apply_split"]
    n = ev["launches"].get("mlp_tail_f32", 0)
    if n == 0:
        fail("the float32 tail tile was not launched by the eval CLI")
    k6 = [r for r in train_rows + rs_train_rows + wide if r["spec"][0] == "mlp" and "f32_ms" in r]
    meta = TAIL_F32_KERNEL["mlp_tail_f32"]
    summary.append(dict(
        name="mlp_tail_f32", route="cuda", source=meta["source"], replaces=meta["replaces"],
        tpu=meta["tpu"], launches=n, launches_per_forward=split["calls"],
        max_abs_err=max([split["max_abs_err"]] + [r["max_abs_err_f32"] for r in k6]),
        rel_err=max([split["rel_err"]] + [r["rel_err_f32"] for r in k6]), ms=split["ms"],
        plain_ms=split["plain_ms"], bound_ms=split["bound_ms"], bound_by="operations",
        library_ms=None, kernel_alone_ms=split["kernel_alone_ms"],
        k6_train_f32=f32_train.get("mlp"), k6_rs_train_f32=f32_rs_train.get("mlp"),
        eval_cli=dict(launches=n, launches_per_forward=n // (len(EVAL_MODES) * EVAL_FORWARDS))))
    # the float32 conv3, window, stats and apply tiles: their own path is
    # the float32 eval CLI (phase 14's launches, one per call of their
    # kernel); ms (wrapper and alone), plain, bound and library per flagship
    # float32 forward from phase 2's float32 sums (the apply tile's: its
    # fronts, spectral_apply_front)
    for name, meta in F32_TILE_KERNELS.items():
        sums = meta.get("sums", meta["of"])
        n, f = ev["launches"].get(name, 0), f32_eval[sums]
        if n == 0 or n != ev["launches"].get(meta["of"]):
            fail(f"the float32 tile {name} was launched {n} times by the eval CLI, its kernel "
                 f"{meta['of']} {ev['launches'].get(meta['of'])}")
        summary.append(dict(
            name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
            tpu=meta["tpu"], launches=n, launches_per_forward=f["calls"],
            max_abs_err=f["max_abs_err"], rel_err=f["rel_err"], ms=f["ms"],
            plain_ms=f["plain_ms"], bound_ms=f["bound_ms"], bound_by="operations",
            library_ms=f.get("library_ms"), kernel_alone_ms=f.get("kernel_alone_ms"),
            remote_sensing_f32=f32_rs.get(sums),
            eval_cli=dict(launches=n, launches_per_forward=n // (len(EVAL_MODES) * EVAL_FORWARDS))))
    # the halo tiles: their path is the sharded CLI (phase 15's launches over
    # the ranks of the flagship run); ms, plain and bound per sharded forward
    # (one shard of 2: each halo call of the forward timed alone), the
    # largest error of a shard against its plain version
    ranks = mesh["cli"]["natural_scene"]["sharded"]["ranks"]
    for name, of, source, replaces, tpu in (
            ("spectral_stats_f32_halo", "spectral_stats",
             "mp_hsir_tpu_torch/csrc/spectral_stats_f32.cuh",
             "mp_hsir_tpu/ops/pallas_attention.py:2053", ["K7a"]),
            ("spectral_apply_f32_halo", "spectral_apply", "mp_hsir_tpu_torch/csrc/spectral.cu",
             "mp_hsir_tpu/ops/pallas_attention.py:2114", ["K7b"])):
        p = mesh["halo"]["per_forward"][of]
        n = sum(rk["launches"].get(of + "_halo", 0) for rk in ranks)
        if n == 0:
            fail(f"the halo tile {name} was not launched by the sharded CLI")
        summary.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, tpu=tpu, launches=n,
            launches_per_forward=p["calls"], max_abs_err=p["max_abs_err"], rel_err=p["rel_err"],
            ms=p["halo_ms"], plain_ms=p["plain_ms"], bound_ms=p["bound_ms"],
            bound_by=p["bound_by"], library_ms=None, unsharded_ms=p["whole_ms"],
            mesh_cli=dict(ranks=len(ranks), launches=n,
                          launches_per_forward=n // sum(rk["forwards"] for rk in ranks))))
    # the halo backwards: their path is phase 16's 1 x 2 step; the four bf16
    # halo instances': phase 16 (e)'s bf16 1 x 2 step
    summary += mesh_train["kernels"]
    summary += bf16_halo_kernels(mesh_train, mesh["halo_bf16"]["per_forward"])
    # the four float32 head-block instances: phase 17's eval and train steps
    summary += tp["kernels"]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(dict(card=card, build=_build.BUILD_INFO.get("seconds"), rows=rows,
                           main=main_res, cli=cli_res, train_rows=train_rows, train=train_res,
                           rs_rows=rs_rows, rs_main=rs_res, rs_cli=rs_cli, k14_rows=k14_rows,
                           rs_train_rows=rs_train_rows, rs_train=rs_train,
                           smem_limit=limit, streamed=streamed, kernels=summary,
                           front_plans=front_plans, stats_plans=stats_plans,
                           gdfn_plans=gdfn_plans, mlp_bwd_plans=mlp_bwd_plans,
                           stats_bwd_plans=stats_bwd_plans,
                           window_bwd_plans=window_bwd_plans, apply_bwd_plans=apply_bwd_plans,
                           gdfn_bwd_plans=gdfn_bwd_plans, wgrad_ptxas=wgrad_ptxas,
                           f32_tail_plans=f32_tail_plans, f32_tile_plans=f32_tile_plans,
                           f32_eval=f32_eval, f32_rs=f32_rs,
                           f32_train=f32_train, f32_rs_train=f32_rs_train, wide=wide,
                           train_cli=cli, eval_cli=ev, mesh=mesh, mesh_train=mesh_train,
                           mesh_tp=tp,
                           seconds=time.perf_counter() - t_start), fh, indent=1, default=str)
    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
