#!/usr/bin/env python3
"""Drive the PyTorch port of MP-HSIR on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--out results.json] [--bwd-split KERNEL] [--mlp-bwd-split] [--wgrad]
                          [--train-cli] [--eval-cli] [--f32-eval]

Phases (any failure exits non-zero; no phase's error is caught):

1. Environment: the card's name and power limit (nvidia-smi), then the build
   of mp_hsir_tpu_torch/csrc/*.cu with nvcc (one process per source), each
   kernel's registers and spills, the bf16 spectral apply tile's plan bytes
   at every preset width, and the bf16 spectral stats tile's at every (C,
   heads) of the presets beside the float32 kernel's, and the bf16 GDFN
   tile's at every width of the presets' GDFN calls beside the float32
   kernel's at its chunk, and the bf16 MLP backward tile's at every width of
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
   float32 tail tile's kernels' registers and spills (mlp_f32_kernel, the
   two float32 spectral_apply_kernel instances), and the float32 apply
   (with the tail, at its chunk) and mlp plans at every tail width and C =
   400, beside the plans of the SIMT tail the tile replaced; the float32
   conv3 and window tiles' registers and spills (every instance) beside the
   bf16 tiles', the float32 window plan at every (C, heads) of the presets'
   window calls (with its ring stages and blocks per window) beside the bf16
   tile's and the SIMT kernel's it replaced, and conv3's float32 plan beside
   its bf16 and SIMT ones; the float32 stats tile's registers and spills
   beside the bf16 tile's, and its plan at every (C, heads) of the presets'
   stats calls and at 36/2, 27/3 and 400/8 beside the SIMT kernel's it
   replaced, each checked against its mirror (stats_f32_plan).
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
   The float32 GDFN kernel keeps its input resident where that fits (an
   older checkout's float32 stats kernel too: there each spectral_stats
   call at C > 64 is checked and timed once more on its float32 instance,
   resident and with its input streamed in 64-channel chunks, summed per
   forward). The window kernel and the spectral stats, apply and GDFN tiles
   stage their whole input in bf16 and have no chunk to stream; the float32
   stats tile streams its input in 32-channel chunks at every width. Each call's
   float32 instance is timed too (wrapper, alone, plain, F.conv2d with TF32
   off for conv3) beside its float32 bound max(bytes / 3.35 TB/s, 3 flops /
   495 TFLOP/s: 3xTF32), each float32 apply call with the tail once more
   without it; per forward the float32 sums per kernel and the apply's front
   / tail split (the tail: the float32 tail tile, 3xTF32) beside their
   bounds; each float32 call of the tail, conv3, window and stats tiles is
   first run twice: bitwise equal. Then a float32 spectral apply with the
   tail and a float32 mlp call at C = 400 (the tail tile in two output
   groups), and float32 stats calls at 400/8, 36/2, 27/3 and the
   PromptFusion entry at 18 + 18 (each one stats tile launch, no plain
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
    the tail, the float32 conv3, window and stats tiles once per conv3,
    window and stats call, each counted apart), no plain version on the card; per mode the first
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
15. The kernel summary line (each kernel's main-path numbers, its
    remote-sensing train-step numbers and the train and eval CLIs' launches
    beside them; the float32 tail tile's row: phase 14's launches, phase 2's
    tail ms per flagship float32 forward beside its bound and plain, the
    largest float32 error of its calls; the float32 conv3, window and stats
    tiles' rows: phase 14's launches (one per call of their kernel), phase
    2's float32 ms per flagship forward, alone, plain, bound and library,
    phase 7's remote-sensing float32 sums), then the result line.

--bwd-split KERNEL (mlp_bwd, spectral_stats_bwd, window_attention_bwd,
spectral_apply_bwd or gdfn_bwd; repeatable) runs phase 1's build and only
that kernel's stage split, at both presets' train-step shapes, and the sum
of the named kernels' mp_wgrad stages: the same measurement for another
checkout of the package (this file copied to its root and run there);
--mlp-bwd-split is --bwd-split mlp_bwd. --wgrad runs phase 1 and only the
wgrad phase, at both presets' train-step signatures. --train-cli runs phase
1 and only phase 13, --eval-cli phase 1 and only phase 14. --f32-eval runs
phases 1, 2, K6's float32 calls of phases 5 and 11 (checked and timed) and
14: the float32 path's kernels and the eval CLI, also for an
older checkout (this file copied to its root: where its package has no
float32 tail tile, the tile's launches are not expected and its C = 400 mlp
call is left out; where it has no float32 conv3 and window tiles, or no
float32 stats tile, their launches are not expected and only their SIMT
kernels' registers are logged).
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
# the float32 conv3, window and spectral stats tiles (3xTF32): K4's, K1's and
# K2 phase 0's float32 instances, the eval CLI's route; their launches count
# in their own counters beside conv3's, window_attention's and
# spectral_stats's
F32_TILE_KERNELS = {
    "conv3_f32": dict(source="mp_hsir_tpu_torch/csrc/conv3.cu", tpu=["K4"], of="conv3",
                      replaces="mp_hsir_tpu/ops/pallas_attention.py:1182"),
    "window_attention_f32": dict(source="mp_hsir_tpu_torch/csrc/window_attention.cu",
                                 tpu=["K1", "K3"], of="window_attention",
                                 replaces="mp_hsir_tpu/ops/pallas_attention.py:794"),
    "spectral_stats_f32": dict(source="mp_hsir_tpu_torch/csrc/spectral_stats_f32.cuh",
                               tpu=["K2", "K3", "K7a"], of="spectral_stats",
                               replaces="mp_hsir_tpu/ops/pallas_attention.py:1842"),
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


def log(msg: str) -> None:
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
        kw = dict(residual=residual, proj_w=g.u((co, c, 1, 1), c))
        p = b * h * w
        byts = p * (c + co) * e + (3 * c * hid + 18 * hid + c * co) * e
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
                           lambda s: s[4:5]),
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
        n = _build.plan_bytes("mp_spectral_stats_tc_smem", *shape)
        return dict(smem=n, smem_whole=n, kc=c, c=c)
    if name == "spectral_stats" and has_stats_f32_tile():  # the float32 tile: one plan
        n = _build.plan_bytes("mp_spectral_stats_smem", *shape)
        return dict(smem=n, smem_whole=n, kc=c, c=c)
    if name == "gdfn" and _code(spec):  # the bf16 tile: one resident plan
        n = _build.plan_bytes("mp_gdfn_tc_smem", c)
        return dict(smem=n, smem_whole=n, kc=c, c=c)
    if name == "mlp_bwd" and _code(spec):  # the bf16 tile: one resident plan
        n = _build.plan_bytes("mp_mlp_bwd_tc_smem", c)
        return dict(smem=n, smem_whole=n, kc=c, c=c)
    if name == "spectral_stats_bwd" and _code(spec):  # the bf16 tiles: the larger plan
        n = max(_build.plan_bytes("mp_spectral_stats_bwd_tc_smem", *shape),
                _build.plan_bytes("mp_dwconv_dx_tc_smem", c, 2 * c))
        return dict(smem=n, smem_whole=n, kc=c, c=c)
    if name == "spectral_apply_bwd" and _code(spec):  # the bf16 tiles: the larger plan
        n = max(_build.plan_bytes("mp_spectral_apply_bwd_tc_smem", c, tile) for tile in (1, 2))
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


def f32_tile_specs(specs: Counter) -> Counter:
    """The float32 conv3, window and stats tiles' launches of a multiset of
    calls: one per float32 conv3 call, as ("conv3_f32", B, H, W, Cin, Cout,
    mode), per float32 window_attention call, as ("window_attention_f32", B,
    H, W, C, heads, shift), and per float32 spectral_stats call, as
    ("spectral_stats_f32", B, H, W, C1, C2, heads, shift, ln); none for the
    tiles the package does not have."""
    out: Counter = Counter()
    kinds = (("conv3", "window_attention") if has_f32_tiles() else ()) + (
        ("spectral_stats",) if has_stats_f32_tile() else ())
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
            or spec[0] == "spectral_stats" and has_stats_f32_tile()):
        # the float32 tail, conv3, window and stats tiles sum in a fixed
        # order, with no float atomics
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


def log_f32_sums(what: str, rows, per: str) -> dict:
    """The float32 calls summed per kernel over the path (wrapper, alone,
    plain, bound, F.conv2d), the spectral_apply calls with the tail split
    into front and tail (each beside its bound), and the float32 tail tile's
    row for the kernels line."""
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


def train_kernel_checks(specs: Counter, dev, streamed: bool = True) -> list:
    """Every kernel of the training route (the new ones, the apply kernel's
    drop-path option and the eval kernels at the step's shapes; conv3's
    backward dx calls are conv3 calls) at every call signature of the train
    step, bf16 and float32, timed in bf16, with its shared-memory plan;
    ``streamed``: also time the resident forward calls streamed in
    64-channel chunks."""
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
        ms = time_ms(kern, 10)
        st = (None if name.endswith("_bwd") or not streamed
              else streamed_ms(spec, fn, args, kw))
        plan = plan_of(spec)

        def run_plain():
            with plain_reference():
                return plain()

        plain_ms = time_ms(run_plain, 3)
        lib_ms = time_ms(library, 10) if library is not None else None
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
    with the tail, tail_f32_specs; the float32 conv3 and window tiles once
    per conv3 and window call, f32_tile_specs), no plain version on the
    card. Its stdout is logged indented."""
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
# phase 10: the window MSA kernel (K14) through SpatialAttention
# ---------------------------------------------------------------------------

# (map side, C, heads): flagship level 1 and latent, remote-sensing latent
K14_SIGS = ((SIZE, 64, 2), (SIZE // 4, 256, 8), (RS_SIZE // 4, 384, 8))


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
    the tail, beside the float32 layout's at its own chunk."""
    plans = {}
    for c in (64, 96, 128, 192, 256, 384):
        for tail in (1, 0):
            f32 = _build.plan_bytes("mp_spectral_apply_smem", c, tail, 0,
                                    _build.chunk("mp_spectral_apply_chunk", c, tail, 0))
            plans[f"C={c}{'+tail' if tail else ''}"] = dict(
                bf16=_build.plan_bytes("mp_spectral_apply_smem", c, tail, 1, c), f32=f32)
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
            kc, f32 = c, _build.plan_bytes("mp_spectral_stats_smem", c, nh)
        else:
            kc = _build.chunk("mp_spectral_stats_chunk", c, nh)
            f32 = _build.plan_bytes("mp_spectral_stats_smem", c, nh, kc)
        plans[f"C={c}/{nh}"] = dict(bf16=_build.plan_bytes("mp_spectral_stats_tc_smem", c, nh),
                                    f32=f32, f32_kc=kc)
    log("  bf16 spectral stats plans (B; float32's at its chunk in brackets): " + ", ".join(
        f"{k} {v['bf16']} ({v['f32']} kc {v['f32_kc']})" for k, v in plans.items()))
    return plans


def log_gdfn_plans(_build, cfgs) -> dict:
    """The bf16 GDFN tile's shared-memory plan (bytes, static included) at
    every width of the presets' GDFN calls, beside the float32 kernel's at
    its own chunk."""
    widths = set()
    for cfg in cfgs:
        for specs in (path_specs(cfg, SIZE, "bf16"), train_path_specs(cfg, 1, 64, "bf16")):
            widths |= {s[4] for s in specs if s[0] == "gdfn"}
    plans = {}
    for c in sorted(widths):
        kc = _build.chunk("mp_gdfn_chunk", c)
        plans[f"C={c}"] = dict(bf16=_build.plan_bytes("mp_gdfn_tc_smem", c),
                               f32=_build.plan_bytes("mp_gdfn_smem", c, kc), f32_kc=kc)
    log("  bf16 gdfn plans (B; float32's at its chunk in brackets): " + ", ".join(
        f"{k} {v['bf16']} ({v['f32']} kc {v['f32_kc']})" for k, v in plans.items()))
    return plans


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
    two float32 apply instances that run it), and the float32 plans with the
    tail at every width of the presets' tail calls and at WIDE_C: the apply
    kernel's at its chunk and the mlp kernel's, beside the SIMT tail's."""
    regs = {k: ptxas_report(m) for k, m in (
        ("mlp_f32_kernel", "mlp_f32_kernel"), ("spectral_apply_kernel<float, resident>",
                                               "spectral_apply_kernelIfLb0E"),
        ("spectral_apply_kernel<float, streamed>", "spectral_apply_kernelIfLb1E"))}
    log("  float32 tail tile (ptxas): " + ", ".join(
        f"{k} {v.get('registers', '?')} regs, spills {v.get('spill_stores', '?')}/"
        f"{v.get('spill_loads', '?')} B" for k, v in regs.items()))
    limit, plans = _build.smem_limit(), {}
    for c in (64, 96, 128, 192, 256, 384, WIDE_C):
        kc = _build.chunk("mp_spectral_apply_chunk", c, 1, 0)
        old_apply, old_mlp = simt_f32_plans(c, limit)
        plans[c] = dict(apply=_build.plan_bytes("mp_spectral_apply_smem", c, 1, 0, kc), kc=kc,
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
        n = _build.plan_bytes("mp_spectral_stats_smem", c, heads)
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
    18 + 18 with LN): one spectral_stats_f32 launch each, no plain call."""
    from mp_hsir_tpu_torch.ops.kernels import _route

    hid = int(WIDE_C * 2.66)
    rows = []
    specs = [("spectral_apply", 1, 64, 64, WIDE_C, 0, 4, False, False, True, True, hid,
              "torch.float32"),
             ("mlp", 1, 64, 64, WIDE_C, hid, True, True, "torch.float32")]
    if has_stats_f32_tile():
        specs += [("spectral_stats", 1, 64, 64, WIDE_C, 0, 8, 4, False, "torch.float32"),
                  ("spectral_stats", 1, 64, 64, 36, 0, 2, 4, False, "torch.float32"),
                  ("spectral_stats", 1, 64, 64, 27, 0, 3, 0, False, "torch.float32"),
                  ("spectral_stats", 1, 64, 64, 18, 18, 2, 0, True, "torch.float32")]
    for spec in specs:
        if spec[0] == "mlp" and not has_tail_f32():
            log(f"  {spec[0]} {spec[1:-1]}: no float32 tail tile in this package (skipped)")
            continue
        fn, args, kw, _, byts, flops = make_train_fwd_call(spec, dev, torch.float32)
        err, rel = compare(fn, args, kw, F32_TOL)
        if spec[0] == "spectral_stats":
            _route.reset_counters()
            fn(*args, **kw)
            n, plain = _route.COUNTERS["spectral_stats_f32"].launches, _route.ROUTE.plain_cuda_calls
            if (n, plain) != (1, 0):
                fail(f"float32 stats {spec[1:-1]}: {n} tile launches, {plain} plain calls")
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
            tile1=_build.plan_bytes("mp_spectral_stats_bwd_tc_smem", c, nh),
            tile2=_build.plan_bytes("mp_dwconv_dx_tc_smem", c, 2 * c),
            f32=_build.plan_bytes("mp_spectral_stats_bwd_smem", c, nh))
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
        kc = _build.chunk("mp_spectral_apply_bwd_chunk", c)
        plans[f"C={c}"] = dict(
            tile1=_build.plan_bytes("mp_spectral_apply_bwd_tc_smem", c, 1),
            tile2=_build.plan_bytes("mp_spectral_apply_bwd_tc_smem", c, 2),
            f32=_build.plan_bytes("mp_spectral_apply_bwd_smem", c, kc), f32_kc=kc)
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
        f"cached={_build.BUILD_INFO.get('cached')})")
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

    specs = path_specs(cfg, SIZE, "torch.bfloat16")

    log("== phase 2: kernels against their plain versions (bf16, path shapes)")
    rows = kernel_checks(specs, dev)
    streamed = dict(eval=log_streamed("per flagship forward", rows, "per_forward"))
    log_alone_sums("per flagship forward", rows, "per_forward")
    f32_eval = log_f32_sums("per flagship forward", rows, "per_forward")
    log(card)
    log(f"== phase 2 (C = {WIDE_C}): float32 calls past the tail tile's register slice")
    wide = wide_f32_checks(dev)
    if args.f32_eval:
        k6 = {}
        for c_, what in zip(preset_cfgs, ("flagship", "remote-sensing")):
            log(f"== phases 5 and 11 (float32 K6): the mlp calls of the {what} train step")
            k6_rows = k6_f32_checks(train_path_specs(c_, TRAIN_BATCH, TRAIN_SIZE,
                                                     "torch.bfloat16"), dev)
            k6[what] = log_f32_sums(f"per {what} train step (K6's float32 calls)", k6_rows,
                                    "per_step")
        log(card)
        log("== phase 14: the eval entry point (float32)")
        ev = eval_cli_path(dev, card)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump(dict(card=card, rows=rows, f32_eval=f32_eval, wide=wide, k6_f32=k6,
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
    rs_train_rows = train_kernel_checks(rs_tspecs, dev, streamed=False)
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
    # the float32 conv3, window and stats tiles: their own path is the
    # float32 eval CLI (phase 14's launches, one per call of their kernel);
    # ms (wrapper and alone), plain, bound and library per flagship float32
    # forward from phase 2's float32 sums
    for name, meta in F32_TILE_KERNELS.items():
        n, f = ev["launches"].get(name, 0), f32_eval[meta["of"]]
        if n == 0 or n != ev["launches"].get(meta["of"]):
            fail(f"the float32 tile {name} was launched {n} times by the eval CLI, its kernel "
                 f"{meta['of']} {ev['launches'].get(meta['of'])}")
        summary.append(dict(
            name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
            tpu=meta["tpu"], launches=n, launches_per_forward=f["calls"],
            max_abs_err=f["max_abs_err"], rel_err=f["rel_err"], ms=f["ms"],
            plain_ms=f["plain_ms"], bound_ms=f["bound_ms"], bound_by="operations",
            library_ms=f.get("library_ms"), kernel_alone_ms=f.get("kernel_alone_ms"),
            remote_sensing_f32=f32_rs.get(meta["of"]),
            eval_cli=dict(launches=n, launches_per_forward=n // (len(EVAL_MODES) * EVAL_FORWARDS))))
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
                           train_cli=cli, eval_cli=ev,
                           seconds=time.perf_counter() - t_start), fh, indent=1, default=str)
    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
