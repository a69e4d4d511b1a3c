#!/usr/bin/env python3
"""Drive the PyTorch port of MP-HSIR on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--out results.json]

Phases (any failure exits non-zero; no phase's error is caught):

1. Environment: the card's name and power limit (nvidia-smi), then the build
   of mp_hsir_tpu_torch/csrc/*.cu with nvcc (one process per source), each
   kernel's registers and spills, the bf16 spectral apply tile's plan bytes
   at every preset width, and the bf16 spectral stats tile's at every (C,
   heads) of the presets beside the float32 kernel's.
2. Kernel checks: every kernel wrapper on the card at each shape the
   flagship 512x512x31 eval forward gives it, in bf16 from numpy-seeded
   inputs, against its plain PyTorch version on the same inputs; also once
   per shape in float32. Tolerances: bf16 max|kernel - plain| <= 3e-2 *
   max|plain| (a few bf16 ulps at the output's scale: both sides round at
   the same points, float32 sums in other orders can flip a rounding);
   float32 <= 1e-4 * max|plain|. Times each with CUDA events, beside the
   plain version, F.conv2d for the conv (library_ms) and the bound
   max(bytes / 3.35 TB/s, flops / 989 TFLOP/s); each conv3, window_attention,
   spectral_stats, spectral_apply and mlp call (here and in phases 5, 7 and
   11) is also timed as its kernel alone (the weights packed once, the C
   entry launched directly) and prints its achieved TFLOP/s, the kernel
   alone's and its library call's (flops / ms); their sums over the path's
   calls follow the table. Each spectral_apply call with the PGSSTB tail is
   timed once more on the same inputs without it (through the wrapper and
   alone, with the front's own bound and TFLOP/s): the sums split the apply
   time into the front and the tail; the calls without the tail
   (PromptFusion, the training route's drop-path call) are fronts alone.
   The float32 spectral stats kernel and the GDFN kernel keep their input
   resident where that fits; each such call at C > 64 is checked and timed
   once more, resident and with its input streamed in 64-channel chunks
   (the remote-sensing latent's plan), summed per forward: GDFN in bf16,
   spectral_stats on its float32 instance. The window kernel and the
   spectral stats and apply tiles stage their whole input in bf16 and have
   no chunk to stream.
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
   resident forward calls streamed as in phase 2.
6. Training main path: the flagship preset in training mode (batch 32 of
   64x64 patches cut from the quality cube, Gaussian noise, task 0) from the
   committed weights. The float32 step's parameter gradients on the kernel
   path against the plain float32 step on the card, both backpropagating the
   plain step's L1 cotangent (per tensor, |g_kernel - g_plain| / |g_plain| <=
   1e-3, beside the plain step's own change for a 1e-6 input change); then
   20 bf16 AdamW steps with the counters zeroed before and read after: every
   kernel launches its expected count per step, the recorded call signatures
   equal the enumerated ones, no plain version runs; the loss of the last
   step is below the first; ms per step (median after 3 warm-up steps) and
   peak memory.
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
    bound; the largest plan against the device's opt-in limit.
12. Remote-sensing train step: the preset in training mode at full width on
    seeded random weights (text-query LN biases drawn), float32 parameter
    gradients against the plain step as in phase 6 at batch 8, then 11 bf16
    AdamW steps at batch 32 x 100 x 64^2 (task ids over the 7 tasks) with
    phase 6's launch checks: the median loss of the last 3 steps below the
    first; ms per step (median of 8 after 3 warm-up) and peak memory, and
    kernel ms per step from phase 11.
13. The kernel summary line (each kernel's main-path numbers, and its
    remote-sensing train-step numbers beside them), then the result line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
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
# spectral stats and apply tiles their whole input)
STAGED = ("spectral_stats", "spectral_apply", "gdfn")
# the kernels timed alone beside their wrappers, with their library yardsticks
ALONE = {"conv3": "F.conv2d", "window_attention": None,
         "window_msa": "F.multi_head_attention_forward", "mlp": None, "spectral_stats": None,
         "spectral_apply": None}
# the training route's new kernels (timed at the train step's shapes)
TRAIN_KERNELS = {
    "mlp": dict(source="mp_hsir_tpu_torch/csrc/mlp.cu", tpu=["K6"],
                replaces="mp_hsir_tpu/ops/pallas_attention.py:1024"),
    "mlp_bwd": dict(source="mp_hsir_tpu_torch/csrc/mlp.cu", tpu=["K9"],
                    replaces="mp_hsir_tpu/ops/pallas_vjp.py:260"),
    "window_attention_bwd": dict(source="mp_hsir_tpu_torch/csrc/window_attention.cu", tpu=["K8"],
                                 replaces="mp_hsir_tpu/ops/pallas_vjp.py:853"),
    "spectral_stats_bwd": dict(source="mp_hsir_tpu_torch/csrc/spectral.cu", tpu=["K10a", "K12"],
                               replaces="mp_hsir_tpu/ops/pallas_vjp.py:1671"),
    "spectral_apply_bwd": dict(source="mp_hsir_tpu_torch/csrc/spectral.cu", tpu=["K10b", "K12"],
                               replaces="mp_hsir_tpu/ops/pallas_vjp.py:1758"),
    "gdfn_bwd": dict(source="mp_hsir_tpu_torch/csrc/gdfn.cu", tpu=["K11"],
                     replaces="mp_hsir_tpu/ops/pallas_vjp.py:471"),
}


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
    if name == "spectral_stats" and _code(spec):  # the bf16 tile: one resident plan
        n = _build.plan_bytes("mp_spectral_stats_tc_smem", *shape)
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
    if spec[0] not in STAGED or spec[0] == "spectral_apply" and _code(spec):
        return None  # (the bf16 apply tile has one resident plan)
    f32spec = spec[:-1] + ("torch.float32",)
    plan = plan_of(f32spec)  # the chunked layout (gdfn's is the same in bf16)
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
    weight packed, the window, mlp and spectral kernels' weights packed and
    their outputs allocated) and the C entry launched directly, without what
    the wrapper adds on the host per call (the packing copies, allocations,
    Python)."""
    from mp_hsir_tpu_torch.ops.kernels import (
        _build, conv3, mlp, spectral, window_attention, window_msa,
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
    else:
        launch, _, held = window_msa._prepare(*args, kw.get("labels"))
        entry, what = window_msa._entry(), "mp_window_msa"
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
        f_fn, f_args, f_kw, *_ = make_call(spec[:-1] + ("torch.float32",), dev, torch.float32)
        err32, rel32 = compare(f_fn, f_args, f_kw, F32_TOL)
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
                   **front_split(spec, fn, args, kw))
        rows.append(row)
        log(f"  {spec[0]:16s} {str(spec[1:-1]):58s} x{mult:<2d} err {err:.2e} (rel {rel:.1e}, "
            f"f32 rel {rel32:.1e})  {ms:8.3f} ms  plain {plain_ms:8.3f}  "
            f"lib {'-' if lib_ms is None else f'{lib_ms:.3f}'}  bound {bound_ms:.4f} ({row['bound_by']})  "
            + log_plan(plan)
            + log_streamed_call(streamed) + log_tflops(row))
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
    return specs


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
        f32spec = spec[:-1] + ("torch.float32",)
        library = None
        if name.endswith("_bwd"):
            kern, plain, byts, flops = make_bwd_call(spec, dev, torch.bfloat16)
            err, rel = compare_pair(kern, plain, BF16_TOL)
            k32, p32, *_ = make_bwd_call(f32spec, dev, torch.float32)
            err32, rel32 = compare_pair(k32, p32, F32_TOL)
            del k32, p32
        else:
            fn, args, kw, library, byts, flops = make_train_fwd_call(spec, dev, torch.bfloat16)
            err, rel = compare(fn, args, kw, BF16_TOL)
            f_fn, f_args, f_kw, *_ = make_train_fwd_call(f32spec, dev, torch.float32)
            err32, rel32 = compare(f_fn, f_args, f_kw, F32_TOL)
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
                         **({} if name.endswith("_bwd") else tflops(spec, args, kw, flops, ms, lib_ms))))
        log(f"  {name:20s} {str(spec[1:-1]):50s} x{mult:<2d} err {err:.2e} (rel {rel:.1e}, "
            f"f32 rel {rel32:.1e})  {ms:8.3f} ms  plain {plain_ms:8.3f}  "
            f"lib {'-' if lib_ms is None else f'{lib_ms:.3f}'}  bound {bound_ms:.4f}  "
            + log_plan(plan)
            + log_streamed_call(st) + log_tflops(rows[-1]))
        torch.cuda.empty_cache()
    return rows


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
    runs; ms per step (median after TRAIN_WARMUP steps) and peak memory."""
    from mp_hsir_tpu_torch.config import TrainConfig
    from mp_hsir_tpu_torch.ops.kernels import _route
    from mp_hsir_tpu_torch.training.trainer import create_train_state, train_step

    state = create_train_state(model.cfg, TrainConfig(warmup_frac=0.0), device=dev, model=model)
    gen = torch.Generator(device=dev).manual_seed(2024)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _route.reset_counters()
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = train_step(state, batch, gen)
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
        f"(min {min(steady):.2f}, max {max(steady):.2f}); peak memory {peak_gib:.2f} GiB")
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
                peak_gib=peak_gib, launches=counts, launches_per_step=per_step)


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
    log(f"    sum {sum(k['ms'] for k in summary):.2f} of the median's {total_ms:.2f} ms")


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


def log_stats_plans(_build, cfgs) -> dict:
    """The bf16 spectral stats tile's shared-memory plan (bytes, static
    included) at every (C, heads) of the presets' stats calls, beside the
    float32 kernel's at its own chunk."""
    shapes = set()
    for cfg in cfgs:
        for specs in (path_specs(cfg, SIZE, "bf16"), train_path_specs(cfg, 1, 64, "bf16")):
            shapes |= {(s[4] + s[5], s[6]) for s in specs if s[0] == "spectral_stats"}
    plans = {}
    for c, nh in sorted(shapes):
        kc = _build.chunk("mp_spectral_stats_chunk", c, nh)
        plans[f"C={c}/{nh}"] = dict(bf16=_build.plan_bytes("mp_spectral_stats_tc_smem", c, nh),
                                    f32=_build.plan_bytes("mp_spectral_stats_smem", c, nh, kc),
                                    f32_kc=kc)
    log("  bf16 spectral stats plans (B; float32's at its chunk in brackets): " + ", ".join(
        f"{k} {v['bf16']} ({v['f32']} kc {v['f32_kc']})" for k, v in plans.items()))
    return plans


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="", help="write the detailed results here (JSON)")
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

    front_plans = log_front_plans(_build)
    cfg = natural_scene_config(compute_dtype="bfloat16")
    stats_plans = log_stats_plans(_build, (cfg, remote_sensing_config(compute_dtype="bfloat16")))

    specs = path_specs(cfg, SIZE, "torch.bfloat16")

    log("== phase 2: kernels against their plain versions (bf16, path shapes)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    rows = kernel_checks(specs, dev)
    streamed = dict(eval=log_streamed("per flagship forward", rows, "per_forward"))
    log_alone_sums("per flagship forward", rows, "per_forward")

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
    torch.cuda.empty_cache()

    rs_cfg = remote_sensing_config(compute_dtype="bfloat16")
    rs_specs = path_specs(rs_cfg, RS_SIZE, "torch.bfloat16")
    log("== phase 7: remote-sensing kernels against their plain versions (bf16 and f32, "
        f"{RS_SIZE}x{RS_SIZE} path shapes)")
    rs_rows = kernel_checks(rs_specs, dev)
    log_alone_sums("per remote-sensing forward", rs_rows, "per_forward")
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
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(dict(card=card, build=_build.BUILD_INFO.get("seconds"), rows=rows,
                           main=main_res, cli=cli_res, train_rows=train_rows, train=train_res,
                           rs_rows=rs_rows, rs_main=rs_res, rs_cli=rs_cli, k14_rows=k14_rows,
                           rs_train_rows=rs_train_rows, rs_train=rs_train,
                           smem_limit=limit, streamed=streamed, kernels=summary,
                           front_plans=front_plans, stats_plans=stats_plans,
                           seconds=time.perf_counter() - t_start), fh, indent=1)
    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
