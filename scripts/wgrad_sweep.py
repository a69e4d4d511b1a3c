#!/usr/bin/env python3
"""Time the port's bf16 weight product (``mp_wgrad``) at every wgrad
signature of both presets' train steps on one NVIDIA GPU, for several part
counts, beside its in-order part sum alone.

    python3 scripts/wgrad_sweep.py [--out sweep.json]

For each (nb, P, M, N) (batch 32 of 64x64 patches, as chip_smoke.py
enumerates them) and each part count n in {plan / 4, plan / 2, plan, 2 plan}
(``_grad.wgrad_plan``'s, within 1 .. P / 256): the C entry launched directly
20 times behind a sleep kernel that holds the card until the host has queued
them all (CUDA events around the 20; device time per call, no host gap), and
``mp_sum_parts`` alone on an (nb, n, M, N) partial. Prints per signature and
the sums per step (each signature's time times its calls per step) for the
plan and for the best n of each signature. Run from the repository root.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from collections import Counter

import torch

sys.path.insert(0, os.getcwd())

REPS = 20


def device_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(20_000_000)
    e0.record()
    for _ in range(REPS):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / REPS


def signatures(cfg) -> Counter:
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    specs = cs.train_path_specs(cfg, cs.TRAIN_BATCH, cs.TRAIN_SIZE, "torch.bfloat16")
    return Counter({s[1:5]: k for s, k in specs.items() if s[0] == "wgrad"})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("wgrad_sweep: needs an NVIDIA GPU")
    from mp_hsir_tpu_torch.config import natural_scene_config, remote_sensing_config
    from mp_hsir_tpu_torch.ops.kernels import _build, _grad
    from mp_hsir_tpu_torch.ops.kernels._route import stream_ptr

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    wg, sp = _grad._entry("mp_wgrad"), _grad._entry("mp_sum_parts")
    res = {}
    for cfg, what in ((natural_scene_config(), "flagship"), (remote_sensing_config(), "remote sensing")):
        rows = []
        for (nb, p, m, n), calls in sorted(signatures(cfg).items()):
            gen = torch.Generator(device=dev).manual_seed(nb * p + m * n)
            a = torch.randn((nb, p, m), generator=gen, device=dev).bfloat16()
            b = torch.randn((nb, p, n), generator=gen, device=dev).bfloat16()
            out = torch.empty((nb, m, n), dtype=torch.float32, device=dev)
            plan, _ = _grad.wgrad_plan(nb, p, m, n)
            cands = sorted({max(1, min(k, max(1, p // 256))) for k in (plan // 4, plan // 2, plan,
                                                                         2 * plan)})
            times = {}
            for k in cands:
                part = torch.empty((nb, k, m, n), dtype=torch.float32, device=dev)
                launch = [a.data_ptr(), b.data_ptr(), part.data_ptr(), out.data_ptr(), 1, nb, p,
                          m, n, k, stream_ptr()]
                _build.check("mp_wgrad", wg(*launch))
                times[k] = device_ms(lambda: wg(*launch))
                if k == plan and k > 1:
                    sums = [part.data_ptr(), out.data_ptr(), nb, k, m * n, stream_ptr()]
                    sum_ms = device_ms(lambda: sp(*sums))
                del part
            best = min(times, key=times.get)
            row = dict(sig=[nb, p, m, n], calls=calls, plan=plan, ms=times[plan],
                       sum_ms=sum_ms if plan > 1 else 0.0, best=best, best_ms=times[best],
                       times={str(k): v for k, v in times.items()},
                       tflops=2 * nb * p * m * n / times[plan] / 1e9)
            rows.append(row)
            print(f"  {what:14s} {str((nb, p, m, n)):26s} x{calls:<2d} plan {plan:3d}: "
                  f"{row['ms'] * 1e3:7.1f} us ({row['tflops']:5.1f} TFLOP/s; its sum "
                  f"{row['sum_ms'] * 1e3:6.1f}); "
                  + ", ".join(f"{k}: {v * 1e3:.1f}" for k, v in times.items()), flush=True)
            del a, b, out
            torch.cuda.empty_cache()
        tot = lambda key: sum(r[key] * r["calls"] for r in rows)  # noqa: E731
        res[what] = dict(rows=rows, plan_ms=tot("ms"), sum_ms=tot("sum_ms"), best_ms=tot("best_ms"))
        print(f"  per {what} step: plan {tot('ms'):.3f} ms (of it the part sums "
              f"{tot('sum_ms'):.3f}); best n per signature {tot('best_ms'):.3f}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(dict(card=smi.stdout.strip(), **res), fh, indent=1)


if __name__ == "__main__":
    main()
