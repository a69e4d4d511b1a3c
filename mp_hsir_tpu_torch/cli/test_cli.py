"""Evaluation CLI, mode 0 (Gaussian denoising at a fixed sigma), with the
stdout lines of ``mp_hsir_tpu/cli/test_cli.py``'s synchronous loop:

    Start gaussian denoise testing sigma=70
    Total Test HSIs Ids : N
    Denoise sigma=70: psnr: xx.xx, ssim: x.xxxx
    Denoise sigma=70: sam: x.xxx deg, net time: x.xxx s/cube

Run: ``python -m mp_hsir_tpu_torch.cli.test_cli --mode 0 --test_dir DIR
--ckpt_path assets/trained/natural_12k_f16.npz``; ``--data_type
remote_sensing`` selects the 100-band preset (as the JAX CLI's flag does). It
runs on the card unless ``--device cpu`` is given. The other modes,
``--pipeline`` and ``--auto_task`` are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from mp_hsir_tpu_torch import resolve_device
from mp_hsir_tpu_torch.checkpoint import load_params_npz
from mp_hsir_tpu_torch.config import (
    EvalConfig, ModelConfig, natural_scene_config, remote_sensing_config,
)
from mp_hsir_tpu_torch.data.eval_datasets import GaussianDenoiseDataset
from mp_hsir_tpu_torch.models.mp_hsir import build_model
from mp_hsir_tpu_torch.ops.metrics import AverageMeter, compute_psnr_ssim, compute_sam
from mp_hsir_tpu_torch.utils.image import save_false_color

MODE_TASK_ID = {0: 0}
PRESETS = {"natural_scene": natural_scene_config, "remote_sensing": remote_sensing_config}


def load_model(ckpt_path: str, model_cfg: ModelConfig, device="cuda"):
    """Eval model on ``device``; weights from a flat-npz params artifact, or
    random ones when ``ckpt_path`` is empty."""
    model = build_model(model_cfg, device)
    if ckpt_path:
        load_params_npz(ckpt_path, model)
    return model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def run_mode(cfg: EvalConfig, model_cfg: ModelConfig, model=None, device="cuda") -> dict:
    """The synchronous eval loop: one cube at a time, forward timed to its
    completion on the device, metrics on the device."""
    if cfg.mode not in MODE_TASK_ID:
        raise SystemExit(f"mode {cfg.mode} is not ported yet (only mode 0)")
    task_id = MODE_TASK_ID[cfg.mode]
    if task_id >= model_cfg.task_classes:
        raise SystemExit(f"task id {task_id} out of range for {model_cfg.task_classes} classes")
    device = resolve_device(device)
    if model is None:
        model = load_model(cfg.ckpt_path, model_cfg, device)
    tid = torch.tensor([task_id], device=device)
    dataset = GaussianDenoiseDataset(cfg.test_dir, cfg.gaussian_noise_sigma, cfg.seed)
    out_dir = os.path.join(cfg.output_path, "gaussian_denoise")
    psnr, ssim, sam = AverageMeter(), AverageMeter(), AverageMeter()
    wall = 0.0
    warmed = set()
    for item in dataset:
        degraded = torch.from_numpy(item["degraded"][None]).to(device)
        clean = torch.from_numpy(item["clean"][None]).to(device)
        if degraded.shape not in warmed:
            # first call per shape pays one-time set-up (kernel build and
            # load); excluded from net time as the JAX CLI excludes compile
            model(degraded, tid)
            _sync(device)
            warmed.add(degraded.shape)
        t0 = time.perf_counter()
        restored = model(degraded, tid)
        _sync(device)
        wall += time.perf_counter() - t0
        p, s, n = compute_psnr_ssim(restored, clean.clamp(0, 1))
        psnr.update(p, n)
        ssim.update(s, n)
        sam.update(compute_sam(restored, clean), n)
        if cfg.save_images:
            rest = restored.float().cpu().numpy()
            save_false_color(item["clean"], cfg.select_bands, os.path.join(out_dir, f"origin_{item['name']}.png"))
            save_false_color(item["degraded"], cfg.select_bands, os.path.join(out_dir, f"degraded_{item['name']}.png"))
            save_false_color(np.clip(rest, 0, 1), cfg.select_bands, os.path.join(out_dir, f"restored_{item['name']}.png"))
    label = f"Denoise sigma={cfg.gaussian_noise_sigma}"
    n_items = max(len(dataset), 1)
    print("%s: psnr: %.2f, ssim: %.4f" % (label, psnr.avg, ssim.avg))
    print("%s: sam: %.3f deg, net time: %.3f s/cube" % (label, sam.avg, wall / n_items))
    return {"psnr": psnr.avg, "ssim": ssim.avg, "sam": sam.avg, "sec_per_cube": wall / n_items}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MP-HSIR evaluation (PyTorch port, mode 0)")
    p.add_argument("--seed", type=int, default=2024)
    p.add_argument("--mode", type=int, default=0, choices=sorted(MODE_TASK_ID),
                   help="degradation mode (0 only so far)")
    p.add_argument("--test_dir", type=str, required=True)
    p.add_argument("--gaussian_noise_sigma", type=int, default=70)
    p.add_argument("--select_bands", type=int, nargs="+", default=[27, 15, 9])
    p.add_argument("--output_path", type=str, default="output/")
    p.add_argument("--ckpt_path", type=str, default="")
    p.add_argument("--data_type", type=str, default="natural_scene", choices=sorted(PRESETS))
    p.add_argument("--no_save_images", action="store_true")
    p.add_argument("--dim", type=int, default=None, help="model width override")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    cfg = EvalConfig(seed=args.seed, mode=args.mode, test_dir=args.test_dir,
                     gaussian_noise_sigma=args.gaussian_noise_sigma,
                     select_bands=tuple(args.select_bands), output_path=args.output_path,
                     ckpt_path=args.ckpt_path, save_images=not args.no_save_images)
    model_cfg = PRESETS[args.data_type]()
    if args.dim:
        model_cfg = dataclasses.replace(model_cfg, dim=args.dim)
    print(f"Start gaussian denoise testing sigma={cfg.gaussian_noise_sigma}")
    run_mode(cfg, model_cfg, device=args.device)


if __name__ == "__main__":
    main()
