"""MP-HSIR in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The package mirrors ``mp_hsir_tpu`` (the JAX reference) module by module and
imports nothing from it. Entry points run on the card (``device="cuda"``)
unless the caller passes ``device="cpu"``; on the CPU every kernel wrapper
uses its plain PyTorch version.
"""

import numpy as np
import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default) raises
    when no card is visible; there is no silent fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


def upload(a: np.ndarray, device: str | torch.device) -> torch.Tensor:
    """A host array on ``device`` without a synchronising copy: on the card
    it goes through pinned memory with ``non_blocking`` (the caching host
    allocator keeps the pinned block until the copy has run), so code that
    runs under ``torch.cuda.set_sync_debug_mode("error")`` may call it. The
    result is a normal tensor even inside ``torch.inference_mode``, so that a
    constant cached on its first use by an eval forward serves autograd in a
    later train step."""
    with torch.inference_mode(False):
        t = torch.from_numpy(np.ascontiguousarray(a))
        dev = torch.device(device)
        if dev.type != "cuda":
            return t.to(dev)
        return t.pin_memory().to(dev, non_blocking=True)
