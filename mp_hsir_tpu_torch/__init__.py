"""MP-HSIR in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The package mirrors ``mp_hsir_tpu`` (the JAX reference) module by module and
imports nothing from it. Entry points run on the card (``device="cuda"``)
unless the caller passes ``device="cpu"``; on the CPU every kernel wrapper
uses its plain PyTorch version.
"""

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
