"""Device routing and launch accounting shared by the kernel wrappers.

A wrapper takes its plain PyTorch version only for a CPU tensor. A CUDA
tensor launches the kernel on the current device (``torch.cuda.
set_device``), which must be the tensor's: rank r of a mesh runs on its own
card, and :func:`select_card` moves the kernel library to that card. The
one exception is :func:`plain_reference`, a
context manager that makes the wrappers run their plain versions on the card
so that a check can hold the kernel path against them; every such call is
counted in ``ROUTE.plain_cuda_calls``.
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter

import torch

from mp_hsir_tpu_torch.ops.kernels import _build


class KernelCounter:
    """Launches of one kernel wrapper: ``launches`` rises by one where the
    wrapper launches its kernel, and ``specs`` counts the call signatures
    (shapes and options) it launched with."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.specs: Counter = Counter()

    def record(self, spec: tuple) -> None:
        self.launches += 1
        self.specs[spec] += 1

    def reset(self) -> None:
        self.launches = 0
        self.specs.clear()


class Route:
    def __init__(self):
        self.plain_on_cuda = False
        self.plain_cuda_calls = 0

    def use_kernel(self, x: torch.Tensor) -> bool:
        """True: launch the kernel. False: run the plain version."""
        if x.device.type == "cpu":
            return False
        if x.device.type != "cuda":
            raise RuntimeError(f"no kernel for device {x.device}")
        card = torch.cuda.current_device()
        if x.device.index is not None and x.device.index != card:
            # the wrappers launch on the current device's stream
            raise RuntimeError(f"a kernel launch on {x.device} while the current device is "
                               f"cuda:{card}; call torch.cuda.set_device({x.device.index}) first")
        if self.plain_on_cuda:
            self.plain_cuda_calls += 1
            return False
        select_card(card)
        return True

    def count_plain_backward(self, x: torch.Tensor) -> None:
        """A plain backward about to run for a forward that took the plain
        version: counted like the forward when it is on the card."""
        if x.device.type == "cuda":
            self.plain_cuda_calls += 1


_CARD = threading.local()


def select_card(card: int) -> None:
    """Make ``card`` the kernel library's current device on this thread
    (``mp_set_device``), where it is not already: the library's own CUDA
    runtime keeps a current device of its own, which
    ``torch.cuda.set_device`` does not move."""
    if getattr(_CARD, "index", None) != card:
        _build.check("mp_set_device", _build.lib().mp_set_device(card))
        _CARD.index = card


ROUTE = Route()
COUNTERS: dict[str, KernelCounter] = {}


def counter(name: str) -> KernelCounter:
    COUNTERS.setdefault(name, KernelCounter(name))
    return COUNTERS[name]


def reset_counters() -> None:
    for c in COUNTERS.values():
        c.reset()
    ROUTE.plain_cuda_calls = 0


@contextlib.contextmanager
def plain_reference():
    """Run the plain versions on CUDA tensors inside the block (for checks)."""
    prev = ROUTE.plain_on_cuda
    ROUTE.plain_on_cuda = True
    try:
        yield
    finally:
        ROUTE.plain_on_cuda = prev


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(x: torch.Tensor) -> int:
    """The kernels' compute-type code (0 float32, 1 bfloat16); raises else."""
    try:
        return _DTYPE_CODE[x.dtype]
    except KeyError:
        raise TypeError(f"kernels take float32 or bfloat16, got {x.dtype}") from None


def kernel_weight(w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """A (out, in) torch weight as the kernels' [in][out] row-major operand."""
    return w.reshape(w.shape[0], -1).t().to(dt).contiguous()


def f32(t):
    return None if t is None else t.float().contiguous()
