"""One compute thread per test process for the PyTorch port's tests.

Tier-1 runs the suite in several pytest-xdist workers at once, each a
process with torch's intra-op pool and OpenBLAS's pool sized to every core.
With both pools in each of the workers the cores are oversubscribed many
times over, and the port's CPU tests (many small torch ops and numpy tile
emulations) slowed down tens of times: one train-CLI test took 478 s among
the workers against 14 s alone. Importing this module caps both pools of
the importing process at one thread; no result depends on it."""

import os

import torch

torch.set_num_threads(1)
try:
    from threadpoolctl import threadpool_limits
except ImportError:  # without threadpoolctl numpy keeps its own pool size
    pass
else:
    threadpool_limits(1)

# the environment for a subprocess of these tests: one thread per pool too
SUBPROCESS_ENV = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
