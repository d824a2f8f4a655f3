"""One intra-op thread for torch in each test process.

The port's test modules import this. The tier-1 run puts six xdist
workers on eight cores, and at torch's default (a thread a core) their
small CPU ops spin against each other: a tiny DMD step took 0.255 s at 8
threads against 0.058 s at 1, alone, and about 5 s in the loaded suite.
``OMP_NUM_THREADS`` carries the cap into the CLIs the tests start as
subprocesses.
"""

import os

import torch

os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)
