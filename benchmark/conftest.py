"""The benchmark's own tests import its modules by their file names and the
port from the checkout's root. Each test process runs torch on two threads:
the tests time tiny drives against windows of 16-40 s, and a process per
worker each with a thread per core oversubscribes the host until no whole
drive fits in a window."""
import sys
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]
torch.set_num_threads(2)
