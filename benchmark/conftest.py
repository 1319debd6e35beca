"""The benchmark's own tests import its modules by their file names and the
port from the checkout's root."""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]
