"""Mean device ms of one local BA graph replay, the solve on the card,
from the CUDA events around it (`programs.local_ba.device`), over the
window's solves; `ba.solve_ms` is the host's assembly and launch of the
same solves."""
from spantrace import device_ms


def read(run):
    return device_ms(run, "local_ba")
