"""Mean device ms of one async keyframe program's graph replay, from the
CUDA events around it (`programs.keyframe.device`), over the window's
keyframes; None where no keyframe program ran as a replay (an eager
program leaves no record)."""
from spantrace import device_ms


def read(run):
    return device_ms(run, "keyframe")
