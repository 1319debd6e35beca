"""Mean device ms of one `track_step` graph replay, from the CUDA events
around it (`programs.track_step.device`), over the window's replays."""
from spantrace import device_ms


def read(run):
    return device_ms(run, "track_step")
