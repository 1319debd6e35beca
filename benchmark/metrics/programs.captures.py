"""CUDA graph captures made inside the window (`Program.stats()` of
`track_step` and `local_ba`, after against before). The warm-up drive
meets every key, so a capture here is set-up work that leaked into the
window."""


def read(run):
    return sum(len(run.programs_after[k]) - len(run.programs_before[k])
               for k in run.programs_after)
