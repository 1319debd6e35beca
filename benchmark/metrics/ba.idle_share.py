"""The traced span's card-idle time while the host's innermost program
span belongs to local BA (`es.*`, `programs.local_ba`), over the span's
wall time (spantrace.idle_share)."""
from spantrace import idle_share


def read(run):
    return idle_share(run.trace, "ba")
