"""idle_in_port_ms.frame: the card's idle time (the profiler's gaps between
kernels) that lies inside the port's spans of the window's calls
(``mk.call`` and what it holds), mapped onto the profiler's timeline and
summed microsecond by microsecond, in ms a call (``gpubench/program.py``).
Nothing without a trace of the card's kernels or the port's spans."""

from gpubench import program


def read(run):
    if run.unit != "frame":
        return None
    return program.idle_in_port_ms(run)
