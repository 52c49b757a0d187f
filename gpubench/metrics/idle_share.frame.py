"""idle_share.frame: the share of the traced window in which no kernel ran on
the card, 1 - (union of the kernels' intervals) / window, from the profiler."""


def read(run):
    if run.unit != "frame" or run.trace is None or not run.trace.kernels:
        return None
    return (1.0 - run.trace.busy_s / run.trace.window_s) * 100.0
