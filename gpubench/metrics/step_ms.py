"""step_ms: the whole window over every training step in it, on the host's
clock (the window ends with a synchronize)."""


def read(run):
    if run.unit != "step" or not run.updates:
        return None
    return run.window_s * 1e3 / len(run.updates)
