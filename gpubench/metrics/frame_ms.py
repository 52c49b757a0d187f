"""frame_ms: the whole window over every frame accumulated in it, on the
host's clock (the window ends with a synchronize)."""


def read(run):
    if run.unit != "frame" or not run.updates:
        return None
    return run.window_s * 1e3 / (len(run.updates) * run.units_per_update)
