"""update_p95_ms: the 95th percentile of every update's latency in the
window, one ``render_many`` ended by a synchronize, on the host's clock."""

import numpy as np


def read(run):
    if run.unit != "frame" or not run.updates:
        return None
    return float(np.percentile([e - s for s, e in run.updates], 95)) * 1e3
