"""host_ms.step: the host's milliseconds in the entry point's call before it
returns (its span, ``CALL_SPAN`` of the cell's entry: ``step``), a mean
over the window's calls, in cells that count steps."""


def read(run):
    if run.unit != "step":
        return None
    secs, n = run.rec.total(run.call_span, *run.window)
    return secs * 1e3 / n if n else None
