"""k8_roofline: the kernel's share of its roofline: the least time the card
could take for its frozen operations and bytes a launch (``gpubench/count/``,
``peaks.bound_s``) over its mean device time a launch in the profiler's
trace (the kernel ``diff_kernel``).  Nothing where the trace holds no launch of
it or the cell's file has no count of it."""

from gpubench import peaks


def read(run):
    frozen = run.cell.data.get("frozen", {}).get("k8")
    if run.trace is None or not frozen:
        return None
    times = run.trace.kernel_times("diff_kernel")
    if not times:
        return None
    return peaks.bound_s(frozen["ops_per_launch"], frozen["bytes_per_launch"]) / (sum(times) / len(times)) * 100.0
