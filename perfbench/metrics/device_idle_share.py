"""The share of the profiled steps' wall time in which no operation ran
on the device: one minus the union of every kernel's, copy's and set's
interval on every stream over the window, the mean over the ranks."""
import statistics


def read(run):
    ts = [t for t in run.traces if t and t["busy_s"] > 0]
    if not ts:
        return None
    return statistics.fmean(100.0 * (1 - t["busy_s"] / t["window_s"])
                            for t in ts)
