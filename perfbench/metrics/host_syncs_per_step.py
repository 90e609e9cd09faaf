"""The host's synchronising CUDA calls (stream, device and event
synchronise; blocking copies) inside the profiled steps, a step, the
mean over the ranks."""
import statistics


def read(run):
    if not run.gpu:
        return None
    ts = [t for t in run.traces if t]
    return statistics.fmean(t["syncs_per_step"] for t in ts) if ts else None
