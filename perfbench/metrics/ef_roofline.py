"""The compression's share of its memory roofline: the least bytes a
step's compression needs (``g`` and ``e`` read once, ``e'`` written
once, the ``k_cap`` pairs written) over 3.35 TB/s, against the device
time of every kernel launched inside the compression's span, the mean
over the ranks."""
import statistics

from perfbench.bench.flops import PEAK_HBM_BYTES, ef_least_bytes


def read(run):
    shares = []
    for t in run.traces:
        if t and t["compress_device_s"] > 0:
            least = ef_least_bytes(run.model, run.train["ratio"]) \
                * t["steps"] / PEAK_HBM_BYTES
            shares.append(100.0 * least / t["compress_device_s"])
    return statistics.fmean(shares) if shares else None
