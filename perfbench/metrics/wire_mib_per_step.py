"""MiB a step on the wire, the step's own count (``comm_bits_sparse``),
on several workers only."""


def read(run):
    bits = run.counters.get("comm_bits_sparse")
    if run.traffic["workers"] < 2 or bits is None:
        return None
    return bits / 8 / 2 ** 20
