"""The most device memory allocated over set-up alone, the fullest
card's, in GiB: the weights, the state, the ring of batches and three
whole train steps of the timed step object, read before the window."""


def read(run):
    return run.setup_peak_bytes / 2 ** 30 if run.gpu else None
