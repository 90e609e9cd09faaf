"""The most device memory allocated over set-up and window, the fullest
card's, in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.gpu else None
