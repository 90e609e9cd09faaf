"""The fwd_bwd layer's device time a step, in ms: CUDA events at the
program's probe marks, the mean over the traced window's unprofiled
steps (see ``bench/probe.LAYERS``)."""
from perfbench.metrics._layers import mean_ms


def read(run):
    return mean_ms(run, "fwd_bwd")
