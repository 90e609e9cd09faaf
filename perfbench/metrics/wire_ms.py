"""The wire's device time a step, in ms, on several workers only: from
the last compression's probe mark to the means' (the gathers of the
pairs, the wait and the rank-order decode), the slowest rank's."""
from perfbench.metrics._layers import mean_ms


def read(run):
    if run.traffic["workers"] < 2:
        return None
    return mean_ms(run, "wire")
