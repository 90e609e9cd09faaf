"""The 95th percentile of the window's step times, in ms (nearest rank);
on several cards a step's time is the slowest rank's."""
import math


def read(run):
    xs = sorted(run.step_s)
    return 1e3 * xs[max(0, math.ceil(0.95 * len(xs)) - 1)]
