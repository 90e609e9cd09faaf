"""Shared by the readers of the probe's layer times: the mean ms a step
of one layer over the traced window's unprofiled steps, the slowest
rank's, or None where the probe marked none or the run had no card."""
import statistics


def mean_ms(run, layer):
    xs = (run.layer_ms.get(layer) or []) if run.gpu else []
    return statistics.fmean(xs) if xs else None
