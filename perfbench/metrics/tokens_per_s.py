"""Tokens trained a second: every token of every step of the window
(all cards), over the window's whole time."""


def read(run):
    return run.tokens_per_step * len(run.step_s) / run.window_s
