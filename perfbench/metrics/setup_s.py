"""Seconds from the process's start to the window's first step."""


def read(run):
    return run.setup_s
