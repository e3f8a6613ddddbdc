"""Seconds from the process's start to the window's first request: the
imports, the card, the kernel library (built by nvcc on a checkout's
first run), the inputs and the warm-up request (host clock)."""


def read(run):
    return run.setup_s
