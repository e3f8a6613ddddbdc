"""A round's time in the daemon's encode: the program's `serve/encode`
phase (the tick's pods encoded against the committed state and the
scan's plan), summed over the round's ticks, mean over rounds, ms."""

from benchmark import phases


def read(run):
    return phases.phases_ms(run, "deploy", ("serve/encode",))
