"""A round's time in the daemon's scan: the program's `serve/scan`
phase (the scenario scan's launches and their read-back), summed over
the round's ticks, mean over rounds, ms."""

from benchmark import phases


def read(run):
    return phases.phases_ms(run, "deploy", ("serve/scan",))
