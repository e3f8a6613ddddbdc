"""A round's time writing the replies' bodies: the program's
`serve/payload` phase (each reply every node's pods, as JSON), summed
over the round's ticks, mean over rounds, ms."""

from benchmark import phases


def read(run):
    return phases.phases_ms(run, "deploy", ("serve/payload",))
