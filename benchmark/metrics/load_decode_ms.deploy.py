"""The decode of a request's load: the program's `load/decode` phase
(the parsed documents sorted by kind, and the nodes' local storage
matched), ms."""

from benchmark import phases

KIND = "deploy"


def read(run):
    return phases.phases_ms(run, KIND, ("load/decode",))
