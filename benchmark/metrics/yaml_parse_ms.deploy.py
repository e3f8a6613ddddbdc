"""The YAML parse a request: the program's `load/parse` phase (libyaml
over every file the load read), ms."""

from benchmark import phases

KIND = "deploy"


def read(run):
    return phases.phases_ms(run, KIND, ("load/parse",))
