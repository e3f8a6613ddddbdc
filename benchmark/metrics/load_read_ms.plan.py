"""The file reads of a request's load: the program's `load/read` phase
(the YAML files of the cluster, the apps and the new node read into
strings), ms."""

from benchmark import phases

KIND = "plan"


def read(run):
    return phases.phases_ms(run, KIND, ("load/read",))
