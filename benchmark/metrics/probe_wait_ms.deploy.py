"""The host's wait on the card a request: the program's `probe/wait`
phase (blocked on the end events of the search's launches), ms."""

from benchmark import phases

KIND = "deploy"


def read(run):
    return phases.phases_ms(run, KIND, ("probe/wait",))
