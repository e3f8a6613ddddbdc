"""The probe's inputs a request: the program's `probe/inputs` phase (the
scenario masks built and copied to the card ahead of the launch), ms."""

from benchmark import phases

KIND = "deploy"


def read(run):
    return phases.phases_ms(run, KIND, ("probe/inputs",))
