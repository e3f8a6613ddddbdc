"""The probe's read-back a request: the program's `probe/readback` phase
(the placements and final state copied to the host, and their stats),
ms."""

from benchmark import phases

KIND = "plan"


def read(run):
    return phases.phases_ms(run, KIND, ("probe/readback",))
