"""The report's two tables a request: the program's `report/nodes`
(Node Info) and `report/pods` (Pod Info) phases, inside `apply/report`,
ms. Nothing to read from a program without the phases."""

from benchmark import phases

KIND = "plan"


def read(run):
    return phases.phases_ms(run, KIND, ("report/nodes", "report/pods"))
