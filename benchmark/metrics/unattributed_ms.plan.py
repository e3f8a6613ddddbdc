"""The request's time in no phase of the program: the harness's clock
around one `simon apply` less the program's top-level phases
(benchmark/phases.py `TOP_LEVEL`), ms."""

from benchmark import phases

KIND = "plan"


def read(run):
    return phases.unattributed_ms(run, KIND)
