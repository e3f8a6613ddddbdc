"""The command's work around the plan a request: the program's
`cli/args`, `cli/config`, `apply/gc` (the closing collection),
`cli/print` and `cli/release` phases, ms."""

from benchmark import phases

KIND = "deploy"


def read(run):
    return phases.phases_ms(run, KIND, phases.OVERHEAD)
