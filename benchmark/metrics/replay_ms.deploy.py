"""The replay layer a request: the program's `apply/replay` phase (the
winning scan's placements committed into host state), ms."""

KIND = "deploy"


def read(run):
    if run.kind != KIND:
        return None
    return run.mean_phase_ms(("apply/replay",))
