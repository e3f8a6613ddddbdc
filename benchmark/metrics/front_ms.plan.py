"""The front end a request: the program's `apply/load` (config, YAML,
decode) and `apply/report` (the report tables) phases, ms."""

KIND = "plan"


def read(run):
    if run.kind != KIND:
        return None
    return run.mean_phase_ms(("apply/load", "apply/report"))
