"""The term block's encode a request: the program's `encode/terms`
phase (ops/terms.py build_term_tables and the plan's term arrays,
inside `sweep/encode`), ms. Nothing to read from a program without the
phase."""

from benchmark import phases


def read(run):
    return phases.phases_ms(run, "deploy", ("encode/terms",))
