"""A round's time in the daemon's replay, less its bodies: the
program's `serve/replay` phase less the `serve/payload` inside it (each
what-if's placements laid onto the committed nodes), summed over the
round's ticks, mean over rounds, ms."""

from benchmark import phases


def read(run):
    replay = phases.phases_ms(run, "deploy", ("serve/replay", "serve/payload"))
    if replay is None:
        return None
    return run.mean_phase_ms(("serve/replay",)) - run.mean_phase_ms(("serve/payload",))
