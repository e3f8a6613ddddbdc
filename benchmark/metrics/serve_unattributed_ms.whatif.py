"""A round's time in no phase of a tick: the harness's clock around the
round less the program's `serve/expand`, `serve/encode`, `serve/scan`
and `serve/replay` (the callers, HTTP, the requests' parsing and
admission, the queue), mean over rounds, ms."""

from benchmark import phases

TICK = ("serve/expand", "serve/encode", "serve/scan", "serve/replay")


def read(run):
    if phases.phases_ms(run, "deploy", TICK) is None:
        return None
    done = run.done
    return sum(r.seconds - sum(r.phases[n] for n in TICK) for r in done) * 1e3 / len(done)
