"""Scenario-scan launches a round: the program's `launches_scenario_scan`
counter over the round (1 where the round's what-ifs coalesce into one
tick), mean over rounds."""

from benchmark import phases


def read(run):
    if phases.phases_ms(run, "deploy", ("serve/expand",)) is None:
        return None
    done = run.done
    return sum(r.launches.get("scenario_scan", 0) for r in done) / len(done)
