"""The encode layer a request: the program's `sweep/expand` (workload
expansion, queue order) and `sweep/encode` (cluster, batch, plan)
phases, ms."""

KIND = "deploy"


def read(run):
    if run.kind != KIND:
        return None
    return run.mean_phase_ms(("sweep/expand", "sweep/encode"))
