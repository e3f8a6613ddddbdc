"""Kernel launches of the capacity search a plan: the program's
`launches_sweep_probe` (one masked scan) and `launches_sweep_many` (a
batch of counts in one launch) counters, per completed plan."""


def read(run):
    done = run.done
    if run.kind != "plan" or not done:
        return None
    return sum(r.launches.get("sweep_probe", 0) + r.launches.get("sweep_many", 0)
               for r in done) / len(done)
