"""The rollout's scan (the term block, one fused-scan launch a rollout)
against its roofline: the frozen bound of the scan (benchmark/cost:
every pod visiting every node of the scenario at its class's cost, each
input byte read once, over the H100's published peaks; the operations
bound it) over the scan kernels' device time in the traced window, %.
Nothing to read where a rollout launched other than one scan."""

KERNEL = "fused_scan"


def read(run):
    t, done = run.trace, run.done
    if run.kind != "deploy" or t is None or not done:
        return None
    if any(sum(r.launches.values()) != 1 or r.scan_bound_ms is None for r in done):
        return None
    secs = t.seconds_of(KERNEL)
    if secs <= 0:
        return None
    return 100.0 * sum(r.scan_bound_ms for r in done) / (secs * 1e3)
