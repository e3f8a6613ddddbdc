"""The rounds' scenario scans (B6, a row a what-if) against their
roofline: the frozen bound of each round's rows (benchmark/cost/
scenario_scan.py: every active pod of a row visiting every node at its
class's cost, each input byte read once, over the H100's published
peaks) over the scan kernel's device time in the traced window, %.
Nothing to read where a round made no scenario-scan launch."""

KERNEL = "fused_scan"


def read(run):
    t, done = run.trace, run.done
    if run.kind != "deploy" or t is None or not done:
        return None
    if any(not r.launches.get("scenario_scan") or r.scan_bound_ms is None for r in done):
        return None
    secs = t.seconds_of(KERNEL)
    if secs <= 0:
        return None
    return 100.0 * sum(r.scan_bound_ms for r in done) / (secs * 1e3)
