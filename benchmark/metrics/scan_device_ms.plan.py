"""Device time of the fused-scan kernels a completed plan, ms: their
intervals in torch.profiler's CUDA activity over the traced window."""

KERNEL = "fused_scan"


def read(run):
    t, done = run.trace, run.done
    if run.kind != "plan" or t is None or not done:
        return None
    secs = t.seconds_of(KERNEL)
    return secs * 1e3 / len(done) if secs > 0 else None
