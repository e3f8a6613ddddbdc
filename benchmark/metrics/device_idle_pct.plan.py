"""Share of the traced window in which no operation ran on the card:
1 - (the union of the device operations' intervals) / window, from
torch.profiler's CUDA activity, %."""

KIND = "plan"


def read(run):
    t = run.trace
    if run.kind != KIND or t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
