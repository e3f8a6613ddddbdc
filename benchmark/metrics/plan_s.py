"""Seconds a capacity plan: the window's time, from its start to its
last completion, over the plans it completed (host clock)."""


def read(run):
    done = run.done
    if run.kind != "plan" or not done:
        return None
    return run.window_s / len(done)
