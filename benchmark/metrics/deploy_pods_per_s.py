"""Pods placed a second: the pods of the rollouts the window completed
over the window's time, from its start to its last completion (host
clock)."""


def read(run):
    done = run.done
    if run.kind != "deploy" or not done:
        return None
    return sum(r.pods for r in done) / run.window_s
