"""Check the shared clock of the program's spans and the card's trace.

    python -m tools.span_clock --workload basic-plan [--seed N] [--requests 2]

from the root of a checkout, on a machine with a CUDA card. Runs the
benchmark cell's warm-up request, then `--requests` more under
torch.profiler with the span recorder on, the two clocks meeting at one
marker as in benchmark/devtrace.py (a profiler `record_function` and a
span of the same name opened together). Before and after the requests
the host waits on a CUDA event behind a spin kernel, inside a span: the
host's return from that wait (the profiler's record of the
`cudaEventSynchronize` call) and the span's close are one instant, so
their distance is the marker's error, and the spin kernel's end is a
check of the profiler's own device-to-host alignment.

Each `fused_scan` kernel's device interval must open after its launch's
`launch/<site>` span opens and close before the following `probe/wait`
phase closes, to within `--slack-us` (50), on the spans' clock moved by
the first wait's error. Prints one JSON line: the errors and each
kernel's margins in µs (positive: inside), by the marker as it is and
as moved, and `ok`; exits 1 when a kernel falls outside.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

MARK = "span-clock/window"
SYNC = "span-clock/sync"
EVENT_SYNC = "cudaEventSynchronize"


def _intervals(workload: str, seed: int, requests: int):
    """(device operations, CUDA runtime calls, the program's spans) of
    the traced window, each as (name, start, end) in seconds from the
    marker."""
    from benchmark import cells

    root = os.getcwd()
    cell = cells.load_cell(root, workload)
    tmp = tempfile.mkdtemp(prefix="span-clock-")
    try:
        return _traced(cells.load_driver(root, cell).Driver(cell, seed, tmp), requests)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _calibrate(torch, recorder) -> None:
    """A spin kernel, then the host's wait on an event behind it."""
    torch.cuda._sleep(20_000_000)
    done = torch.cuda.Event()
    done.record()
    with recorder.span(SYNC):
        done.synchronize()


def _traced(driver, requests: int):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from open_simulator_tpu_torch.obs.spans import RECORDER

    ok, _ = driver.send(driver.warm)
    if not ok:
        raise SystemExit("the warm-up request did not answer")
    RECORDER.enable()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        with record_function(MARK), RECORDER.span(MARK):
            _calibrate(torch, RECORDER)
            for i in range(requests):
                ok, _ = driver.send(driver.ring[i % len(driver.ring)])
                if not ok:
                    raise SystemExit("a traced request did not answer")
            _calibrate(torch, RECORDER)
            torch.cuda.synchronize()
    spans = RECORDER.snapshot()
    RECORDER.disable()
    events = prof.profiler.kineto_results.events()
    mark = next(e for e in events if e.name() == MARK and "CPU" in str(e.device_type()))
    w0 = mark.start_ns()

    def rel(e):
        return (_short(e.name()), (e.start_ns() - w0) / 1e9,
                (e.start_ns() + e.duration_ns() - w0) / 1e9)

    device = sorted((rel(e) for e in events if "CUDA" in str(e.device_type())
                     and e.name() != MARK
                     and not getattr(e, "is_user_annotation", lambda: False)()),
                    key=lambda k: k[1])
    runtime = sorted((rel(e) for e in events if "CPU" in str(e.device_type())
                      and e.name().startswith("cuda")), key=lambda k: k[1])
    anchor = next(sp for sp in spans if sp.name == MARK).t0
    host = sorted(((sp.name, sp.t0 - anchor, sp.t1 - anchor) for sp in spans
                   if sp.name.startswith("launch/") or sp.name in ("probe/wait", SYNC)),
                  key=lambda s: s[1])
    return device, runtime, host


def _short(name: str) -> str:
    """A device operation's name without its return type and arguments."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[len("void "):] if name.startswith("void ") else name
    return name.split("(", 1)[0][:80]


def _us(seconds: float) -> float:
    return round(seconds * 1e6, 3)


def check(device, runtime, host, slack_s: float) -> dict:
    """The marker's error at the first and the last wait, then each
    fused_scan kernel (the k-th paired with the k-th launch span)
    against its launch span's open and the close of the first
    `probe/wait` after it: by the marker, and by the spans moved by the
    first wait's error; and against the profiler's own record of the
    host's wait."""
    waits = [r for r in runtime if r[0].startswith(EVENT_SYNC)]
    syncs = [h for h in host if h[0] == SYNC]
    calib = []
    for sync, ret in ((syncs[0], waits[0]), (syncs[-1], waits[-1])):
        spin = max((k for k in device if k[2] <= ret[2]), key=lambda k: k[2])
        calib.append({"kernel": spin[0], "span_error_us": _us(ret[2] - sync[2]),
                      "wait_returns_after_spin_ends_us": _us(ret[2] - spin[2])})
    shift = waits[0][2] - syncs[0][2]
    kernels = [k for k in device if "fused_scan" in k[0]]
    launches = [h for h in host if h[0].startswith("launch/")]
    rows, ok = [], len(kernels) == len(launches) > 0
    for (kname, k0, k1), (lname, l0, l1) in zip(kernels, launches):
        wait = next((h for h in host if h[0] == "probe/wait" and h[1] >= l1), None)
        ret = next((r for r in waits if r[2] >= k1), None)
        row = {"kernel": kname, "site": lname, "kernel_us": _us(k1 - k0),
               "after_launch_opens_us": _us(k0 - l0),
               "after_launch_opens_moved_us": _us(k0 - l0 - shift)}
        if wait is not None:
            row["before_wait_closes_us"] = _us(wait[2] - k1)
            row["before_wait_closes_moved_us"] = _us(wait[2] + shift - k1)
        if ret is not None:
            row["before_wait_returns_us"] = _us(ret[2] - k1)
        ok = (ok and wait is not None and k0 - l0 - shift >= -slack_s
              and wait[2] + shift - k1 >= -slack_s)
        rows.append(row)
    return {"kernels": len(kernels), "launch_spans": len(launches), "ok": ok,
            "calibration": calib, "rows": rows}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=2**31 + 5)
    p.add_argument("--requests", type=int, default=2)
    p.add_argument("--slack-us", type=float, default=50.0)
    args = p.parse_args(argv)
    out = check(*_intervals(args.workload, args.seed, args.requests), args.slack_us / 1e6)
    out["workload"] = args.workload
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
