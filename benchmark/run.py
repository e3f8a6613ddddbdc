"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration and traffic mix
(found by name, benchmark/cells.py) and the seed make the requests:
a ring of `simon apply` inputs written under TMPDIR, and one more for
the warm-up, made by the driver the traffic mix names
(benchmark/drivers/<driver>.py; `simon_apply` sends each through the
port's CLI in this process). Set-up ends with the warm-up request; the
window then sends the ring's requests one after another, each as soon
as the last has answered (one caller, a closed loop), until `--seconds`
have passed and the request in flight has answered. After the window
the driver judges every answer against the plain reference and the
metrics are read (benchmark/metrics/). `--trace 1` records the
card with torch.profiler over the window and reports the per-layer
metrics in place of the end-to-end ones.

The run needs the cell's CUDA cards: without them it exits 2 and prints
no result. It also prints none, and exits 3, if the JAX package or JAX
is loaded in the process once the window has closed, and 4 if a traced
window's profiler recorded no device activity.
"""

from __future__ import annotations

import os
import time


def _started_at() -> float:
    """This process's start on the perf_counter clock (from /proc; the
    module's import time where /proc cannot say)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return now


STARTED = _started_at()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

from . import cells  # noqa: E402
from .record import Request, Run  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
PROGRAM = "open_simulator_tpu_torch"
# top-level module names that may not be loaded once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "open_simulator_tpu")


def _err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="benchmark.run", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared as whole names."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _import_program() -> None:
    """The port, from this checkout and nowhere else."""
    import importlib

    pkg = importlib.import_module(PROGRAM)
    where = Path(pkg.__file__).resolve().parent
    if where != CHECKOUT / PROGRAM:
        raise ImportError(f"{PROGRAM} resolves to {where}, not to this checkout's")


def _launches() -> dict:
    from open_simulator_tpu_torch.utils.trace import COUNTERS

    counts = COUNTERS.snapshot()["counts"]
    return {k[len("launches_"):]: v for k, v in counts.items()
            if k.startswith("launches_") and k != "launches_total"}


def _phases() -> dict:
    from open_simulator_tpu_torch.utils.trace import GLOBAL

    return {p["name"]: p["seconds"] for p in GLOBAL.as_dict()["phases"]}


def _mean_phases(requests) -> dict:
    """The program's phase seconds averaged over answered requests."""
    done = [r for r in requests if r.ok]
    names = sorted({n for r in done for n in r.phases})
    return {n: round(sum(r.phases.get(n, 0.0) for r in done) / len(done), 4) for n in names}


def _host() -> dict:
    """What the host gave this process so far: its CPU seconds and
    involuntary context switches, and the machine's stolen and total
    CPU ticks (/proc/stat), to tell a slow host from slow work."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"cpu_s": ru.ru_utime + ru.ru_stime, "involuntary_switches": ru.ru_nivcsw}
    try:
        with open("/proc/stat") as f:
            ticks = [int(v) for v in f.readline().split()[1:]]
        out["steal_ticks"], out["all_ticks"] = ticks[7], sum(ticks)
    except (OSError, ValueError, IndexError):
        pass
    return out


def _host_delta(before: dict, after: dict, window_s: float) -> dict:
    out = {k: after[k] - before[k] for k in before if k in after}
    out["cpu_share_of_window"] = out["cpu_s"] / window_s if window_s > 0 else None
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f if line.startswith("cpu MHz")]
        out["cpu_mhz_mean"] = sum(mhz) / len(mhz) if mhz else None
    except (OSError, ValueError):
        pass
    out["cpus_allowed"] = len(os.sched_getaffinity(0))
    return out


def main(argv=None, *, root=None, device=None) -> int:
    """Run the cell; returns the exit code. `root` holds BENCHMARK.json
    (the working directory by default); `device` None is the card, and
    a test may pass "cpu" to drive the rest of a run without one (the
    kernels' plain versions, no device metrics)."""
    args = parse_args(argv)
    root = os.path.abspath(root or os.getcwd())
    try:
        cell = cells.load_cell(root, args.workload)
        driver_module = cells.load_driver(root, cell)
    except (cells.CellError, OSError, KeyError, ValueError) as e:
        _err(f"error: {e}")
        return 2
    import torch

    on_card = device is None
    if on_card:
        if not torch.cuda.is_available():
            _err("error: no CUDA card: the benchmark runs only on one")
            return 2
        if torch.cuda.device_count() < cell.chips:
            _err(f"error: the cell needs {cell.chips} card(s), "
                 f"{torch.cuda.device_count()} found")
            return 2
    try:
        _import_program()
    except ImportError as e:
        _err(f"error: the program is not here: {e}")
        return 2
    t_imports = time.perf_counter()
    if on_card:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
    t_card = time.perf_counter()

    tmp = tempfile.mkdtemp(prefix="simon-bench-")
    try:
        driver = driver_module.Driver(cell, args.seed, tmp, device)
        return _run(args, cell, driver, driver_module.LIMITS, on_card, t_imports, t_card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(args, cell, driver, limits, on_card, t_imports, t_card) -> int:
    import torch

    from open_simulator_tpu_torch.utils.trace import COUNTERS

    t_inputs = time.perf_counter()
    builds0 = COUNTERS.get("nvcc_builds_total")
    ok, _ = driver.send(driver.warm)
    if not ok:
        _err("the warm-up request did not answer")
    warm_phases = _phases()
    t_setup = time.perf_counter()
    setup_s = t_setup - STARTED
    _err("setup: " + json.dumps({
        "total_s": setup_s, "imports_s": t_imports - STARTED, "card_s": t_card - t_imports,
        "inputs_s": t_inputs - t_card, "warmup_s": t_setup - t_inputs,
        "warmup_probe_search_s": warm_phases.get("apply/probe-search", 0.0),
        "nvcc_builds": COUNTERS.get("nvcc_builds_total") - builds0}))

    tracer = None
    if args.trace and on_card:
        from .devtrace import Tracer

        tracer = Tracer()
    ring = driver.ring
    requests, answers = [], []
    host0 = _host()
    try:
        with tracer if tracer is not None else contextlib.nullcontext():
            # the window opens once the profiler runs; it sends at least
            # one request, and none after its seconds have passed
            t0 = time.perf_counter()
            last = t0
            while not requests or last < t0 + args.seconds:
                inst = ring[len(requests) % len(ring)]
                before = _launches()
                start = time.perf_counter()
                try:
                    ok, answer = driver.send(inst)
                except Exception:  # noqa: BLE001 - a request that raises is a failed one
                    _err(traceback.format_exc())
                    ok, answer = False, None
                last = time.perf_counter()
                after = _launches()
                requests.append(Request(
                    tag=inst.tag, ok=ok, seconds=last - start, phases=_phases(),
                    launches={k: v - before.get(k, 0) for k, v in after.items()
                              if v != before.get(k, 0)}))
                answers.append((inst, answer))
    except RuntimeError as e:
        _err(f"error: {e}")
        return 4
    window_s = last - t0
    _err("host: " + json.dumps(_host_delta(host0, _host(), window_s)))

    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    device_name = torch.cuda.get_device_name(0) if on_card else "cpu"
    loaded = forbidden_modules()
    if loaded:
        _err(f"error: loaded in this process after the window: {', '.join(loaded)}")
        return 3
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    numbers = []
    for req, (inst, answer) in zip(requests, answers):
        if not req.ok:
            continue
        nums, facts = driver.judge(inst, answer)
        numbers.append(nums)
        if "error" in facts:
            _err(facts["error"])
            continue
        for k, v in facts.items():
            setattr(req, k, v)
    answers.clear()
    _err("requests: " + json.dumps([[round(r.seconds, 4), r.count, sum(r.launches.values())]
                                    for r in requests]))
    _err("phases_mean_s: " + json.dumps(_mean_phases(requests)))
    _err(f"check_s: {time.perf_counter() - t_check:.3f}")
    totals = {k: sum(n.get(k, 0) for n in numbers) for k in limits}
    failed = sum(1 for r in requests if not r.ok)
    correct = bool(requests) and failed == 0 and all(totals[k] <= lim
                                                      for k, lim in limits.items())

    run = Run(workload=cell.name, kind=cell.traffic["kind"], setup_s=setup_s,
              window_s=window_s, requests=requests,
              trace=tracer.trace if tracer is not None else None)
    metrics = cells.metric_values(cell, run, bool(args.trace))
    dev = {"platform": "gpu" if on_card else "cpu", "kind": device_name,
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": len(requests), "failed": failed,
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        _err("idle_by_phase_s: " + json.dumps(run.trace.idle_by_phase()))
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    _err(f"answers checked: {len(numbers)}")
    checks = {k: {"value": totals[k], "limit": lim} for k, lim in limits.items()}
    checks["failed_requests"] = {"value": failed, "limit": 0}
    result["checks"] = checks
    for name, c in checks.items():
        _err(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), file=sys.stdout, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
