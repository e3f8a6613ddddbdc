"""The JAX package's answers to chip_smoke.py phase 22's two cuts: the
timeline scenario (chip_smoke.write_timeline_config: the default
scenario's nodes, a day-0 pod bound to each untainted node, the 96-cpu
new node) cut to chip_smoke.TL_JAX_NODES nodes, its synthetic trace to
chip_smoke.TL_JAX_ARRIVALS arrivals and its candidate pool to
chip_smoke.TL_JAX_MAX_NODES, and to the TL_ORACLE_* sizes (where the
port's serial oracle is held too), run through the JAX package's CLI on
its CPU backend (the XLA scan):

    JAX_PLATFORMS=cpu python tools/jax_timeline_answer.py

Prints, for each cut, chip_smoke.timeline_digest of the `timeline ...
--format json` stdout (the report with its `engine` set aside:
chip_smoke.JAX_TIMELINE_ANSWER and JAX_TIMELINE_ORACLE_ANSWER), the exit
code, the wall time and the report's windows, dispatches and scale-up
decisions.
"""

import contextlib
import io
import json
import resource
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def run(argv):
    from open_simulator_tpu import cli
    from open_simulator_tpu.models.workloads import reset_name_counter

    reset_name_counter()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue(), time.perf_counter() - t0


def main() -> int:
    import chip_smoke

    cuts = (("JAX_TIMELINE_ANSWER", chip_smoke.TL_JAX_NODES, chip_smoke.TL_JAX_ARRIVALS,
             chip_smoke.TL_JAX_MAX_NODES),
            ("JAX_TIMELINE_ORACLE_ANSWER", chip_smoke.TL_ORACLE_NODES,
             chip_smoke.TL_ORACLE_ARRIVALS, chip_smoke.TL_ORACLE_MAX_NODES))
    with tempfile.TemporaryDirectory() as root:
        for name, n_nodes, arrivals, cand in cuts:
            cfg = chip_smoke.write_timeline_config(Path(root) / name, n_nodes)
            argv = chip_smoke.timeline_argv(cfg, arrivals, cand)
            rc, out, secs = run(argv)
            doc = json.loads(out)
            ups = {p["policy"]: sum(1 for d in p["decisions"] if d["delta"] > 0)
                   for p in doc["policies"]}
            print(f"{name} {chip_smoke.timeline_digest(out)} (exit {rc}, {secs:.1f} s CPU "
                  f"wall time, {n_nodes} nodes x {arrivals} arrivals, {doc['windows']} "
                  f"windows, {doc['dispatches']} dispatches, scale-ups {ups}, final pending "
                  f"{[p['finalPending'] for p in doc['policies']]}, {len(out)} bytes)",
                  flush=True)
    rss_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1 << 20)
    print(f"max resident {rss_gib:.2f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
