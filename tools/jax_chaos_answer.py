"""The JAX package's answers to chip_smoke.py phase 17's small cut: the
capacity scenario cut to chip_smoke.CHAOS_JAX_NODES nodes x
chip_smoke.CHAOS_JAX_PODS pods (chip_smoke.write_capacity_config), run
through the JAX package's CLI on its CPU backend (the XLA scan):

- `chaos -f cfg --failures 2 --trials 32 --format json`
  (chip_smoke.JAX_CHAOS_ANSWER);
- `apply -f cfg --format json --tolerate-node-failures 1`
  (chip_smoke.JAX_NPLUSK_ANSWER).

    JAX_PLATFORMS=cpu python tools/jax_chaos_answer.py

Prints, for each, the sha256 of the command's stdout, its exit code,
its wall time, and the largest resident set. The answer is held at
this cut: the two commands took 55.7 s and 100.8 s on an 8-core Intel
Xeon, and the full phase-17 cut (2,000 nodes x 20,000 pods, about 2,000
scenarios of the vmapped XLA scan) has 64 times the nodes x pods x
scenarios.
"""

import contextlib
import hashlib
import io
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

    with tempfile.TemporaryDirectory() as root:
        cfg = chip_smoke.write_capacity_config(root, chip_smoke.CHAOS_JAX_NODES,
                                               chip_smoke.CHAOS_JAX_PODS)
        for name, argv in (
            ("JAX_CHAOS_ANSWER", ["chaos", "-f", cfg, "--failures", "2", "--trials", "32",
                                  "--format", "json"]),
            ("JAX_NPLUSK_ANSWER", ["apply", "-f", cfg, "--format", "json",
                                   "--tolerate-node-failures", "1"]),
        ):
            rc, out, secs = run(argv)
            print(f"{name} {hashlib.sha256(out.encode()).hexdigest()} (exit {rc}, "
                  f"{secs:.1f} s CPU wall time, {len(out)} bytes)", flush=True)
    rss_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1 << 20)
    print(f"max resident {rss_gib:.2f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
