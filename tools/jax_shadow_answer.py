"""The JAX package's answers to chip_smoke.py phase 23's cut: the
default scenario's chip_smoke.SHADOW_JAX_NODES nodes and its first
chip_smoke.SHADOW_JAX_DECISIONS pods (chip_smoke.write_shadow_config),
recorded by the JAX package's `shadow --record` (the serial oracle) and
replayed by its `shadow --decision-log --format json` on its CPU
backend (the XLA scan):

    JAX_PLATFORMS=cpu python tools/jax_shadow_answer.py

Prints the sha256 of the decision log's bytes
(chip_smoke.JAX_SHADOW_LOG_ANSWER) and chip_smoke.shadow_digest of the
replay report (the engine and compiler fields set aside:
chip_smoke.JAX_SHADOW_ANSWER), with exit codes and wall times. With
`--port` it runs the GPU port's CLI instead, the replay on the CPU
(`--device cpu`): the same two digests.
"""

import contextlib
import hashlib
import io
import json
import resource
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def run(pkg, argv):
    import importlib

    cli = importlib.import_module(f"{pkg}.cli")
    importlib.import_module(f"{pkg}.models.workloads").reset_name_counter()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue(), time.perf_counter() - t0


def main() -> int:
    import chip_smoke

    pkg = "open_simulator_tpu_torch" if "--port" in sys.argv[1:] else "open_simulator_tpu"
    extra = ["--device", "cpu"] if pkg.endswith("torch") else []
    with tempfile.TemporaryDirectory() as root:
        cfg = chip_smoke.write_shadow_config(root, chip_smoke.SHADOW_JAX_NODES,
                                             chip_smoke.SHADOW_JAX_DECISIONS)
        log = str(Path(root) / "decisions.jsonl")
        rc, out, secs = run(pkg, ["shadow", "-f", cfg, "--record", log])
        digest = hashlib.sha256(Path(log).read_bytes()).hexdigest()
        print(f"JAX_SHADOW_LOG_ANSWER {digest} ({pkg}, exit {rc}, {secs:.1f} s CPU wall "
              f"time: {out.strip()})", flush=True)
        rc, out, secs = run(pkg, ["shadow", "-f", cfg, "--decision-log", log,
                                  "--format", "json", *extra])
        doc = json.loads(out)
        print(f"JAX_SHADOW_ANSWER {chip_smoke.shadow_digest(out)} ({pkg}, exit {rc}, "
              f"{secs:.1f} s CPU wall time, agreement {doc['agreementRate']} over "
              f"{doc['decisions']} decisions, {len(out)} bytes)", flush=True)
    rss_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1 << 20)
    print(f"max resident {rss_gib:.2f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
