"""The driver of `simon serve` traffic: the port's daemon in this
process, and a request is one round of what-ifs against it.

The daemon is the program's own: the configuration's cluster written as
a simon config (its committed workload in the cluster's directory,
benchmark/generate_whatif.py), its flags read by the CLI's parser, and
the daemon built and warmed by the CLI's set-up (`cli.build_serve_daemon`,
the committed scan included), serving on 127.0.0.1 at a port of its
own. A round is the traffic mix's `clients` callers, each POSTing its
own what-if to `/v1/simulate` over HTTP at once, and it ends when all
have answered; the next starts at once (a closed loop of `clients`).
The program's phase totals restart at each round, as `cli.main`
restarts them at a command.

Inside the window the replies are kept as bytes. After it the daemon
stops by drain (at the first judgement, or at exit), the what-ifs'
latencies are printed (`whatif_latency_ms`, stderr), and each reply is
judged against the plain reference (benchmark/check_whatif.py): a
round with a reply other than 200 is a failed request. A program
without `cli.build_serve_daemon` cannot run the cell: the driver then
raises before it builds anything.
"""

from __future__ import annotations

import atexit
import http.client
import importlib
import json
import os
import statistics
import sys
import threading
import time

from benchmark import check_whatif, generate_whatif
from benchmark.cost import scenario_scan
from benchmark.reference import kube_v120_whatif

LIMITS = check_whatif.LIMITS
# a caller's wait for its reply; far above a round's time at the cell's size
REPLY_TIMEOUT_S = 600.0


class Driver:
    def __init__(self, cell, seed: int, tmp: str, device=None):
        cli = importlib.import_module("open_simulator_tpu_torch.cli")
        if not hasattr(cli, "build_serve_daemon"):
            raise RuntimeError("the program has no cli.build_serve_daemon: its daemon "
                               "cannot be built in this process")
        self.cluster = generate_whatif.make_cluster(cell.config, seed)
        self.warm = generate_whatif.make_round(self.cluster, cell.traffic, seed, -1)
        self.ring = [generate_whatif.make_round(self.cluster, cell.traffic, seed, i)
                     for i in range(int(cell.traffic["ring"]))]
        self.bodies = {inst.tag: generate_whatif.envelope(inst)
                       for rnd in [self.warm] + self.ring for inst in rnd.whatifs}
        path = generate_whatif.write_cluster(self.cluster, os.path.join(tmp, "cluster"))
        flags = cell.config["daemon"]
        argv = ["serve", "-f", path, "--host", "127.0.0.1", "--port", "0",
                "--max-batch", str(flags["max_batch"])]
        if not flags["incremental"]:
            argv.append("--no-incremental")
        if flags["default_deadline_s"] is not None:
            argv += ["--default-deadline", str(flags["default_deadline_s"])]
        if device is not None:
            argv += ["--device", device]
        self.daemon = cli.build_serve_daemon(cli.build_parser().parse_args(argv))
        self.daemon.start()
        self._closed = False
        atexit.register(self.close)
        self.latencies = []  # seconds of each what-if of the window's rounds
        self.reply_bytes = []  # and the bytes of its reply
        self.committed = None  # the reference's committed state, made at the first judgement
        self._refs = {}

    def send(self, rnd) -> tuple:
        """One round: (every what-if answered 200, the replies as
        (status, body, seconds))."""
        from open_simulator_tpu_torch.utils.trace import GLOBAL

        GLOBAL.reset()
        replies = [(None, b"", 0.0)] * len(rnd.whatifs)

        def call(c: int) -> None:
            t0 = time.perf_counter()
            conn = http.client.HTTPConnection(self.daemon.host, self.daemon.port,
                                              timeout=REPLY_TIMEOUT_S)
            try:
                conn.request("POST", "/v1/simulate", body=self.bodies[rnd.whatifs[c].tag],
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                replies[c] = (resp.status, resp.read(), time.perf_counter() - t0)
            except (OSError, http.client.HTTPException) as e:
                replies[c] = (None, repr(e).encode(), time.perf_counter() - t0)
            finally:
                conn.close()

        callers = [threading.Thread(target=call, args=(c,), daemon=True)
                   for c in range(len(rnd.whatifs))]
        for t in callers:
            t.start()
        for t in callers:
            t.join()
        if rnd is not self.warm:
            self.latencies.extend(s for _, _, s in replies)
            self.reply_bytes.extend(len(b) for _, b, _ in replies)
        return all(status == 200 for status, _, _ in replies), replies

    def close(self) -> None:
        """Stop the daemon by drain and print the window's latencies;
        once."""
        if self._closed:
            return
        self._closed = True
        code = self.daemon.shutdown()
        lat = sorted(self.latencies)
        if len(lat) >= 2:
            print("whatif_latency_ms: " + json.dumps({
                "n": len(lat), "p50": statistics.median(lat) * 1e3,
                "p95": statistics.quantiles(lat, n=20)[18] * 1e3,
                "reply_bytes_mean": statistics.mean(self.reply_bytes), "drain_exit": code}),
                file=sys.stderr, flush=True)

    def _reference(self, inst):
        if self.committed is None:
            self.committed = kube_v120_whatif.Committed(self.cluster)
        if inst.tag not in self._refs:
            self._refs[inst.tag] = self.committed.place(inst)
        return self._refs[inst.tag]

    def judge(self, rnd, replies) -> tuple:
        """(the numbers compared, what the metrics read of the round)."""
        self.close()
        totals = {k: 0 for k in LIMITS}
        pods, error = 0, None
        for inst, (_, body, _) in zip(rnd.whatifs, replies):
            nums, own, err = check_whatif.judge(body, inst, self.cluster, self._reference(inst))
            for k, v in nums.items():
                totals[k] += v
            pods += own
            error = error or err
        facts = {"pods": pods, "scan_bound_ms": scenario_scan.bound(rnd.whatifs)[0]}
        if error:
            facts["error"] = error
        return totals, facts
