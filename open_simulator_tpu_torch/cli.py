"""simon-compatible CLI of the GPU port: `apply`, `chaos` and `defrag`.

  python -m open_simulator_tpu_torch.cli apply -f <simon-config.yaml>
        [--format table|json] [--extended-resources gpu,open-local]
        [--engine cuda|oracle] [--device DEVICE] [--no-sweep]
        [--use-greed] [--default-scheduler-config FILE] [--trace]
        [--tolerate-node-failures K [--chaos-seed S] [--chaos-trials T]]
        [--journal PATH | --resume PATH] [--snapshot FILE]
  python -m open_simulator_tpu_torch.cli chaos -f <simon-config.yaml>
        [--failures K] [--seed S] [--trials T] [--new-node-count N]
        [--cordon NODE,...] [--taint key[=value]:Effect[@nodes]]
        [--degrade PCT[@nodes]] [--journal PATH | --resume PATH]
        [--format table|json] [--device DEVICE] [--trace]
  python -m open_simulator_tpu_torch.cli defrag --snapshot FILE
        [--max-drain N] [--keep-new-nodes] [--format table|json]
        [--device DEVICE]

Mirrors the JAX package's `simon apply`, `simon chaos` and `simon
defrag` (cli.py cmd_apply, cmd_chaos, cmd_defrag), whose reports these
reproduce byte for byte. The scans run on the card unless `--device
cpu` is given (the kernels' plain versions); without a card the default
exits 2 with the "needs a GPU" error. Log level comes from the LogLevel
env var (cmd/simon/simon.go:60-80).

Not ported yet (ROADMAP.md A1a and later): the interactive shell (-i),
explain, mesh, deadline, fault-injection and observability flags, and
the other subcommands.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def _setup_logging():
    level = os.environ.get("LogLevel", "info").lower()
    levels = {
        "debug": logging.DEBUG,
        "info": logging.INFO,
        "warn": logging.WARNING,
        "warning": logging.WARNING,
        "error": logging.ERROR,
    }
    logging.basicConfig(level=levels.get(level, logging.INFO), format="%(levelname)s %(message)s")


def cmd_apply(args) -> int:
    from .apply.applier import Applier, SimonConfig
    from .models.validation import InputError
    from .ops.fused_scan import NoCardError, OutOfSliceError
    from .runtime import ExternalIOError

    try:
        config = SimonConfig.from_file(args.simon_config)
        applier = Applier(
            config,
            extended_resources=args.extended_resources,
            engine=args.engine,
            use_sweep=not args.no_sweep,
            use_greed=args.use_greed,
            scheduler_config=args.default_scheduler_config,
            tolerate_node_failures=args.tolerate_node_failures,
            chaos_seed=args.chaos_seed,
            chaos_trials=args.chaos_trials,
            journal_path=args.journal,
            resume_path=args.resume,
            device=args.device,
        )
        result = applier.run()
    except (OSError, InputError, ExternalIOError, OutOfSliceError, NoCardError) as e:
        # malformed input, a feature the port does not carry yet, or no
        # card for the default device: a clean exit 2; internal errors
        # (a kernel launch, a conformance check) stay loud
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.trace:
        from .utils.trace import GLOBAL

        print(GLOBAL.as_json(), file=sys.stderr)
    if args.snapshot and result.result is not None:
        from .scheduler.snapshot import save_snapshot

        save_snapshot(result.result, args.snapshot, cluster=applier.last_cluster)
    if args.format == "json":
        print(_result_json(result))
        return 0 if result.success else 1
    if not result.success:
        print(result.message)
        if result.result is not None:
            for i, up in enumerate(result.result.unscheduled_pods):
                meta = up.pod.get("metadata") or {}
                print(f"{i:4d} {meta.get('namespace')}/{meta.get('name')}: {up.reason}")
        return 1
    print("Simulation success!")
    if result.new_node_count:
        print(f"new nodes added: {result.new_node_count}")
    print(result.report_text)
    return 0


def _parse_taint(spec: str):
    """`key[=value]:Effect[@node1,node2]` -> (names_or_None, taint)."""
    body, _, nodes = spec.partition("@")
    kv, sep, effect = body.rpartition(":")
    if not sep or not kv or not effect:
        raise ValueError(
            f"taint {spec!r}: expected key[=value]:Effect[@node1,node2]"
        )
    key, _, value = kv.partition("=")
    taint = {"key": key, "effect": effect}
    if value:
        taint["value"] = value
    return ([n for n in nodes.split(",") if n] or None) if nodes else None, taint


def _parse_degrade(spec: str):
    """`PCT[@node1,node2]` -> (percent, names_or_None)."""
    body, _, nodes = spec.partition("@")
    pct = int(body)
    return pct, ([n for n in nodes.split(",") if n] or None) if nodes else None


def cmd_chaos(args) -> int:
    """Fault-injection survivability of a committed plan
    (resilience/chaos.py): exit 0 when every scenario survives, 1
    otherwise, 2 on bad input."""
    import json

    from .apply.applier import (
        MAX_NUM_NEW_NODE,
        Applier,
        SimonConfig,
        _capacity_feasible,
        plan_fingerprint,
    )
    from .models.validation import InputError
    from .models.workloads import reset_name_counter
    from .ops.fused_scan import NoCardError, OutOfSliceError
    from .parallel.sweep import CapacitySweep, PrioritySignalError
    from .resilience.chaos import ChaosEngine, perturbed_scenario_sweep
    from .runtime import ExternalIOError, Journal
    from .utils.trace import GLOBAL

    try:
        config = SimonConfig.from_file(args.simon_config)
        applier = Applier(config, use_greed=args.use_greed, device=args.device)
        cluster = applier.load_cluster()
        apps = applier.load_apps()
        new_node = applier.load_new_node()
        taints = [_parse_taint(t) for t in args.taint or []]
        degrade = _parse_degrade(args.degrade) if args.degrade else None
        cordon = [n for n in (args.cordon or "").split(",") if n]
    except (OSError, ValueError, ExternalIOError, OutOfSliceError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    journal = None
    GLOBAL.reset()
    try:
        if args.resume or args.journal:
            fp = plan_fingerprint(
                cluster, apps, new_node, command="chaos", use_greed=args.use_greed,
                failures=args.failures, seed=args.seed, trials=args.trials,
                new_node_count=args.new_node_count, cordon=cordon, taints=taints,
                degrade=degrade,
            )
            journal = (Journal.resume(args.resume, fp) if args.resume
                       else Journal.open(args.journal, fp))
        # expansion names pods from a process-global counter; reset so
        # repeated in-process runs (and the perturbed re-encoding below)
        # expand the identical pod sequence
        reset_name_counter()
        if args.new_node_count is not None:
            count = args.new_node_count
            if count < 0:
                raise InputError("--new-node-count must be >= 0")
            if count > 0 and new_node is None:
                raise InputError(
                    f"--new-node-count {count} needs a newNode spec in "
                    "the config, which has none"
                )
            sweep = CapacitySweep(cluster, apps, new_node, count,
                                  use_greed=args.use_greed, device=args.device)
            if journal is not None:
                sweep.attach_journal(journal)
            baseline = sweep.probe(count).placements
        else:
            # plan first: the chaos sweep evaluates the committed plan
            max_count = 0 if new_node is None else MAX_NUM_NEW_NODE
            sweep = CapacitySweep(cluster, apps, new_node, max_count,
                                  use_greed=args.use_greed, device=args.device)
            if journal is not None:
                sweep.attach_journal(journal)
            feasible, (mc, mm, mv) = _capacity_feasible()
            best = sweep.find_min_count(feasible, start=sweep.lower_bound(mc, mm, mv))
            if best is None:
                print(
                    "error: no feasible plan to inject faults into "
                    f"(infeasible even with {max_count} new node(s)); "
                    "pass --new-node-count to analyze an infeasible "
                    "placement anyway",
                    file=sys.stderr,
                )
                return 1
            count, baseline = best.count, best.placements
        scen_sweep = perturbed_scenario_sweep(
            cluster, apps, new_node, sweep.max_count, cordon=cordon, taints=taints,
            degrade=degrade, use_greed=args.use_greed, device=args.device,
        )
        engine = ChaosEngine(sweep, count, baseline, scenario_sweep=scen_sweep)
        report = engine.run(failures=args.failures, seed=args.seed, trials=args.trials,
                            journal=journal)
    except PrioritySignalError as e:
        print(f"error: chaos analysis needs the batched scan path: {e}", file=sys.stderr)
        return 2
    except (OSError, InputError, ExternalIOError, NoCardError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    finally:
        if journal is not None:
            journal.close()
    if args.trace:
        print(GLOBAL.as_json(), file=sys.stderr)
    if args.format == "json":
        print(json.dumps(report.as_dict()))
    else:
        print(report.render_text())
    return 0 if report.all_survived else 1


def cmd_defrag(args) -> int:
    """Pod-migration plan from a cluster snapshot (parallel/defrag.py)."""
    import json

    from .ops.fused_scan import NoCardError
    from .parallel.defrag import plan_defrag
    from .scheduler.snapshot import load_snapshot

    try:
        snapshot = load_snapshot(args.snapshot)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    protect = None
    if args.keep_new_nodes:
        from .models.workloads import LABEL_NEW_NODE

        def protect(node):
            return LABEL_NEW_NODE in ((node.get("metadata") or {}).get("labels") or {})

    try:
        plan = plan_defrag(snapshot, max_drain=args.max_drain, protect=protect,
                           device=args.device)
    except NoCardError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.trace:
        from .utils.trace import GLOBAL

        print(GLOBAL.as_json(), file=sys.stderr)
    if args.format == "json":
        payload = {
            "drainOrder": plan.ranked_nodes,
            "chosenDepth": plan.chosen_depth,
            "drainedNodes": plan.drained_nodes,
            "unscheduledByDepth": [int(x) for x in plan.unscheduled],
            "moves": [
                {
                    "namespace": (m.pod.get("metadata") or {}).get("namespace"),
                    "pod": (m.pod.get("metadata") or {}).get("name"),
                    "from": m.from_node,
                    "to": m.to_node,
                }
                for m in plan.moves
            ],
        }
        print(json.dumps(payload))
        return 0
    if plan.chosen_depth == 0:
        print("no node can be fully drained")
        return 0
    print(f"drainable nodes ({plan.chosen_depth}): {', '.join(plan.drained_nodes)}")
    print(f"migrations required: {len(plan.moves)}")
    from .apply.report import render_table

    rows = [
        [
            (m.pod.get("metadata") or {}).get("namespace", ""),
            (m.pod.get("metadata") or {}).get("name", ""),
            m.from_node,
            m.to_node,
        ]
        for m in plan.moves
    ]
    print(render_table(["Namespace", "Pod", "From", "To"], rows))
    return 0


def _result_json(result) -> str:
    """Structured results (SURVEY.md §5: structured results + optional
    table renderer instead of ASCII-only), the JAX package's
    `_result_json` without its --explain block."""
    import json

    from .models.workloads import LABEL_NEW_NODE

    out = {
        "success": result.success,
        "newNodeCount": result.new_node_count,
        "message": result.message,
        "nodes": [],
        "unscheduledPods": [],
    }
    if result.result is not None:
        for ns in result.result.node_status:
            meta = ns.node.get("metadata") or {}
            out["nodes"].append(
                {
                    "name": meta.get("name"),
                    "newNode": LABEL_NEW_NODE in (meta.get("labels") or {}),
                    "pods": [
                        {
                            "namespace": (p.get("metadata") or {}).get("namespace"),
                            "name": (p.get("metadata") or {}).get("name"),
                            "app": ((p.get("metadata") or {}).get("labels") or {}).get(
                                "simon/app-name"
                            ),
                        }
                        for p in ns.pods
                    ],
                }
            )
        for up in result.result.unscheduled_pods:
            meta = up.pod.get("metadata") or {}
            out["unscheduledPods"].append(
                {
                    "namespace": meta.get("namespace"),
                    "name": meta.get("name"),
                    "reason": up.reason,
                }
            )
    return json.dumps(out)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="simon", description="cluster simulator on PyTorch and CUDA"
    )
    sub = parser.add_subparsers(dest="command")

    p_apply = sub.add_parser("apply", help="simulate deploying applications")
    p_apply.add_argument("-f", "--simon-config", required=True, help="simon config file path")
    p_apply.add_argument(
        "--extended-resources",
        type=lambda s: [x for x in s.split(",") if x],
        default=[],
        help="extended resource reports: gpu,open-local",
    )
    p_apply.add_argument(
        "--default-scheduler-config",
        default="",
        help="KubeSchedulerConfiguration file; its `extenders:` section is "
        "honored (HTTP filter/prioritize/bind callbacks; forces the serial "
        "engine). Dead option in the reference, functional here.",
    )
    p_apply.add_argument(
        "--use-greed",
        action="store_true",
        help="order pods by descending dominant-resource share (dead flag in the reference; functional here)",
    )
    p_apply.add_argument("--engine", choices=["cuda", "oracle"], default="cuda")
    _add_device_flag(p_apply)
    p_apply.add_argument(
        "--no-sweep", action="store_true", help="disable the batched capacity sweep"
    )
    p_apply.add_argument(
        "--tolerate-node-failures",
        type=int,
        default=0,
        metavar="K",
        help="raise the plan until it survives any K node failures (N+K; "
        "confirmed by a serial re-simulation of one sampled outage)",
    )
    p_apply.add_argument(
        "--chaos-seed", type=int, default=1,
        help="seed for the deterministic K-failure scenario sampling",
    )
    p_apply.add_argument(
        "--chaos-trials", type=int, default=32,
        help="sampled K-failure scenarios per escalation (K >= 2)",
    )
    _add_journal_flags(p_apply)
    p_apply.add_argument(
        "--format", choices=["table", "json"], default="table", help="result output format"
    )
    p_apply.add_argument(
        "--snapshot", default="", help="write the resulting cluster snapshot to this file"
    )
    _add_trace_flag(p_apply)
    p_apply.set_defaults(func=cmd_apply)

    p_defrag = sub.add_parser(
        "defrag", help="pod-migration defragmentation plan from a cluster snapshot"
    )
    p_defrag.add_argument(
        "--snapshot", required=True, help="snapshot file from `simon apply --snapshot`"
    )
    p_defrag.add_argument(
        "--max-drain", type=int, default=None,
        help="limit the number of nodes considered for draining",
    )
    p_defrag.add_argument(
        "--keep-new-nodes", action="store_true",
        help="exempt simon-added new nodes from draining",
    )
    p_defrag.add_argument(
        "--format", choices=["table", "json"], default="table", help="result output format"
    )
    _add_device_flag(p_defrag)
    _add_trace_flag(p_defrag)
    p_defrag.set_defaults(func=cmd_defrag)

    p_chaos = sub.add_parser(
        "chaos",
        help="fault-injection survivability report for a committed plan",
        description="Plan (or take --new-node-count as committed), then "
        "evaluate node-outage scenarios against the committed placement: "
        "surviving pods stay put, displaced pods reschedule on the "
        "residual capacity, and the report states which pods fail to "
        "reschedule and why. Exit 0 when every scenario survives, 1 "
        "otherwise.",
    )
    p_chaos.add_argument("-f", "--simon-config", required=True, help="simon config file path")
    p_chaos.add_argument(
        "--failures", type=int, default=1, metavar="K",
        help="simultaneous node failures: 1 = exhaustive singles; K >= 2 "
        "adds seeded-sampled K-subsets; 0 = replacement study (no outage)",
    )
    p_chaos.add_argument(
        "--seed", type=int, default=1, help="scenario-sampling seed (deterministic)"
    )
    p_chaos.add_argument(
        "--trials", type=int, default=32, help="sampled K-subset scenarios (K >= 2)"
    )
    p_chaos.add_argument(
        "--new-node-count", type=int, default=None, metavar="N",
        help="treat N new nodes as the committed plan instead of planning first",
    )
    p_chaos.add_argument(
        "--cordon", default="", metavar="NODE[,NODE]",
        help="evaluate scenarios with these nodes cordoned (unschedulable "
        "for rescheduling; their pods stay)",
    )
    p_chaos.add_argument(
        "--taint", action="append", metavar="key[=value]:Effect[@node1,node2]",
        help="evaluate scenarios with this taint applied (repeatable; no "
        "@nodes = every cluster node)",
    )
    p_chaos.add_argument(
        "--degrade", default="", metavar="PCT[@node1,node2]",
        help="evaluate scenarios with allocatable cpu/memory reduced PCT%% "
        "on the named nodes (default all)",
    )
    p_chaos.add_argument("--use-greed", action="store_true", help=argparse.SUPPRESS)
    _add_journal_flags(p_chaos)
    _add_device_flag(p_chaos)
    p_chaos.add_argument(
        "--format", choices=["table", "json"], default="table", help="result output format"
    )
    _add_trace_flag(p_chaos)
    p_chaos.set_defaults(func=cmd_chaos)
    return parser


def _add_device_flag(p: argparse.ArgumentParser):
    p.add_argument(
        "--device",
        default=None,
        help="torch device of the scans (default: the CUDA card; `cpu` runs "
        "the kernels' plain PyTorch versions)",
    )


def _add_trace_flag(p: argparse.ArgumentParser):
    p.add_argument(
        "--trace", action="store_true", help="print per-phase wall-clock JSON to stderr"
    )


def _add_journal_flags(p: argparse.ArgumentParser):
    p.add_argument(
        "--journal", default="", metavar="PATH",
        help="append completed probe results and scenario verdicts to "
        "this crash-safe JSONL journal (created when missing, continued "
        "when it matches this run's config fingerprint)",
    )
    p.add_argument(
        "--resume", default="", metavar="PATH",
        help="resume from a journal written by --journal: validates the "
        "config fingerprint (mismatch refuses loudly), replays complete "
        "records, re-executes zero journaled work, and keeps appending",
    )


def main(argv=None) -> int:
    _setup_logging()
    parser = build_parser()
    args = parser.parse_args(argv)
    if not getattr(args, "func", None):
        parser.print_help()
        return 0
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
