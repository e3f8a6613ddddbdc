"""simon-compatible CLI of the GPU port: `apply`, `chaos`, `defrag`,
`shadow`, `timeline`, `serve`, `fleet`, `twin`, `top`, `doctor`,
`version` and `gen-doc`.

  python -m open_simulator_tpu_torch.cli apply -f <simon-config.yaml> [-i]
        [--format table|json] [--extended-resources gpu,open-local]
        [--engine cuda|oracle] [--device DEVICE] [--no-sweep]
        [--use-greed] [--default-scheduler-config FILE] [--trace]
        [--tolerate-node-failures K [--chaos-seed S] [--chaos-trials T]]
        [--journal PATH | --resume PATH] [--snapshot FILE]
        [--deadline SECONDS] [--inject SPEC]
        [--trace-out PATH] [--explain [POD]] [--profile-dir DIR]
  python -m open_simulator_tpu_torch.cli chaos -f <simon-config.yaml>
        [--failures K] [--seed S] [--trials T] [--new-node-count N]
        [--cordon NODE,...] [--taint key[=value]:Effect[@nodes]]
        [--degrade PCT[@nodes]] [--journal PATH | --resume PATH]
        [--deadline SECONDS] [--inject SPEC]
        [--trace-out PATH] [--explain [POD]] [--profile-dir DIR]
        [--format table|json] [--device DEVICE] [--trace]
  python -m open_simulator_tpu_torch.cli defrag --snapshot FILE
        [--max-drain N] [--keep-new-nodes] [--format table|json]
        [--device DEVICE] [--trace-out PATH] [--explain [POD]]
        [--profile-dir DIR]
  python -m open_simulator_tpu_torch.cli shadow -f <simon-config.yaml>
        (--record PATH | --decision-log PATH | --tail [--tail-record PATH])
        [--engine cuda|oracle] [--device DEVICE] [--deadline SECONDS]
        [--inject SPEC] [--trace-out PATH] [--explain [POD]]
        [--profile-dir DIR] [--format table|json]
  python -m open_simulator_tpu_torch.cli timeline -f <simon-config.yaml>
        (--synthetic N | --trace PATH | --from-decision-log PATH)
        [--policy SPEC]... [--compare SPEC,...] [--cadence S] [--warmup S]
        [--max-nodes K] [--window-arrivals N] [--save-trace PATH]
        [--engine cuda|oracle] [--device DEVICE]
        [--journal PATH | --resume PATH] [--deadline SECONDS]
        [--inject SPEC] [--trace-out PATH] [--explain [POD]]
        [--profile-dir DIR] [--format table|json] [--trace-phases]
  python -m open_simulator_tpu_torch.cli serve -f <simon-config.yaml>
        [--host H] [--port P] [--max-batch B] [--queue-depth N]
        [--default-deadline S] [--drain-timeout S] [--no-warm]
        [--tick-budget S] [--max-request-pods N] [--max-sessions N]
        [--snapshot PATH [--replay-snapshot] [--checkpoint-interval N]
        [--keep-checkpoints N]] [--aot-store DIR]
        [--no-incremental] [--device DEVICE] [--inject SPEC]
        [--trace-out PATH] [--explain [POD]] [--profile-dir DIR]
        [--slo-config PATH] [--obs-cadence S]
  python -m open_simulator_tpu_torch.cli fleet -f <simon-config.yaml>
        [--replicas N] [--host H] [--port P] [--fleet-dir DIR]
        [--probe-interval S] [--probe-timeout S] [--drain-timeout S]
        [--spawn-attempts N] [--max-batch B] [--queue-depth N]
        [--default-deadline S] [--tick-budget S] [--no-incremental]
        [--checkpoint-interval N] [--keep-checkpoints N]
        [--audit-log PATH | --no-audit-log] [--aot-store DIR]
        [--device DEVICE] [--inject SPEC] [--trace-out PATH]
        [--explain [POD]] [--profile-dir DIR] [--slo-config PATH]
        [--obs-cadence S]
  python -m open_simulator_tpu_torch.cli twin -f <simon-config.yaml>
        (--feed LOG [--feed-batch N] | --tail) [--engine cuda|oracle]
        [--device DEVICE] [--host H] [--port P] [--poll-interval S]
        [--max-polls N] [--max-catchup N] [--tick-budget S]
        [--max-request-pods N] [--drain-timeout S] [--breaker-cooldown S]
        [--snapshot PATH [--replay-snapshot] [--checkpoint-interval N]
        [--keep-checkpoints N]] [--aot-store DIR] [--inject SPEC]
        [--trace-out PATH] [--explain [POD]] [--profile-dir DIR]
        [--slo-config PATH] [--obs-cadence S]
  python -m open_simulator_tpu_torch.cli top [--url URL | --host H --port P]
        [--interval S] [--window S] [--series NAME]... [--fleet] [--once]
        [--timeout S] [--format text|json]
  python -m open_simulator_tpu_torch.cli doctor BASELINE CANDIDATE
  python -m open_simulator_tpu_torch.cli version
  python -m open_simulator_tpu_torch.cli gen-doc [--output DIR]

Mirrors the JAX package's CLI (cli.py cmd_apply, cmd_chaos, cmd_defrag,
cmd_shadow, cmd_timeline, cmd_serve, cmd_fleet, cmd_twin, cmd_top, cmd_doctor,
cmd_version, cmd_gen_doc), whose
reports these reproduce byte for byte, its exit codes included: 3 for a
--deadline partial report, 4 for an interrupted one, 2 for bad input or
a failed external dependency. The scans run on the card unless
`--device cpu` is given (the kernels' plain versions); without a card
the default exits 2 with the "needs a GPU" error (`shadow --record` and
`shadow --engine oracle` run no device work and need no card). The
engines are `cuda|oracle` where the JAX package says `tpu|oracle`, and
reports name them so; the shadow report counts the port's launches and
nvcc builds where the JAX one counts XLA dispatches and recompiles.
`--inject` sites keep the JAX package's names (obs/profile.py). Log
level comes from the LogLevel env var (cmd/simon/simon.go:60-80).

`serve` and `twin` answer the JAX daemons' bodies; their `/metrics`
count the port's launches, nvcc builds and cost records where the JAX
ones count dispatches, recompiles and compiled costs. `--aot-store DIR`
(or SIMON_AOT_STORE) keeps the built kernel libraries in a
content-addressed store (incremental/store.py): a daemon started on a
warm store runs no nvcc. `fleet` supervises N port `serve` replicas
behind a consistent-hash router (fleet/): they share one such store
under `--fleet-dir`, so only the first replica builds, and a replica
killed with SIGKILL is respawned into its slot and replays its journal.
`top` is a client of a running daemon (`--fleet`: of a fleet router)
and does no device work.

`--mesh auto|off|N` on `apply`, `chaos` and `timeline` (the SIMON_MESH
environment variable for every command) splits batched scans over the
local CUDA devices (parallel/mesh.py): `auto` is every card, `N` the
first N; a count beyond the cards there are exits 2.
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


def _obs_begin(args):
    """Arm the flight recorder (obs/) from the shared observability
    flags (--trace-out / --explain / --profile-dir). Returns a finish
    callback that exports the trace and disarms, called from
    _with_obs's finally so every exit path exports."""
    from .obs import profile as obs_profile
    from .obs import spans
    from .obs.explain import EXPLAIN

    trace_out = getattr(args, "trace_out", "")
    explain = getattr(args, "explain", None)
    profile_dir = getattr(args, "profile_dir", "")
    if profile_dir:
        obs_profile.set_profile_dir(profile_dir)
    if trace_out:
        sink = spans.JsonlSink(trace_out) if trace_out.endswith(".jsonl") else None
        spans.RECORDER.enable(sink)
    if explain is not None:
        EXPLAIN.enable(explain or None)

    def finish():
        if trace_out:
            if not trace_out.endswith(".jsonl"):
                spans.export_chrome_trace(trace_out)
            dropped = spans.RECORDER.dropped
            spans.RECORDER.disable()
            note = f" ({dropped} span(s) dropped at cap)" if dropped else ""
            print(f"span trace written to {trace_out}{note}", file=sys.stderr)
        if explain is not None:
            EXPLAIN.disable()
        if profile_dir:
            obs_profile.set_profile_dir(None)
            print(f"torch.profiler capture(s) in {profile_dir}", file=sys.stderr)

    return finish


def _with_obs(name: str):
    """Decorator for the long-running commands: arm the recorder from
    the obs flags, run the command under a root span (`simon <name>`:
    phases and launches nest under it), export on ANY exit."""

    def deco(fn):
        import functools

        @functools.wraps(fn)
        def wrapper(args):
            from .obs.spans import RECORDER

            finish = _obs_begin(args)
            try:
                with RECORDER.span(f"simon {name}", command=name):
                    return fn(args)
            finally:
                finish()

        return wrapper

    return deco


def _print_explanations(args, out=None):
    """Append the --explain block to the human-readable output."""
    if getattr(args, "explain", None) is None:
        return
    from .obs.explain import render_explanations

    print(render_explanations(), file=out)


def _explanations_payload(args):
    """The --explain block for JSON output (None when off)."""
    if getattr(args, "explain", None) is None:
        return None
    from .obs.explain import explanations_dict

    return explanations_dict()


def _emit_partial(e, args, journal_path: str) -> int:
    """Render an ExecutionHalted (deadline / SIGINT at a safe boundary)
    as a well-formed machine-readable partial report, never a
    traceback, and return its distinct exit code (runtime/errors.py:
    3 deadline, 4 interrupt)."""
    import json

    payload = {
        "partial": True,
        "reason": e.reason,
        "message": str(e),
        "exitCode": e.exit_code,
        "journal": journal_path or None,
        "detail": e.partial,
    }
    if getattr(args, "format", "table") == "json":
        print(json.dumps(payload))
    else:
        print(f"PARTIAL RESULT ({e.reason}): {e}")
        if journal_path:
            print(
                f"completed work journaled in {journal_path}; rerun with "
                f"--resume {journal_path} to continue"
            )
        if e.partial is not None:
            print(json.dumps(e.partial, indent=2))
    return e.exit_code


@_with_obs("apply")
def cmd_apply(args) -> int:
    from .apply.applier import Applier, SimonConfig
    from .models.validation import InputError
    from .ops.fused_scan import NoCardError, OutOfSliceError
    from .runtime import (
        Budget,
        ExecutionHalted,
        ExternalIOError,
        Interrupted,
        sigint_to_budget,
    )
    from .utils.trace import ProfileCaptureError

    try:
        _configure_mesh(args)
        if args.interactive and args.deadline is not None:
            raise InputError(
                "--deadline is not available in interactive mode (the "
                "shell blocks on user input; press ^C to leave it)"
            )
        config = SimonConfig.from_file(args.simon_config)
        applier = Applier(
            config,
            interactive=args.interactive,
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
        budget = Budget(args.deadline)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    journal_path = args.resume or args.journal
    try:
        if args.interactive:
            # the reference's survey shell (apply.go:157-239, 510-530).
            # NOT budget-guarded: the shell blocks on stdin, so ^C must
            # interrupt at once (KeyboardInterrupt below)
            from .apply.interactive import run_interactive

            result = run_interactive(applier)
        else:
            with sigint_to_budget(budget):
                result = applier.run(budget=budget)
    except ExecutionHalted as e:
        return _emit_partial(e, args, journal_path)
    except KeyboardInterrupt:
        # SIGINT outside a guarded boundary (interactive shell, or
        # during load): still a clean partial exit, nothing to report
        return _emit_partial(
            Interrupted("interrupted before any safe boundary"), args, journal_path)
    except (OSError, InputError, ExternalIOError, OutOfSliceError, NoCardError,
            ProfileCaptureError) as e:
        # malformed input, a failed external dependency (apiserver,
        # credential plugin, extender), a feature the port does not
        # carry yet, no card for the default device, or a profiler
        # that cannot trace the card: a clean exit 2; internal errors
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
        print(_result_json(result, explain=_explanations_payload(args)))
        return 0 if result.success else 1
    if not result.success:
        print(result.message)
        if result.result is not None:
            for i, up in enumerate(result.result.unscheduled_pods):
                meta = up.pod.get("metadata") or {}
                print(f"{i:4d} {meta.get('namespace')}/{meta.get('name')}: {up.reason}")
        _print_explanations(args)
        return 1
    print("Simulation success!")
    if result.new_node_count:
        print(f"new nodes added: {result.new_node_count}")
    print(result.report_text)
    _print_explanations(args)
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


@_with_obs("chaos")
def cmd_chaos(args) -> int:
    """Fault-injection survivability of a committed plan
    (resilience/chaos.py): exit 0 when every scenario survives, 1
    otherwise, 2 on bad input, 3 / 4 on a deadline / interrupt partial
    report."""
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
    from .runtime import (
        Budget,
        ExecutionHalted,
        ExternalIOError,
        Interrupted,
        Journal,
        sigint_to_budget,
    )
    from .utils.trace import GLOBAL, ProfileCaptureError

    try:
        _configure_mesh(args)
        config = SimonConfig.from_file(args.simon_config)
        applier = Applier(config, use_greed=args.use_greed, device=args.device)
        cluster = applier.load_cluster()
        apps = applier.load_apps()
        new_node = applier.load_new_node()
        taints = [_parse_taint(t) for t in args.taint or []]
        degrade = _parse_degrade(args.degrade) if args.degrade else None
        cordon = [n for n in (args.cordon or "").split(",") if n]
        budget = Budget(args.deadline)
    except (OSError, ValueError, ExternalIOError, OutOfSliceError) as e:
        # ExternalIOError: a live-cluster import (kubeConfig) whose
        # apiserver or credential plugin failed after retries
        print(f"error: {e}", file=sys.stderr)
        return 2

    journal = None
    journal_path = args.resume or args.journal
    GLOBAL.reset()
    try:
        if journal_path:
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
        with sigint_to_budget(budget):
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
                best = sweep.find_min_count(
                    feasible, start=sweep.lower_bound(mc, mm, mv), budget=budget)
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
                                budget=budget, journal=journal)
    except ExecutionHalted as e:
        return _emit_partial(e, args, journal_path)
    except KeyboardInterrupt:
        return _emit_partial(
            Interrupted("interrupted before any safe boundary"), args, journal_path)
    except PrioritySignalError as e:
        print(f"error: chaos analysis needs the batched scan path: {e}", file=sys.stderr)
        return 2
    except (OSError, InputError, ExternalIOError, NoCardError, ProfileCaptureError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    finally:
        if journal is not None:
            journal.close()
    if args.trace:
        print(GLOBAL.as_json(), file=sys.stderr)
    if args.format == "json":
        payload = report.as_dict()
        explain = _explanations_payload(args)
        if explain is not None:
            payload["explain"] = explain
        print(json.dumps(payload))
    else:
        print(report.render_text())
        _print_explanations(args)
    return 0 if report.all_survived else 1


@_with_obs("defrag")
def cmd_defrag(args) -> int:
    """Pod-migration plan from a cluster snapshot (parallel/defrag.py)."""
    import json

    from .ops.fused_scan import NoCardError
    from .parallel.defrag import plan_defrag
    from .scheduler.snapshot import load_snapshot
    from .utils.trace import ProfileCaptureError

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
    except (NoCardError, ProfileCaptureError) as e:
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
        explain = _explanations_payload(args)
        if explain is not None:
            payload["explain"] = explain
        print(json.dumps(payload))
        return 0
    if plan.chosen_depth == 0:
        print("no node can be fully drained")
        _print_explanations(args)
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
    _print_explanations(args)
    return 0


@_with_obs("shadow")
def cmd_shadow(args) -> int:
    """Shadow-scheduler divergence auditor (shadow/): record simon's own
    decisions as a log, replay a recorded log of real scheduler
    decisions against the config's cluster, or tail a live cluster —
    and explain every disagreement. Exit 0 on full agreement, 1 when
    divergences were found, 2 on input errors (and without a card for
    the cuda engine), 3/4 on deadline/interrupt partials."""
    import json

    from .apply.applier import Applier, SimonConfig
    from .models.validation import InputError
    from .ops.fused_scan import NoCardError
    from .runtime import (
        Budget,
        ExecutionHalted,
        ExternalIOError,
        Interrupted,
        sigint_to_budget,
    )
    from .shadow.log import DecisionLogWriter, cluster_fingerprint, read_decision_log
    from .shadow.record import record_simulation
    from .shadow.replay import ShadowReplayer
    from .utils.trace import ProfileCaptureError

    try:
        modes = sum(bool(m) for m in (args.record, args.decision_log, args.tail))
        if modes != 1:
            raise InputError(
                "pick exactly one mode: --record PATH (write simon's own "
                "decisions), --decision-log PATH (replay a recorded log), "
                "or --tail (poll the config's live cluster)"
            )
        config = SimonConfig.from_file(args.simon_config)
        applier = Applier(config)
        budget = Budget(args.deadline)
        if args.tail and not config.kube_config:
            raise InputError(
                "--tail needs a kubeConfig cluster in the simon config "
                "(customConfig clusters have no scheduler to shadow)"
            )
        if args.max_catchup < 1:
            raise InputError(
                "--max-catchup must be >= 1 (0 would never replay the "
                "backlog and the mirror would stop advancing)"
            )
    except (OSError, ValueError, InputError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    try:
        with sigint_to_budget(budget):
            if args.record:
                cluster = applier.load_cluster()
                apps = applier.load_apps()
                steps = []
                try:
                    record_simulation(
                        cluster, apps, budget=budget, steps_out=steps
                    )
                except ExecutionHalted as e:
                    # a deadline/SIGINT still writes the completed
                    # prefix — a valid, replayable log — and reports it
                    if steps:
                        with DecisionLogWriter(
                            args.record, cluster_fingerprint(cluster)
                        ) as w:
                            for s in steps:
                                w.append(s)
                    e.partial = {
                        "recordedSteps": len(steps),
                        "decisionLog": args.record if steps else None,
                    }
                    raise
                decisions = sum(1 for s in steps if s.kind == "decision")
                scheduled = sum(
                    1 for s in steps if s.kind == "decision" and s.node
                )
                with DecisionLogWriter(
                    args.record, cluster_fingerprint(cluster)
                ) as w:
                    for s in steps:
                        w.append(s)
                print(
                    f"recorded {decisions} decision(s) ({scheduled} "
                    f"scheduled, {decisions - scheduled} failed) across "
                    f"{len(steps)} step(s) to {args.record}"
                )
                return 0
            if args.decision_log:
                cluster = applier.load_cluster()
                fp = cluster_fingerprint(cluster)
                steps, meta = read_decision_log(
                    args.decision_log,
                    fingerprint=None
                    if args.allow_fingerprint_mismatch
                    else fp,
                )
                replayer = ShadowReplayer(cluster, engine=args.engine,
                                          device=args.device)
                replayer.report.dropped_records = meta.get("dropped", 0)
                try:
                    report = replayer.run(steps, budget=budget)
                except ExecutionHalted as e:
                    # the audit so far IS the partial result
                    e.partial = {"shadow": replayer.finish().as_dict()}
                    raise
            else:  # --tail
                report = _shadow_tail(args, config, budget)
    except ExecutionHalted as e:
        return _emit_partial(e, args, "")
    except KeyboardInterrupt:
        return _emit_partial(
            Interrupted("interrupted before any safe boundary"), args, ""
        )
    except (OSError, InputError, ExternalIOError, NoCardError, ProfileCaptureError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.format == "json":
        payload = report.as_dict()
        explain = _explanations_payload(args)
        if explain is not None:
            payload["explain"] = explain
        print(json.dumps(payload, sort_keys=True))
    else:
        print(report.render_text())
        _print_explanations(args)
    return 0 if report.divergence_count == 0 else 1


def _shadow_tail(args, config, budget):
    """Live shadow loop: bootstrap the mirror from the first LIST, then
    poll-diff-replay until --max-polls / --max-steps / deadline.

    Resident-service hardening: the apiserver's circuit breaker gets a
    recovery cooldown (--breaker-cooldown), a failed poll counts a flap
    and the loop BACKS OFF and continues instead of aborting the audit,
    and a recovered flap's backlog replays at most --max-catchup steps
    per round (bounded catch-up: the mirror converges without one giant
    stop-the-world replay)."""
    import collections
    import time

    from .models.decode import ResourceTypes
    from .models.kubeclient import KubeClient
    from .runtime import ExecutionHalted, ExternalIOError
    from .runtime import inject as _inject
    from .runtime.retry import backoff_delay, enable_breaker_recovery
    from .shadow.ingest import ClusterTailer
    from .shadow.log import DecisionLogWriter, cluster_fingerprint
    from .shadow.replay import ShadowReplayer
    from .utils.trace import COUNTERS, GLOBAL

    if args.breaker_cooldown and args.breaker_cooldown > 0:
        enable_breaker_recovery(args.breaker_cooldown)
    with KubeClient(config.kube_config) as client:
        tailer = ClusterTailer(client)
        nodes, boot_steps = tailer.bootstrap()
        cluster = ResourceTypes()
        cluster.nodes = nodes
        replayer = ShadowReplayer(cluster, engine=args.engine, device=args.device)
        writer = None
        if args.tail_record:
            writer = DecisionLogWriter(
                args.tail_record, cluster_fingerprint(cluster)
            )
        pending = collections.deque()  # observed, not yet replayed

        def apply_step(st):
            if writer is not None:
                writer.append(st)
            replayer.step(st)

        try:
            for st in boot_steps:
                apply_step(st)
            polls = flaps = 0
            while True:
                if budget is not None:
                    budget.check(f"shadow tail (poll {polls})")
                if args.max_polls is not None and polls >= args.max_polls:
                    break
                if (
                    args.max_steps is not None
                    and replayer.report.decisions >= args.max_steps
                ):
                    break
                if polls:
                    time.sleep(args.poll_interval)
                try:
                    # chaos seam: `shadow.poll` faults (reset/timeout/
                    # http:NNN/exio) land like a real apiserver flap
                    _inject.fire("shadow.poll", poll=polls)
                    pending.extend(tailer.poll())
                except (ExternalIOError, OSError) as e:
                    # apiserver flap: count it, note it, back off
                    # (bounded, deterministic), keep the audit alive —
                    # the breaker behind tailer.poll() fails further
                    # calls fast until its cooldown elapses
                    flaps += 1
                    COUNTERS.inc("shadow_tail_flaps_total")
                    GLOBAL.append_note(
                        "shadow-tail-flap",
                        f"poll {polls}: {str(e)[:100]}",
                    )
                    logging.warning(
                        "shadow tail poll failed (%s); continuing", e
                    )
                    time.sleep(
                        min(backoff_delay("shadow-tail", min(flaps, 6)),
                            args.poll_interval)
                    )
                else:
                    flaps = 0
                # bounded catch-up: a big post-flap diff replays across
                # rounds; the backlog depth is observable
                applied = 0
                while pending and applied < args.max_catchup:
                    if budget is not None:
                        budget.check(f"shadow tail (poll {polls}, catch-up)")
                    apply_step(pending.popleft())
                    applied += 1
                if pending:
                    COUNTERS.inc("shadow_tail_deferred_steps_total", len(pending))
                    GLOBAL.append_note(
                        "shadow-tail-catchup",
                        f"poll {polls}: {applied} applied, "
                        f"{len(pending)} deferred to the next round",
                    )
                COUNTERS.gauge("shadow_tail_backlog", float(len(pending)))
                polls += 1
            # drain any deferred backlog before reporting: everything
            # observed is audited (budget still owns the halt) — but
            # --max-steps stays a hard cap: past it the remainder is
            # RECORDED (--tail-record holds every observed step), not
            # replayed, so a recovered flap's giant diff cannot blow
            # through the user's explicit bound
            while pending:
                if (
                    args.max_steps is not None
                    and replayer.report.decisions >= args.max_steps
                ):
                    if writer is not None:
                        for st in pending:
                            writer.append(st)
                    COUNTERS.inc(
                        "shadow_tail_deferred_steps_total", len(pending)
                    )
                    GLOBAL.append_note(
                        "shadow-tail-catchup",
                        f"final drain stopped at --max-steps "
                        f"{args.max_steps}; {len(pending)} observed "
                        "step(s) recorded but not audited",
                    )
                    pending.clear()
                    break
                if budget is not None:
                    budget.check("shadow tail (final catch-up)")
                apply_step(pending.popleft())
        except ExecutionHalted as e:
            # everything audited before the halt is the partial result
            # (the --tail-record log already holds the observed steps)
            e.partial = {"shadow": replayer.finish().as_dict()}
            raise
        finally:
            if writer is not None:
                writer.close()
    return replayer.finish()


@_with_obs("timeline")
def cmd_timeline(args) -> int:
    """Discrete-event cluster timeline (timeline/): play a trace of pod
    arrivals/departures, node churn, and spot reclamations through N
    autoscaler policies as batched scenario rows over one encoding, and
    emit per-step cost/utilization/pending curves per policy. Exit 0 on
    a completed run, 2 on input errors (and without a card unless
    `--device cpu`), 3/4 on deadline/interrupt partials."""
    import json

    from .apply.applier import Applier, SimonConfig
    from .models.validation import InputError
    from .ops.fused_scan import NoCardError, resolve_device
    from .parallel.sweep import PrioritySignalError
    from .runtime import (
        Budget,
        ExecutionHalted,
        ExternalIOError,
        Interrupted,
        Journal,
        sigint_to_budget,
    )
    from .runtime.journal import config_fingerprint
    from .timeline.autoscaler import parse_policies
    from .timeline.compare import run_policies
    from .timeline.events import (
        SyntheticSpec,
        events_from_decision_log,
        generate_synthetic,
        read_trace,
        trace_fingerprint,
        write_trace,
    )
    from .utils.trace import GLOBAL, ProfileCaptureError

    try:
        _configure_mesh(args)
        sources = sum(
            1 for m in (args.synthetic, args.trace, args.from_decision_log)
            if m
        )
        if sources != 1:
            raise InputError(
                "pick exactly one trace source: --synthetic N (seeded "
                "generator), --trace PATH (timeline-trace JSONL), or "
                "--from-decision-log PATH (shadow decision log)"
            )
        if args.synthetic < 0:
            raise InputError(
                f"--synthetic N must be >= 1, got {args.synthetic}"
            )
        config = SimonConfig.from_file(args.simon_config)
        applier = Applier(config)
        cluster = applier.load_cluster()
        new_node = applier.load_new_node()
        specs = list(args.policy or [])
        for group in args.compare or []:
            specs.extend(s for s in group.split(",") if s)
        policies = parse_policies(specs or ["threshold"])
        budget = Budget(args.deadline)

        if args.synthetic:
            node_names = [
                (n.get("metadata") or {}).get("name") or ""
                for n in cluster.nodes
            ]
            events = generate_synthetic(
                SyntheticSpec(
                    arrivals=args.synthetic,
                    arrival_rate=args.arrival_rate,
                    mean_lifetime_s=args.mean_lifetime,
                    long_running_frac=args.long_running_frac,
                    spot_frac=args.spot_frac,
                    spot_hazard=args.spot_hazard,
                    seed=args.seed,
                ),
                node_names,
            )
        elif args.trace:
            events, meta = read_trace(args.trace)
            if meta.get("dropped"):
                print(
                    f"note: dropped {meta['dropped']} torn trailing trace "
                    "record",
                    file=sys.stderr,
                )
        else:
            from .shadow.log import cluster_fingerprint, read_decision_log

            steps, _meta = read_decision_log(
                args.from_decision_log,
                fingerprint=None
                if args.allow_fingerprint_mismatch
                else cluster_fingerprint(cluster),
            )
            events = events_from_decision_log(steps)
        if args.save_trace:
            fp = write_trace(args.save_trace, events)
            print(
                f"timeline trace ({len(events)} events, fingerprint {fp}) "
                f"written to {args.save_trace}",
                file=sys.stderr,
            )
        # the windows' device, resolved before any work: the card unless
        # --device names another (no card exits 2, never the CPU)
        device = resolve_device(args.device)
    except (OSError, ValueError, ExternalIOError, NoCardError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    journal = None
    journal_path = args.resume or args.journal
    GLOBAL.reset()
    try:
        if journal_path:
            from .shadow.log import cluster_fingerprint

            # cluster + newNode identity MUST be in the fingerprint:
            # journaled placements are node indices of one encoding,
            # and replaying them against a different cluster would be
            # silently wrong (the plan_fingerprint rule in apply/chaos)
            fp = config_fingerprint(
                cluster_fingerprint(cluster),
                new_node,
                trace_fingerprint(events),
                [p.name for p in policies],
                {
                    "cadence": args.cadence,
                    "warmup": args.warmup,
                    "maxNodes": args.max_nodes,
                    "windowArrivals": args.window_arrivals,
                    "engine": args.engine,
                },
            )
            journal = (
                Journal.resume(args.resume, fp)
                if args.resume
                else Journal.open(args.journal, fp)
            )
        with sigint_to_budget(budget):
            comparison = run_policies(
                cluster,
                events,
                policies,
                new_node_spec=new_node,
                max_nodes=args.max_nodes,
                cadence_s=args.cadence,
                warmup_s=args.warmup,
                window_arrivals=args.window_arrivals,
                engine=args.engine,
                budget=budget,
                journal=journal,
                device=device,
            )
    except ExecutionHalted as e:
        return _emit_partial(e, args, journal_path)
    except KeyboardInterrupt:
        return _emit_partial(
            Interrupted("interrupted before any safe boundary"),
            args,
            journal_path,
        )
    except PrioritySignalError as e:
        print(
            f"error: the timeline needs the batched scan path: {e}",
            file=sys.stderr,
        )
        return 2
    except (OSError, InputError, ProfileCaptureError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    finally:
        if journal is not None:
            journal.close()
    if args.trace_phases:
        print(GLOBAL.as_json(), file=sys.stderr)
    if args.format == "json":
        payload = comparison.as_dict()
        explain = _explanations_payload(args)
        if explain is not None:
            payload["explain"] = explain
        print(json.dumps(payload))
    else:
        print(comparison.render_text())
        _print_explanations(args)
    return 0


@_with_obs("serve")
def cmd_serve(args) -> int:
    """Long-lived what-if daemon (serve/; docs/SERVING.md): load the
    cluster once, build and load the kernel library, coalesce concurrent
    POST /v1/simulate requests onto batch-kernel launches on the card.
    Exit 0 after a clean SIGTERM/SIGINT drain, 3 when --drain-timeout
    expired with requests still queued (shed), 2 on input errors and
    without a card unless `--device cpu` (all before listening)."""
    import json

    from .apply.applier import Applier, SimonConfig
    from .models.validation import InputError
    from .obs.spans import observatory_block
    from .obs.telemetry import arm_flight_recorder
    from .ops.fused_scan import NoCardError, resolve_device
    from .runtime import ExternalIOError
    from .runtime.retry import BREAKER_COOLDOWN_ENV, enable_breaker_recovery
    from .serve.server import ServeDaemon
    from .serve.session import Session

    try:
        # the card, or exit 2 before any work (never a move to the CPU)
        device = resolve_device(args.device)
        # flag validation up front: a bad value must exit 2 BEFORE
        # listening, never crash per request (docs/ROBUSTNESS.md)
        if args.default_deadline is not None and args.default_deadline <= 0:
            raise InputError("--default-deadline must be > 0 seconds")
        if args.drain_timeout < 0:
            raise InputError("--drain-timeout must be >= 0 seconds")
        if args.tick_budget is not None and args.tick_budget <= 0:
            raise InputError("--tick-budget must be > 0 seconds")
        if args.max_request_pods is not None and args.max_request_pods < 1:
            raise InputError("--max-request-pods must be >= 1")
        if args.max_sessions < 1:
            raise InputError("--max-sessions must be >= 1")
        if args.checkpoint_interval is not None and args.checkpoint_interval < 1:
            raise InputError("--checkpoint-interval must be >= 1 delta")
        if args.keep_checkpoints < 1:
            raise InputError("--keep-checkpoints must be >= 1")
        if args.checkpoint_interval and not args.snapshot:
            raise InputError("--checkpoint-interval requires --snapshot PATH")
        if args.replay_snapshot and not args.snapshot:
            raise InputError("--replay-snapshot requires --snapshot PATH")
        # declarative SLOs + telemetry cadence: a bad --slo-config or
        # --obs-cadence raises InputError here (the daemon constructor
        # validates the cadence) -> exit 2 before listening
        slo_engine = _build_slo_engine(args)
        # resident service: circuit breakers get a recovery cooldown so
        # an apiserver/extender flap degrades, not dooms, the daemon.
        # SIMON_BREAKER_COOLDOWN wins when set (0 restores the one-shot
        # stay-open posture); the 30s default applies only without it
        if not os.environ.get(BREAKER_COOLDOWN_ENV):
            enable_breaker_recovery(30.0)
        config = SimonConfig.from_file(args.simon_config)
        cluster = Applier(config, device=device).load_cluster()
        # the kernel-library store is armed before the first library
        # load (the committed scan, the warmup): a warm store then
        # serves every library and the daemon runs no nvcc
        _arm_store(args)
        session = Session(cluster, incremental=not args.no_incremental,
                          device=device)
        daemon = ServeDaemon(
            session,
            host=args.host,
            port=args.port,
            max_batch=args.max_batch,
            queue_depth=args.queue_depth,
            default_deadline_s=args.default_deadline,
            drain_timeout_s=args.drain_timeout,
            tick_budget_s=args.tick_budget,
            max_request_pods=args.max_request_pods,
            max_sessions=args.max_sessions,
            snapshot_path=args.snapshot or None,
            checkpoint_interval=args.checkpoint_interval,
            keep_checkpoints=args.keep_checkpoints,
            slo_engine=slo_engine,
            obs_cadence_s=args.obs_cadence,
        )
    except (OSError, ValueError, ExternalIOError, InputError, NoCardError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    # continuous flight recorder: the resident daemon records into a
    # bounded ring (overwrite-oldest, dropped counted) so /debug/dump
    # always has a recent span window — --trace-out still owns export
    arm_flight_recorder()
    if not args.no_warm:
        # one tiny request through the whole path before we listen: the
        # kernel library is built (nvcc, on a cold checkout and an empty
        # store) and loaded, the cluster encoded and the committed scan
        # resident
        session.warm()
    replay_summary = None
    if args.replay_snapshot and os.path.exists(args.snapshot):
        # failover bootstrap (fleet/replay.py): restore the newest
        # verified checkpoint and replay the journal's delta suffix the
        # dead daemon had absorbed BEFORE listening, so the first answer
        # comes from the same committed state. After warm(), in the JAX
        # package's order. Read-only here; the daemon resumes the same
        # journal for append (truncating any torn tail durably)
        from .fleet.replay import replay_into_session

        replay_summary = replay_into_session(session, args.snapshot)
        if daemon.checkpoints is not None and replay_summary["checkpoint"]:
            # the restored generation is current: the next checkpoint
            # is due one full interval PAST it, not immediately
            daemon.checkpoints.note_restored(
                replay_summary["checkpoint"]["deltaSeq"]
            )
    daemon.start()
    if replay_summary is not None:
        restored = replay_summary.get("checkpoint")
        if restored:
            logging.info(
                "restored checkpoint %s (deltaSeq=%d); %d absorbed "
                "journal record(s) skipped",
                restored["path"],
                restored["deltaSeq"],
                replay_summary["skippedPrefix"],
            )
        logging.info(
            "replayed %d cluster delta(s) from %s "
            "(applied=%d skipped=%d reloads=%d torn-tail-dropped=%d)",
            replay_summary["deltas"],
            args.snapshot,
            replay_summary["applied"],
            replay_summary["skipped"],
            replay_summary["reloads"],
            replay_summary["dropped"],
        )
    if session.force_serial_reason:
        logging.warning(
            "cluster cannot ride the batched scan (%s); every request "
            "will be answered serially",
            session.force_serial_reason,
        )
    # machine-parsable readiness line (tests read the bound port from
    # it — --port 0 binds an ephemeral one)
    print(
        f"simon serve listening on http://{daemon.host}:{daemon.port} "
        f"(cluster {session.fingerprint})",
        flush=True,
    )
    code = daemon.run_until_signaled()
    # observatory drain dump: one JSON line on stderr with the per-site
    # latency histograms, the memory ledger and the cost records — the
    # daemon's lifetime observability survives the process even when
    # nobody scraped /metrics (per-request output stays untouched)
    observatory = observatory_block()
    if observatory:
        print("simon serve observatory: " + json.dumps(observatory),
              file=sys.stderr)
    if args.explain is not None:
        # explanations accumulated across requests land on stderr at
        # drain (per-request output stays byte-identical to standalone
        # runs — the serve conformance contract)
        _print_explanations(args, out=sys.stderr)
    return code


@_with_obs("fleet")
def cmd_fleet(args) -> int:
    """N-replica serve fleet behind one consistent-hash router
    (fleet/; docs/FLEET.md): spawn N port `simon serve` replicas sharing
    one kernel-library store, route tenant-affine, probe /healthz, and
    fail over on replica death — the replacement resumes its slot's
    snapshot journal and replays the dead replica's delta stream,
    answering its first request with no nvcc build. The replicas run on
    the card unless `--device cpu` is given (passed through to each);
    without a card the fleet exits 2 before spawning. Exit 0 after a
    clean SIGTERM drain of every replica, 3 when one had to be killed,
    2 on input/startup errors."""
    from .fleet.replica import DoubleSpawnError, ReplicaProcess, serve_argv
    from .fleet.router import FleetRouter
    from .models.validation import InputError
    from .ops.fused_scan import resolve_device
    from .runtime.errors import GuardError

    replicas = []
    try:
        if args.replicas < 1:
            raise InputError("--replicas must be >= 1")
        if args.probe_interval <= 0:
            raise InputError("--probe-interval must be > 0 seconds")
        if args.probe_timeout <= 0:
            raise InputError("--probe-timeout must be > 0 seconds")
        if args.drain_timeout < 0:
            raise InputError("--drain-timeout must be >= 0 seconds")
        if args.spawn_attempts < 1:
            raise InputError("--spawn-attempts must be >= 1")
        if args.checkpoint_interval is not None and args.checkpoint_interval < 1:
            raise InputError("--checkpoint-interval must be >= 1 delta")
        if args.keep_checkpoints is not None and args.keep_checkpoints < 1:
            raise InputError("--keep-checkpoints must be >= 1")
        slo_engine = _build_slo_engine(args)
        if not os.path.isfile(args.simon_config):
            raise InputError(f"config file not found: {args.simon_config}")
        # the replicas' device, or exit 2 before any spawn (a replica
        # without its card would exit 2 too; nothing moves to the CPU)
        resolve_device(args.device)
        fleet_dir = os.path.abspath(args.fleet_dir)
        os.makedirs(fleet_dir, exist_ok=True)
        # replicas share ONE content-addressed kernel-library store: the
        # first spawn builds into it, every later spawn (and every
        # failover replacement) loads from it and runs no nvcc
        store = (
            os.path.abspath(args.aot_store)
            if args.aot_store
            else os.path.join(fleet_dir, "aot-store")
        )
        extra = []
        if args.max_batch is not None:
            extra += ["--max-batch", str(args.max_batch)]
        if args.queue_depth is not None:
            extra += ["--queue-depth", str(args.queue_depth)]
        if args.default_deadline is not None:
            extra += ["--default-deadline", str(args.default_deadline)]
        if args.tick_budget is not None:
            extra += ["--tick-budget", str(args.tick_budget)]
        if args.drain_timeout:
            extra += ["--drain-timeout", str(args.drain_timeout)]
        if args.no_incremental:
            extra += ["--no-incremental"]
        config_path = os.path.abspath(args.simon_config)
        for i in range(args.replicas):
            slot = f"r{i}"
            rep = ReplicaProcess(
                slot,
                [],  # argv bound below, once the snapshot path exists
                fleet_dir,
                probe_timeout_s=args.probe_timeout,
            )
            rep.argv = serve_argv(
                config_path,
                aot_store=store,
                snapshot_path=rep.snapshot_path,
                checkpoint_interval=args.checkpoint_interval,
                keep_checkpoints=args.keep_checkpoints,
                device=args.device,
                extra=extra,
            )
            replicas.append(rep)
        # first replica spawns alone (it runs the nvcc builds that fill
        # the shared store), the rest spawn concurrently and load
        replicas[0].spawn(attempts=args.spawn_attempts)
        if len(replicas) > 1:
            import threading

            errors = []

            def _spawn(rep):
                try:
                    rep.spawn(attempts=args.spawn_attempts)
                except Exception as e:  # noqa: BLE001 - re-raised below
                    errors.append((rep.slot, e))

            threads = [threading.Thread(target=_spawn, args=(r,)) for r in replicas[1:]]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                # surface the first concurrent-spawn failure with its
                # original (taxonomy-typed) class intact
                raise errors[0][1]
        # failover audit timeline (fleet/audit.py): fsync'd JSONL in
        # the fleet dir unless pointed elsewhere (or disabled)
        audit = None
        if not args.no_audit_log:
            from .fleet.audit import FailoverAudit

            audit = FailoverAudit(
                args.audit_log or os.path.join(fleet_dir, "failover-audit.jsonl")
            )
        router = FleetRouter(
            replicas,
            host=args.host,
            port=args.port,
            probe_interval_s=args.probe_interval,
            drain_timeout_s=args.drain_timeout,
            slo_engine=slo_engine,
            obs_cadence_s=args.obs_cadence,
            spawn_attempts=args.spawn_attempts,
            audit=audit,
        )
    except (OSError, ValueError, RuntimeError, GuardError, DoubleSpawnError,
            InputError) as e:
        print(f"error: {e}", file=sys.stderr)
        for rep in replicas:
            rep.kill()
            rep.release()
        return 2
    from .obs.telemetry import arm_flight_recorder

    arm_flight_recorder()
    router.start()
    # machine-parsable readiness line (tests read the bound port from
    # it — --port 0 binds an ephemeral one)
    print(
        f"simon fleet listening on http://{router.host}:{router.port} "
        f"({len(replicas)} replicas)",
        flush=True,
    )
    return router.run_until_signaled()


def _build_slo_engine(args):
    """--slo-config as an SLOEngine (None when unset). Raises InputError
    on a bad config; the caller's guarded setup block turns that into
    exit 2 before listening."""
    if not getattr(args, "slo_config", ""):
        return None
    from .obs.slo import SLOEngine, load_slo_config

    return SLOEngine(load_slo_config(args.slo_config))


@_with_obs("twin")
def cmd_twin(args) -> int:
    """Live digital-twin daemon (twin/; docs/TWIN.md): continuously
    mirror a cluster — a live apiserver tail (--tail) or a recorded
    decision-log feed (--feed) — on the cluster-delta substrate, audit
    every real scheduler decision against the warm mirror (one kernel
    launch a decision on the card), and answer what-if / drain-safety /
    N+K / capacity-forecast queries over HTTP against LIVE state. Exit 0
    after a clean SIGTERM/SIGINT drain, 2 on input errors and without a
    card for the cuda engine unless `--device cpu` (before listening)."""
    import json

    from .apply.applier import Applier, SimonConfig
    from .models.validation import InputError
    from .obs.spans import observatory_block
    from .obs.telemetry import arm_flight_recorder
    from .ops.fused_scan import NoCardError, resolve_device
    from .runtime import ExternalIOError
    from .runtime.retry import BREAKER_COOLDOWN_ENV, enable_breaker_recovery
    from .shadow.log import cluster_fingerprint, read_decision_log
    from .twin.mirror import (
        ClusterMirror,
        FeedSource,
        LiveSource,
        open_twin_snapshot,
        replay_mirror_journal,
    )
    from .twin.server import TwinDaemon

    client = None
    try:
        # the card for the cuda engine, or exit 2 before any work
        device = resolve_device(args.device) if args.engine == "cuda" else None
        modes = sum(bool(m) for m in (args.feed, args.tail))
        if modes != 1:
            raise InputError(
                "pick exactly one source: --feed LOG (tail a recorded "
                "decision log) or --tail (poll the config's live cluster)"
            )
        if args.poll_interval <= 0:
            raise InputError("--poll-interval must be > 0 seconds")
        if args.drain_timeout < 0:
            raise InputError("--drain-timeout must be >= 0 seconds")
        if args.tick_budget is not None and args.tick_budget <= 0:
            raise InputError("--tick-budget must be > 0 seconds")
        if args.max_request_pods is not None and args.max_request_pods < 1:
            raise InputError("--max-request-pods must be >= 1")
        if args.max_catchup < 1:
            raise InputError(
                "--max-catchup must be >= 1 (0 would never apply the "
                "backlog and the mirror would stop advancing)"
            )
        if args.replay_snapshot and not args.snapshot:
            raise InputError("--replay-snapshot requires --snapshot PATH")
        if args.checkpoint_interval is not None and args.checkpoint_interval < 1:
            raise InputError("--checkpoint-interval must be >= 1 step")
        if args.keep_checkpoints < 1:
            raise InputError("--keep-checkpoints must be >= 1")
        if args.checkpoint_interval and not args.snapshot:
            raise InputError("--checkpoint-interval requires --snapshot PATH")
        slo_engine = _build_slo_engine(args)
        # resident service: breakers recover (the serve posture)
        if args.breaker_cooldown and args.breaker_cooldown > 0:
            if not os.environ.get(BREAKER_COOLDOWN_ENV):
                enable_breaker_recovery(args.breaker_cooldown)
        config = SimonConfig.from_file(args.simon_config)
        applier = Applier(config)
        # arm the kernel-library store before the mirror's first probe
        # loads a library (a warm store: no nvcc, the serve posture)
        _arm_store(args)
        if args.feed:
            cluster = applier.load_cluster()
            fp = cluster_fingerprint(cluster)
            steps, _meta = read_decision_log(
                args.feed,
                fingerprint=None if args.allow_fingerprint_mismatch else fp,
            )
            source = FeedSource(steps, batch=args.feed_batch)
        else:  # --tail
            if not config.kube_config:
                raise InputError(
                    "--tail needs a kubeConfig cluster in the simon config "
                    "(customConfig clusters have no scheduler to mirror)"
                )
            from .models.decode import ResourceTypes
            from .models.kubeclient import KubeClient
            from .shadow.ingest import ClusterTailer

            client = KubeClient(config.kube_config)
            tailer = ClusterTailer(client)
            nodes, boot_steps = tailer.bootstrap()
            cluster = ResourceTypes()
            cluster.nodes = nodes
            source = LiveSource(tailer, boot_steps=boot_steps)
        mirror = ClusterMirror(
            cluster, source, engine=args.engine, max_catchup=args.max_catchup,
            device=device,
        )
        twin_replay = None
        if args.replay_snapshot and os.path.exists(args.snapshot):
            # before bootstrap and before the journal is attached, or
            # replayed steps would be journaled twice
            twin_replay = replay_mirror_journal(mirror, args.snapshot)
        mirror.bootstrap()
        if args.snapshot:
            # attach AFTER replay: replayed steps must not re-append
            mirror.journal = open_twin_snapshot(args.snapshot)
        daemon = TwinDaemon(
            mirror,
            host=args.host,
            port=args.port,
            poll_interval_s=args.poll_interval,
            max_polls=args.max_polls,
            tick_budget_s=args.tick_budget,
            max_request_pods=args.max_request_pods,
            drain_timeout_s=args.drain_timeout,
            slo_engine=slo_engine,
            obs_cadence_s=args.obs_cadence,
            snapshot_path=args.snapshot or None,
            checkpoint_interval=args.checkpoint_interval,
            keep_checkpoints=args.keep_checkpoints,
        )
        if daemon.checkpoints is not None and twin_replay and twin_replay.get(
            "checkpoint"
        ):
            daemon.checkpoints.note_restored(
                twin_replay["checkpoint"]["deltaSeq"]
            )
    except (OSError, ValueError, ExternalIOError, InputError, NoCardError) as e:
        if client is not None:
            client.close()
        print(f"error: {e}", file=sys.stderr)
        return 2
    arm_flight_recorder()
    daemon.start()
    # machine-parsable readiness line (tests read the bound port from
    # it — --port 0 binds an ephemeral one)
    print(
        f"simon twin listening on http://{daemon.host}:{daemon.port} "
        f"(mirroring {len(mirror.oracle.nodes)} node(s), "
        f"source {'feed' if args.feed else 'tail'})",
        flush=True,
    )
    if twin_replay is not None:
        ckpt = twin_replay.get("checkpoint")
        print(
            f"simon twin replay: {twin_replay['steps']} step(s) replayed, "
            f"{twin_replay['skippedPrefix']} absorbed by checkpoint "
            + (
                f"(restored seq {ckpt['deltaSeq']} from {ckpt['path']})"
                if ckpt
                else "(no usable checkpoint)"
            ),
            file=sys.stderr,
            flush=True,
        )
    try:
        code = daemon.run_until_signaled()
    finally:
        if client is not None:
            client.close()
    # one JSON summary line on stderr at drain: the audit the mirror
    # accumulated (agreement, divergences, lag) survives the process
    print(
        "simon twin mirror: " + json.dumps(mirror.stats(), sort_keys=True),
        file=sys.stderr,
    )
    observatory = observatory_block()
    if observatory:
        print("simon twin observatory: " + json.dumps(observatory),
              file=sys.stderr)
    return code


def _fetch_json(url: str, timeout: float):
    """GET a daemon endpoint, decode JSON. Raises ExternalIOError with
    the endpoint on any transport/decode failure (exit 1/2 mapping is
    the caller's)."""
    import json
    import urllib.error
    import urllib.request

    from .runtime import ExternalIOError

    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return json.loads(resp.read().decode("utf-8"))
    except (OSError, urllib.error.URLError, ValueError) as e:
        raise ExternalIOError(f"cannot read {url}: {e}", endpoint=url) from e


def cmd_top(args) -> int:
    """Live terminal dashboard against a RUNNING serve/twin daemon
    (obs/telemetry.py): polls /v1/obs/snapshot + /v1/obs/series and
    renders health, SLO burn rates, and sparklined history; --fleet
    renders a `simon fleet` router's frame (per-slot panes, the
    fleet-wide signals). --once prints a single frame; --format json
    dumps the raw snapshot. A pure client: no device work. Exit 0 on a
    clean stop (Ctrl-C included), 1 when the daemon is unreachable, 2
    on input errors."""
    import json as _json
    import time
    from urllib.parse import quote

    from .obs import telemetry as _tm
    from .runtime import ExternalIOError

    url = (args.url or f"http://{args.host}:{args.port}").rstrip("/")
    if args.interval <= 0:
        print("error: --interval must be > 0 seconds", file=sys.stderr)
        return 2
    names = list(args.series or ())
    fleet = bool(args.fleet)

    def fetch():
        snapshot = _fetch_json(f"{url}/v1/obs/snapshot", args.timeout)
        if names:
            want = list(names)
        elif fleet:
            # the router-wide signals that exist, plus the per-slot panes
            # of every slot the router reports; a slot whose series are
            # missing renders as gaps (the series endpoint answers an
            # unknown name with an empty list)
            want = [n for n in _tm.FLEET_TOP_DEFAULT_SERIES
                    if n in (snapshot.get("latest") or {})]
            for slot in sorted(snapshot.get("replicas") or {}):
                want.extend(_tm.fleet_slot_series(str(slot)))
        else:
            want = [n for n in _tm.TOP_DEFAULT_SERIES
                    if n in (snapshot.get("latest") or {})]
        # every name percent-encoded so the query string round-trips it
        qs = "&".join(f"name={quote(n, safe='')}" for n in want)
        series = (
            _fetch_json(
                f"{url}/v1/obs/series?{qs}&sinceSeconds={args.window:g}",
                args.timeout,
            )
            if want
            else {"series": {}}
        )
        return snapshot, series

    try:
        snapshot, series = fetch()
    except ExternalIOError as e:
        print(f"simon top: {e}", file=sys.stderr)
        return 1
    render = _tm.render_fleet_top_frame if fleet else _tm.render_top_frame
    if args.format == "json":
        print(_json.dumps({"snapshot": snapshot, "series": series}, indent=2))
        return 0
    if args.once:
        print(render(snapshot, series, url))
        return 0
    try:
        while True:
            # ANSI home+clear per frame: a live dashboard, not a scroll
            print("\x1b[2J\x1b[H" + render(snapshot, series, url), flush=True)
            time.sleep(args.interval)
            try:
                snapshot, series = fetch()
            except ExternalIOError as e:
                print(f"simon top: {e}", file=sys.stderr)
                return 1
    except KeyboardInterrupt:
        return 0


def cmd_doctor(args) -> int:
    """Perf-regression doctor (obs/doctor.py): diff a candidate bench
    record against a baseline (the JAX package's bench-record format)
    and exit 1 on any regression past thresholds, 2 on a bad file."""
    import json

    from .models.validation import InputError
    from .obs import doctor

    try:
        base = doctor.load_bench_record(args.baseline)
        cand = doctor.load_bench_record(args.candidate)
    except (OSError, InputError) as e:
        print(f"simon doctor: {e}", file=sys.stderr)
        return 2
    report = doctor.diff_records(
        base, cand, doctor.Thresholds.from_args(args)
    )
    doc = report.as_dict()
    doc["baseline"] = args.baseline
    doc["candidate"] = args.candidate
    if args.format == "json":
        print(json.dumps(doc, indent=2))
    else:
        print(doctor.render_text(report, args.baseline, args.candidate))
    if args.out:
        try:
            with open(args.out, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=2)
        except OSError as e:
            print(f"simon doctor: cannot write --out: {e}", file=sys.stderr)
            return 2
    return 0 if report.ok else 1


def cmd_version(_args) -> int:
    from . import __version__

    print(f"simon-torch version {__version__}")
    return 0


def cmd_gen_doc(args) -> int:
    """Markdown CLI docs (cmd/doc/generate_markdown.go -> cobra
    doc.GenMarkdownTree): one page per command — title, synopsis,
    usage, options, SEE ALSO cross-links — not a single dump. We
    create the output directory when missing (the reference instead
    errors on a missing directory — friendlier here, noted)."""
    parser = build_parser()
    out_dir = args.output
    os.makedirs(out_dir, exist_ok=True)

    def page(path: str, title: str, p: argparse.ArgumentParser, see_also):
        desc = (p.description or "").strip()
        lines = [
            f"## {title}",
            "",
            desc,
            "",
            "### Synopsis",
            "",
            desc,
            "",
            "```",
            p.format_usage().strip(),
            "```",
            "",
            "### Options",
            "",
            "```",
        ]
        opts = p.format_help()
        # keep only the options tail of the help text (cobra pages
        # list flags, not the usage/positional preamble)
        for marker in ("options:", "optional arguments:"):
            if marker in opts:
                opts = opts.split(marker, 1)[1]
                break
        lines.append(opts.strip("\n"))
        lines += ["```", "", "### SEE ALSO", ""]
        for target, file_name, blurb in see_also:
            lines.append(f"* [{target}]({file_name})\t - {blurb}")
        lines.append("")
        with open(path, "w") as f:
            f.write("\n".join(lines))

    sub_action = next(
        a for a in parser._actions if isinstance(a, argparse._SubParsersAction)
    )
    helps = {
        a.dest: a.help or "" for a in sub_action._choices_actions
    } if sub_action._choices_actions else {}
    root_desc = (parser.description or "").strip()
    subs = sorted(sub_action.choices.items())
    page(
        os.path.join(out_dir, "simon.md"),
        "simon",
        parser,
        [
            (f"simon {name}", f"simon_{name}.md", helps.get(name, ""))
            for name, _p in subs
        ],
    )
    for name, sp in subs:
        sp.description = sp.description or helps.get(name, "")
        page(
            os.path.join(out_dir, f"simon_{name}.md"),
            f"simon {name}",
            sp,
            [("simon", "simon.md", root_desc)],
        )
    print(f"wrote {len(subs) + 1} pages to {out_dir}")
    return 0


def _result_json(result, explain=None) -> str:
    """Structured results (SURVEY.md §5: structured results + optional
    table renderer instead of ASCII-only). `explain` (the --explain
    recorder payload) rides along as an `explain` key when armed."""
    import json

    from .models.workloads import LABEL_NEW_NODE

    out = {
        "success": result.success,
        "newNodeCount": result.new_node_count,
        "message": result.message,
        "nodes": [],
        "unscheduledPods": [],
    }
    if explain is not None:
        out["explain"] = explain
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
    p_apply.add_argument("-i", "--interactive", action="store_true", help="interactive mode")
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
    _add_mesh_flag(p_apply)
    _add_guard_flags(p_apply)
    _add_obs_flags(p_apply)
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
    _add_obs_flags(p_defrag)
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
    _add_mesh_flag(p_chaos)
    _add_guard_flags(p_chaos)
    _add_obs_flags(p_chaos)
    _add_device_flag(p_chaos)
    p_chaos.add_argument(
        "--format", choices=["table", "json"], default="table", help="result output format"
    )
    _add_trace_flag(p_chaos)
    p_chaos.set_defaults(func=cmd_chaos)

    p_shadow = sub.add_parser(
        "shadow",
        help="shadow-scheduler divergence auditor (replay/tail real decisions)",
        description="Audit simon against a real scheduler's decisions: "
        "replay each recorded (or live-tailed) scheduling decision "
        "through the warm oracle/scan against the same evolving cluster "
        "state, classify every step as agree / node-divergence / "
        "feasibility-divergence / ordering-divergence, and attach "
        "per-node filter verdicts and weighted score vectors to every "
        "disagreement. --record writes a log of simon's OWN serial "
        "decisions (the self-conformance fixture and trace generator); "
        "--decision-log replays a recorded log against the config's "
        "cluster; --tail polls the config's live kubeConfig cluster. "
        "Replay commits the REAL decision after each probe, so the "
        "mirror tracks reality; every probe launches the already-built "
        "kernel (zero nvcc builds after the first step of each shape — "
        "measured in the report). Exit 0 on full agreement, 1 when "
        "divergences were found.",
    )
    p_shadow.add_argument(
        "-f", "--simon-config", required=True, help="simon config file path"
    )
    p_shadow.add_argument(
        "--record",
        default="",
        metavar="PATH",
        help="record simon's own serial decisions for the config's "
        "cluster+apps as a fingerprinted decision log (fsync'd JSONL)",
    )
    p_shadow.add_argument(
        "--decision-log",
        default="",
        metavar="PATH",
        help="replay this decision log against the config's cluster and "
        "report the divergence taxonomy (fingerprint mismatch refuses "
        "loudly)",
    )
    p_shadow.add_argument(
        "--tail",
        action="store_true",
        help="poll the config's live kubeConfig cluster and audit its "
        "scheduler's decisions as they appear",
    )
    p_shadow.add_argument(
        "--tail-record",
        default="",
        metavar="PATH",
        help="with --tail: also write every observed step to this "
        "decision log (doubles as an arrival trace; its fingerprint is "
        "the live nodes at bootstrap, and live clusters drift, so "
        "replaying it later usually needs --allow-fingerprint-mismatch)",
    )
    p_shadow.add_argument(
        "--allow-fingerprint-mismatch",
        action="store_true",
        help="replay a decision log whose cluster fingerprint does not "
        "match the config's cluster (needed for --tail-record logs of "
        "drifting live clusters; divergences may then reflect cluster "
        "drift, not scheduler disagreement)",
    )
    p_shadow.add_argument(
        "--engine",
        choices=["cuda", "oracle"],
        default="cuda",
        help="probe engine: cuda = one single-pod masked scan a step, "
        "one kernel launch; oracle = the serial filter+score walk",
    )
    _add_device_flag(p_shadow)
    p_shadow.add_argument(
        "--poll-interval",
        type=float,
        default=10.0,
        metavar="SECONDS",
        help="--tail polling interval",
    )
    p_shadow.add_argument(
        "--max-polls",
        type=int,
        default=None,
        metavar="N",
        help="--tail: stop after N poll rounds (default: until deadline "
        "or SIGINT)",
    )
    p_shadow.add_argument(
        "--max-steps",
        type=int,
        default=None,
        metavar="N",
        help="--tail: stop once N decisions have been audited",
    )
    p_shadow.add_argument(
        "--deadline",
        type=float,
        default=None,
        metavar="SECONDS",
        help="wall-clock budget: on expiry (or SIGINT) the audit stops "
        "at the next step boundary and reports what it has (exit 3/4)",
    )
    p_shadow.add_argument(
        "--max-catchup",
        type=int,
        default=500,
        metavar="N",
        help="--tail: apply at most N observed steps per poll round; "
        "the backlog a recovered apiserver flap dumps on the tailer "
        "replays across rounds instead of stalling the loop",
    )
    p_shadow.add_argument(
        "--breaker-cooldown",
        type=float,
        default=30.0,
        metavar="SECONDS",
        help="--tail: circuit-breaker recovery cooldown — after an "
        "apiserver outage opens the breaker, a half-open probe retries "
        "this often; the tail survives the flap instead of failing "
        "forever (0 disables recovery: one-shot CLI posture)",
    )
    _add_inject_flag(p_shadow)
    _add_obs_flags(p_shadow)
    p_shadow.add_argument(
        "--format", choices=["table", "json"], default="table",
        help="report output format",
    )
    p_shadow.set_defaults(func=cmd_shadow)

    p_timeline = sub.add_parser(
        "timeline",
        help="discrete-event cluster timeline with autoscaler policy comparison",
        description="Play a trace of pod arrivals/departures, node "
        "churn, and spot reclamations through pluggable autoscaler "
        "policies (static:K / threshold / probe, optionally @nospread) "
        "over the config's cluster, with the config's newNode spec as "
        "the candidate pool. Consecutive arrivals batch into "
        "encode-once masked scan windows and every policy rides the "
        "same launch of the batch kernel's pins-first mode as one "
        "scenario row, so a 1000-step trace costs a handful of "
        "launches. Emits per-step cost/utilization/pending curves per "
        "policy. Exit 0 on a completed run, 2 on input errors, 3/4 on "
        "deadline/interrupt partials.",
    )
    p_timeline.add_argument(
        "-f", "--simon-config", required=True, help="simon config file path"
    )
    p_timeline.add_argument(
        "--synthetic",
        type=int,
        default=0,
        metavar="N",
        help="generate a seeded synthetic trace of N Poisson pod "
        "arrivals with exponential lifetimes (and spot reclaims when "
        "--spot-frac > 0)",
    )
    p_timeline.add_argument(
        "--trace",
        default="",
        metavar="PATH",
        help="replay this timeline-trace JSONL (written by --save-trace)",
    )
    p_timeline.add_argument(
        "--from-decision-log",
        default="",
        metavar="PATH",
        help="convert a shadow decision log (simon shadow --record / "
        "--tail-record) into a timeline trace and replay REAL cluster "
        "history through the policies (decisions become arrivals, "
        "evictions departures, node churn joins/drains)",
    )
    p_timeline.add_argument(
        "--allow-fingerprint-mismatch",
        action="store_true",
        help="accept a --from-decision-log whose cluster fingerprint "
        "does not match the config's cluster",
    )
    p_timeline.add_argument(
        "--save-trace",
        default="",
        metavar="PATH",
        help="also write the (generated or converted) trace as "
        "fingerprinted timeline-trace JSONL",
    )
    p_timeline.add_argument(
        "--seed", type=int, default=1, help="synthetic-trace seed (deterministic)"
    )
    p_timeline.add_argument(
        "--arrival-rate", type=float, default=1.0, metavar="PODS/S",
        help="synthetic Poisson arrival rate",
    )
    p_timeline.add_argument(
        "--mean-lifetime", type=float, default=120.0, metavar="SECONDS",
        help="synthetic mean pod lifetime (exponential)",
    )
    p_timeline.add_argument(
        "--long-running-frac", type=float, default=0.5, metavar="FRAC",
        help="fraction of synthetic pods that never depart",
    )
    p_timeline.add_argument(
        "--spot-frac", type=float, default=0.0, metavar="FRAC",
        help="fraction of base nodes that are spot instances (0 = none)",
    )
    p_timeline.add_argument(
        "--spot-hazard", type=float, default=1.0 / 300.0, metavar="RATE",
        help="spot reclaim hazard rate per node per second",
    )
    p_timeline.add_argument(
        "--policy",
        action="append",
        metavar="SPEC",
        help="policy to run (repeatable): static:K, threshold"
        "[:lo=30,patience=2,step=0], probe; append @nospread for the "
        "PodTopologySpread-off score profile. Default: threshold",
    )
    p_timeline.add_argument(
        "--compare",
        action="append",
        metavar="SPEC,SPEC,...",
        help="comma-separated policy list (same specs as --policy)",
    )
    p_timeline.add_argument(
        "--cadence", type=float, default=60.0, metavar="SECONDS",
        help="autoscaler decision cadence (decisions run at t=0 too)",
    )
    p_timeline.add_argument(
        "--warmup", type=float, default=0.0, metavar="SECONDS",
        help="node warm-up delay: a scale-up's candidates become "
        "schedulable this long after the decision",
    )
    p_timeline.add_argument(
        "--max-nodes", type=int, default=8, metavar="K",
        help="autoscaler candidate pool size (copies of the config's "
        "newNode spec; 0 disables scaling)",
    )
    p_timeline.add_argument(
        "--window-arrivals", type=int, default=256, metavar="N",
        help="max arrivals batched into one scan window",
    )
    p_timeline.add_argument(
        "--engine",
        choices=["cuda", "oracle"],
        default="cuda",
        help="window engine: cuda = batched masked scan rows, one launch "
        "a window, oracle = the serial host walk (the conformance "
        "reference; the encoding still lives on --device)",
    )
    _add_device_flag(p_timeline)
    _add_mesh_flag(p_timeline)
    _add_guard_flags(p_timeline)
    _add_obs_flags(p_timeline)
    p_timeline.add_argument(
        "--format", choices=["table", "json"], default="table",
        help="result output format",
    )
    p_timeline.add_argument(
        "--trace-phases",
        action="store_true",
        help="print per-phase wall-clock JSON to stderr (--trace is the "
        "trace-file input here, unlike the other commands)",
    )
    p_timeline.set_defaults(func=cmd_timeline)

    p_serve = sub.add_parser(
        "serve",
        help="long-lived what-if scheduling daemon (JSON-over-HTTP)",
        description="Load the cluster once, build and load the kernel "
        "library, and serve concurrent what-if questions: "
        "POST /v1/simulate with app YAML answers exactly like a "
        "standalone simulation of those apps on the loaded cluster "
        "under the DEFAULT scheduler profile (apply's "
        "--default-scheduler-config / --use-greed customizations are "
        "not served — docs/SERVING.md). Concurrent requests coalesce "
        "onto batch-kernel launches on the card (up to --max-batch per "
        "launch); overload sheds with 503 + Retry-After at "
        "--queue-depth; SIGTERM drains in-flight requests then exits 0.",
    )
    p_serve.add_argument(
        "-f", "--simon-config", required=True,
        help="simon config file path (its cluster section is served; "
        "appList is ignored — apps arrive per request)",
    )
    p_serve.add_argument("--host", default="127.0.0.1", help="bind address")
    p_serve.add_argument(
        "--port", type=int, default=8080,
        help="bind port (0 = ephemeral; the readiness line prints it)",
    )
    p_serve.add_argument(
        "--max-batch", type=int, default=16, metavar="B",
        help="max requests coalesced into one batch-kernel launch",
    )
    p_serve.add_argument(
        "--queue-depth", type=int, default=64, metavar="N",
        help="bounded request queue; submits beyond it shed with 503",
    )
    p_serve.add_argument(
        "--default-deadline", type=float, default=None, metavar="SECONDS",
        help="per-request deadline when the request body sets none; a "
        "request whose deadline expires while queued is shed with a "
        "machine-readable PARTIAL 503 body",
    )
    p_serve.add_argument(
        "--drain-timeout", type=float, default=30.0, metavar="SECONDS",
        help="SIGTERM drain bound: queued requests still unanswered "
        "after this are shed and the daemon exits 3 instead of 0",
    )
    p_serve.add_argument(
        "--no-warm", action="store_true",
        help="skip the pre-listen warmup request (faster start, slower "
        "first request: it pays the kernel build and the committed scan)",
    )
    p_serve.add_argument(
        "--tick-budget", type=float, default=None, metavar="SECONDS",
        help="admission latency budget: a request whose predicted wait "
        "(p95 coalescer tick x ticks queued ahead) exceeds this is shed "
        "with 429 + Retry-After before it takes a queue slot "
        "(docs/SERVING.md admission control; default: off)",
    )
    p_serve.add_argument(
        "--max-request-pods", type=int, default=None, metavar="N",
        help="requests whose estimated pod count exceeds N are answered "
        "by a standalone simulate() instead of the coalesced launch "
        "(default: off)",
    )
    p_serve.add_argument(
        "--max-sessions", type=int, default=8, metavar="N",
        help="warm-session LRU capacity; the configured cluster is "
        "pinned, secondaries evict LRU-first and under device-memory "
        "ledger pressure",
    )
    p_serve.add_argument(
        "--snapshot", default="", metavar="PATH",
        help="append session admit/evict/drain records to this "
        "crash-safe JSONL snapshot journal (resumed across restarts; "
        "torn tail recovered, interior damage refused)",
    )
    p_serve.add_argument(
        "--replay-snapshot", action="store_true",
        help="before listening, restore the newest verified checkpoint "
        "and replay the --snapshot journal's cluster-delta suffix into "
        "the fresh session (failover: a replacement daemon rejoins with "
        "the dead one's committed state and, with a warm --aot-store, "
        "no nvcc build)",
    )
    p_serve.add_argument(
        "--checkpoint-interval", type=int, default=None, metavar="DELTAS",
        help="write a verified, content-addressed checkpoint of the "
        "committed session every N applied deltas (requires "
        "--snapshot); the journal's absorbed prefix is compacted away "
        "only AFTER the snapshot's state digest verifies against a "
        "fresh materialization (docs/ROBUSTNESS.md; default: off)",
    )
    p_serve.add_argument(
        "--keep-checkpoints", type=int, default=2, metavar="N",
        help="checkpoint generations retained; a corrupt newest "
        "generation falls back loudly to the previous one, never a "
        "silent wrong state (default 2)",
    )
    p_serve.add_argument(
        "--no-incremental", action="store_true",
        help="disable delta re-simulation: every tick re-scans the "
        "whole roster instead of launching only the request suffix "
        "against the resident committed scan (docs/PERFORMANCE.md)",
    )
    _add_store_flag(p_serve)
    _add_device_flag(p_serve)
    _add_inject_flag(p_serve)
    _add_obs_flags(p_serve)
    _add_telemetry_flags(p_serve)
    p_serve.set_defaults(func=cmd_serve)

    p_fleet = sub.add_parser(
        "fleet",
        help="N-replica serve fleet behind one consistent-hash router",
        description="Spawn N `simon serve` replicas sharing one "
        "content-addressed kernel-library store and route requests tenant-affine "
        "over a consistent-hash ring (docs/FLEET.md). The router "
        "probes each replica's /healthz, honors degraded Retry-After "
        "hints, and fails over on replica death: in-flight requests "
        "reroute with their ORIGINAL X-Simon-Request-Id (503 + "
        "Retry-After when no replica can answer, never a silent "
        "drop), and the replacement replica resumes its slot's "
        "snapshot journal, replays the dead replica's cluster-delta "
        "stream, and answers its first request with no nvcc "
        "build. The replicas run on the card unless --device cpu "
        "is given. Fleet-aggregated /metrics carries per-replica "
        "labels from a cardinality-bounded allowlist. SIGTERM drains "
        "every replica then exits 0.",
    )
    p_fleet.add_argument(
        "-f", "--simon-config", required=True,
        help="simon config file served by every replica",
    )
    p_fleet.add_argument(
        "--replicas", type=int, default=2, metavar="N",
        help="serve replicas to spawn and supervise (default 2)",
    )
    p_fleet.add_argument("--host", default="127.0.0.1", help="bind address")
    p_fleet.add_argument(
        "--port", type=int, default=8080,
        help="router bind port (0 = ephemeral; the readiness line "
        "prints it; replicas always bind ephemeral ports)",
    )
    p_fleet.add_argument(
        "--fleet-dir", default="simon-fleet", metavar="DIR",
        help="fleet state directory: per-slot snapshot journals, "
        "slot lock files, replica logs, and (unless --aot-store is "
        "set) the shared kernel-library store (default ./simon-fleet)",
    )
    p_fleet.add_argument(
        "--probe-interval", type=float, default=2.0, metavar="SECONDS",
        help="health-probe cadence per replica; a degraded replica's "
        "Retry-After hint stretches its own cadence (default 2.0)",
    )
    p_fleet.add_argument(
        "--probe-timeout", type=float, default=5.0, metavar="SECONDS",
        help="per-probe HTTP timeout (default 5.0)",
    )
    p_fleet.add_argument(
        "--drain-timeout", type=float, default=30.0, metavar="SECONDS",
        help="SIGTERM drain bound per replica; a replica still up "
        "after this is killed and the fleet exits 3 instead of 0",
    )
    p_fleet.add_argument(
        "--spawn-attempts", type=int, default=4, metavar="N",
        help="spawn attempts per replica (capped-exponential backoff "
        "between attempts) before a boot or failover gives up",
    )
    p_fleet.add_argument(
        "--max-batch", type=int, default=None, metavar="B",
        help="forwarded to every replica (see `simon serve`)",
    )
    p_fleet.add_argument(
        "--queue-depth", type=int, default=None, metavar="N",
        help="forwarded to every replica (see `simon serve`)",
    )
    p_fleet.add_argument(
        "--default-deadline", type=float, default=None, metavar="SECONDS",
        help="forwarded to every replica (see `simon serve`)",
    )
    p_fleet.add_argument(
        "--tick-budget", type=float, default=None, metavar="SECONDS",
        help="forwarded to every replica (see `simon serve`)",
    )
    p_fleet.add_argument(
        "--no-incremental", action="store_true",
        help="forwarded to every replica (see `simon serve`)",
    )
    p_fleet.add_argument(
        "--checkpoint-interval", type=int, default=None, metavar="DELTAS",
        help="forwarded to every replica: checkpoint the committed "
        "session every N deltas so a failover replays at most N "
        "journal deltas (bounded recovery; see `simon serve` and "
        "docs/FLEET.md)",
    )
    p_fleet.add_argument(
        "--keep-checkpoints", type=int, default=None, metavar="N",
        help="forwarded to every replica (see `simon serve`)",
    )
    p_fleet.add_argument(
        "--audit-log", default="", metavar="PATH",
        help="failover audit timeline path (fsync'd JSONL: probe_flap "
        "-> declared_dead -> lock_reclaim -> respawn -> replay_progress "
        "-> first_200 per failover, validated by "
        "tools/validate_audit.py; default <fleet-dir>/"
        "failover-audit.jsonl)",
    )
    p_fleet.add_argument(
        "--no-audit-log", action="store_true",
        help="disable the failover audit timeline",
    )
    _add_store_flag(p_fleet)
    _add_device_flag(p_fleet)
    _add_inject_flag(p_fleet)
    _add_obs_flags(p_fleet)
    _add_telemetry_flags(p_fleet)
    p_fleet.set_defaults(func=cmd_fleet)

    p_twin = sub.add_parser(
        "twin",
        help="live digital-twin daemon: mirror a cluster, answer "
        "what-if/drain/N+K/forecast against live state",
        description="Continuously mirror a cluster on the cluster-delta "
        "substrate (a live apiserver tail or a recorded decision-log "
        "feed), audit every real scheduler decision against the warm "
        "mirror (agreement-rate and mirror-lag stream to /metrics as "
        "alertable gauges), and serve on-demand queries over HTTP: "
        "POST /v1/whatif (would these apps fit right now), /v1/drain "
        "(can I cordon these nodes/this rack), /v1/nplusk (does the "
        "live placement survive K node failures), /v1/forecast "
        "(timeline windows stepped forward from the current mirrored "
        "state). On the card a probe, a what-if, a drain and an N+K "
        "trial are one kernel launch each, a forecast window one "
        "pins-first launch. docs/TWIN.md.",
    )
    p_twin.add_argument(
        "-f", "--simon-config", required=True, help="simon config file path"
    )
    p_twin.add_argument(
        "--tail",
        action="store_true",
        help="poll the config's live cluster (kubeConfig required)",
    )
    p_twin.add_argument(
        "--feed",
        default="",
        metavar="LOG",
        help="tail a recorded decision log instead of a live cluster "
        "(the self-conformance source; simon tailing its own recorded "
        "feed must agree with itself 100%%)",
    )
    p_twin.add_argument(
        "--feed-batch", type=int, default=64, metavar="N",
        help="feed steps replayed per poll round",
    )
    p_twin.add_argument(
        "--allow-fingerprint-mismatch",
        action="store_true",
        help="replay a --feed log recorded against different inputs "
        "(divergences become meaningful; default refuses loudly)",
    )
    p_twin.add_argument(
        "--engine",
        choices=["cuda", "oracle"],
        default="cuda",
        help="mirror probe/query engine: cuda = kernel launches on the "
        "card (or the plain versions with --device cpu), oracle = the "
        "serial host walk",
    )
    p_twin.add_argument("--host", default="127.0.0.1", help="bind address")
    p_twin.add_argument(
        "--port", type=int, default=8081, help="bind port (0 = ephemeral)"
    )
    p_twin.add_argument(
        "--poll-interval", type=float, default=2.0, metavar="SECONDS",
        help="tail poll cadence",
    )
    p_twin.add_argument(
        "--max-polls", type=int, default=None, metavar="N",
        help="stop tailing after N polls (the mirror stays queryable "
        "at its final state; default: tail until signaled)",
    )
    p_twin.add_argument(
        "--max-catchup", type=int, default=256, metavar="N",
        help="max backlog steps applied per poll round (a recovered "
        "flap's giant diff converges across rounds instead of blocking "
        "queries)",
    )
    p_twin.add_argument(
        "--tick-budget", type=float, default=None, metavar="SECONDS",
        help="admission sheds a query 429 (with Retry-After) when the "
        "p95 query time times the queue ahead exceeds this",
    )
    p_twin.add_argument(
        "--max-request-pods", type=int, default=None, metavar="N",
        help="admission bound on estimated pods per what-if request",
    )
    p_twin.add_argument(
        "--drain-timeout", type=float, default=30.0, metavar="SECONDS",
        help="max wait for the tail thread and in-flight queries at "
        "shutdown",
    )
    p_twin.add_argument(
        "--breaker-cooldown", type=float, default=30.0, metavar="SECONDS",
        help="circuit-breaker half-open recovery cooldown for the "
        "apiserver endpoints (SIMON_BREAKER_COOLDOWN wins when set; "
        "0 disables recovery)",
    )
    p_twin.add_argument(
        "--snapshot", default="", metavar="PATH",
        help="append every applied mirror step to this crash-safe "
        "JSONL snapshot journal (resumed across restarts; the twin "
        "analogue of `simon serve --snapshot`)",
    )
    p_twin.add_argument(
        "--replay-snapshot", action="store_true",
        help="before tailing, restore the newest verified checkpoint "
        "and replay the --snapshot journal's step suffix into the "
        "mirror (bounded twin failover; docs/TWIN.md)",
    )
    p_twin.add_argument(
        "--checkpoint-interval", type=int, default=None, metavar="STEPS",
        help="write a verified checkpoint of the mirrored cluster "
        "every N applied steps (requires --snapshot); restore then "
        "replays at most N journal steps and the absorbed prefix is "
        "compacted only after the digest verifies "
        "(docs/ROBUSTNESS.md; default: off)",
    )
    p_twin.add_argument(
        "--keep-checkpoints", type=int, default=2, metavar="N",
        help="checkpoint generations retained; a corrupt newest "
        "generation falls back loudly to the previous one (default 2)",
    )
    _add_store_flag(p_twin)
    _add_device_flag(p_twin)
    _add_inject_flag(p_twin)
    _add_obs_flags(p_twin)
    _add_telemetry_flags(p_twin)
    p_twin.set_defaults(func=cmd_twin)

    p_top = sub.add_parser(
        "top",
        help="live terminal dashboard against a running serve/twin daemon",
        description="Poll a RUNNING daemon's /v1/obs/snapshot and "
        "/v1/obs/series endpoints and render a live dashboard: health "
        "and degradation reasons, SLO burn rates and alert states, and "
        "sparklined history of the key operational signals (QPS, queue "
        "depth, latency percentiles, agreement rate, device memory). "
        "`simon top` is a pure reader — it does no device work and "
        "never perturbs the daemon beyond two GETs per refresh.",
    )
    p_top.add_argument(
        "--url", default="",
        help="daemon base URL (wins over --host/--port)",
    )
    p_top.add_argument("--host", default="127.0.0.1", help="daemon host")
    p_top.add_argument("--port", type=int, default=8080, help="daemon port")
    p_top.add_argument(
        "--interval", type=float, default=2.0, metavar="SECONDS",
        help="refresh interval",
    )
    p_top.add_argument(
        "--window", type=float, default=300.0, metavar="SECONDS",
        help="history window rendered in the sparklines",
    )
    p_top.add_argument(
        "--series", action="append", metavar="NAME",
        help="render this series instead of the curated defaults "
        "(repeatable; names as listed by GET /v1/obs/series)",
    )
    p_top.add_argument(
        "--fleet", action="store_true",
        help="render the fleet-router frame against a `simon fleet` "
        "endpoint: per-slot panes (up/degraded/down, request rate, "
        "forward p95) plus the fleet-wide counters and SLO burn "
        "table; slots whose series are missing or TTL-stale render "
        "as gaps, never errors",
    )
    p_top.add_argument(
        "--once", action="store_true",
        help="render one frame and exit (no screen clearing)",
    )
    p_top.add_argument(
        "--timeout", type=float, default=5.0, metavar="SECONDS",
        help="per-request HTTP timeout",
    )
    p_top.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="json dumps the raw snapshot+series instead of rendering",
    )
    p_top.set_defaults(func=cmd_top)

    p_doctor = sub.add_parser(
        "doctor",
        help="diff two bench records and gate on perf regressions",
        description="Diff a candidate bench record against a baseline "
        "(headline value, device dispatches, XLA recompiles, peak HBM "
        "from the memory ledger, per-site latency p95s) and exit 1 on "
        "any regression past thresholds. Reads the JAX package's bench "
        "records: raw bench JSON lines, JSONL runs, or the checked-in "
        "BENCH_r*.json wrappers. Counts use ABSOLUTE slack (default 0 — "
        "dispatches are semantic on a fixed scenario); times/rates/bytes "
        "use FRACTIONAL slack (default 0.5 — wall-clock on shared "
        "runners is noisy). Dimensions absent from either record are "
        "skipped, never invented.",
    )
    p_doctor.add_argument(
        "baseline", help="recorded bench file to diff against"
    )
    p_doctor.add_argument(
        "candidate", help="fresh bench record (file) to judge"
    )
    p_doctor.add_argument(
        "--time-tolerance", type=float, default=0.5, metavar="FRAC",
        help="fractional slack on the headline value (default 0.5; "
        "direction from the unit — seconds regress up, rates down)",
    )
    p_doctor.add_argument(
        "--dispatch-tolerance", type=int, default=0, metavar="N",
        help="absolute slack on device dispatches (default 0)",
    )
    p_doctor.add_argument(
        "--recompile-tolerance", type=int, default=0, metavar="N",
        help="absolute slack on XLA recompiles (default 0)",
    )
    p_doctor.add_argument(
        "--hbm-tolerance", type=float, default=0.5, metavar="FRAC",
        help="fractional slack on the ledger peak-HBM watermark",
    )
    p_doctor.add_argument(
        "--p95-tolerance", type=float, default=0.5, metavar="FRAC",
        help="fractional slack on per-site latency p95s",
    )
    p_doctor.add_argument(
        "--suffix-tolerance", type=float, default=0.5, metavar="FRAC",
        help="fractional slack on the incremental suffix fraction "
        "(regresses up: a growing fraction re-scans reusable rows)",
    )
    p_doctor.add_argument(
        "--store-tolerance", type=float, default=0.5, metavar="FRAC",
        help="fractional slack on the artifact-store hit rate "
        "(regresses down: cold starts paying avoidable compiles)",
    )
    p_doctor.add_argument(
        "--fleet-tolerance", type=float, default=0.5, metavar="FRAC",
        help="fractional slack on the fleet dimensions: qps_scaling "
        "(regresses down: lost horizontal scaling) and "
        "failover_seconds (regresses up: slower recovery after a "
        "replica kill)",
    )
    p_doctor.add_argument(
        "--ckpt-tolerance", type=float, default=0.5, metavar="FRAC",
        help="fractional slack on the aged-failover checkpoint "
        "restore seconds (regresses up: recovery time growing with "
        "absorbed-delta age means the bounded-recovery contract broke)",
    )
    p_doctor.add_argument(
        "--store-reject-tolerance", type=int, default=0, metavar="N",
        help="absolute slack on artifact-store rejects (default 0: a "
        "reject is a corrupt/stale entry, worth a look even though "
        "the recovery is clean)",
    )
    p_doctor.add_argument(
        "--format", choices=["text", "json"], default="text",
        help="report format (default text)",
    )
    p_doctor.add_argument(
        "--out", default="", metavar="PATH",
        help="also write the JSON report to PATH (CI artifact)",
    )
    p_doctor.set_defaults(func=cmd_doctor)

    p_version = sub.add_parser("version", help="print version")
    p_version.set_defaults(func=cmd_version)

    p_doc = sub.add_parser("gen-doc", help="generate markdown CLI docs")
    p_doc.add_argument("--output", default="docs/commandline-torch")
    p_doc.set_defaults(func=cmd_gen_doc)
    return parser


def _add_mesh_flag(p: argparse.ArgumentParser):
    p.add_argument(
        "--mesh",
        default=None,
        metavar="auto|off|N",
        help="split batched scans over the local CUDA devices: auto = "
        "every card, N = the first N cards, off = one device (the "
        "default; the SIMON_MESH env var changes it). The layout planner "
        "picks the scenario axis (one batch-kernel launch a card) or the "
        "node axis (the node-sharded torch scan) per launch; a device "
        "OOM halves a chunk of scenarios, every other fault propagates",
    )


def _configure_mesh(args) -> None:
    """Wire --mesh into the process-wide mesh (parallel/mesh.py). The
    flag wins; without it the SIMON_MESH default stands. Resolves the
    devices now against --device, so that a count beyond the cards there
    are is a clean exit-2 InputError here."""
    from .parallel import mesh as mesh_mod

    spec = getattr(args, "mesh", None)
    if spec is not None:
        mesh_mod.configure(spec)
    mesh_mod.current_mesh(getattr(args, "device", None))


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


def _add_obs_flags(p: argparse.ArgumentParser):
    """Flight-recorder flags shared by the long-running commands: span
    trace export, per-pod placement explanations, torch.profiler
    capture of the device phases."""
    p.add_argument(
        "--trace-out",
        default="",
        metavar="PATH",
        help="record a hierarchical span trace of the whole run and "
        "write it on exit: a .json path gets Chrome trace-event format "
        "(loadable in Perfetto / chrome://tracing), a .jsonl path gets "
        "streaming JSONL with each span fsync'd as it closes (a crash "
        "keeps every finished span)",
    )
    p.add_argument(
        "--explain",
        nargs="?",
        const="",
        default=None,
        metavar="POD",
        help="record per-pod placement explanations — per-node filter "
        "verdicts, score vectors, and preemption/escape provenance — "
        "and append them to the output (JSON output gains an `explain` "
        "key). With POD (a pod name or namespace/name) the named pod's "
        "full decision is explained even when it schedules; without, "
        "unschedulable pods are explained (capped)",
    )
    p.add_argument(
        "--profile-dir",
        default="",
        metavar="DIR",
        help="capture torch.profiler traces (CPU and CUDA activity) of "
        "the device phases into DIR, one Chrome trace a phase run "
        "(viewable in Perfetto; equivalent to setting SIMON_PROFILE_DIR)",
    )


def _add_telemetry_flags(p: argparse.ArgumentParser):
    """Resident-telemetry flags of the serve and twin daemons
    (docs/OBSERVABILITY.md production-telemetry section)."""
    p.add_argument(
        "--slo-config",
        default="",
        metavar="PATH",
        help="declarative SLO objectives (JSON or YAML; kinds: "
        "availability, latency, gauge_min, counter_budget, plus the "
        "router-side fleet_availability, fleet_imbalance, and "
        "fleet_failover) evaluated over the resident series store "
        "with multi-window burn-rate alerts — alert states export as "
        "simon_slo_* metrics and /healthz reasons",
    )
    p.add_argument(
        "--obs-cadence",
        type=float,
        default=1.0,
        metavar="SECONDS",
        help="telemetry sampling cadence: every counter/gauge, "
        "histogram percentile, and ledger level lands in the ring "
        "store (queryable at /v1/obs/series) once per cadence",
    )


def _add_store_flag(p: argparse.ArgumentParser):
    """Kernel-library store flag of the resident daemons
    (incremental/store.py): a warm store lets a fresh process answer
    its first request with no nvcc build."""
    p.add_argument(
        "--aot-store", default="", metavar="DIR",
        help="keep the built kernel libraries in this directory and load "
        "them at startup (content-addressed by source and toolchain: "
        "the nvcc version, its flags and the arch; torn, corrupt or "
        "mismatched entries are refused loudly and rebuilt; "
        "SIMON_AOT_STORE is the flagless form)",
    )


def _arm_store(args) -> None:
    """Configure the process-wide kernel-library store from --aot-store
    BEFORE the first library load (the daemon's committed scan or its
    mirror's first probe)."""
    store_dir = getattr(args, "aot_store", "")
    if store_dir:
        from .incremental.store import configure_store

        configure_store(store_dir)


def _add_inject_flag(p: argparse.ArgumentParser):
    """Chaos fault-injection flag shared by the guarded commands
    (runtime/inject.py)."""
    p.add_argument(
        "--inject",
        default="",
        metavar="SPEC",
        help="arm deterministic fault injection at the named guard "
        "seams (equivalent to SIMON_INJECT). SPEC is ';'-separated "
        "SITE=FAULT[:PARAM][@N][xCOUNT][%%EVERY][~PROB] clauses, e.g. "
        "'jit.scenario_scan=oom@2' (device OOM at the 2nd dispatch) or "
        "'io.kube*=reset@1x3' (3 connection resets). Sites (the JAX "
        "package's names): jit.<site> (scan, sweep_probe, sweep_many, "
        "<site>_sweep, defrag_sweep, scenario_scan, stream_bench: a "
        "launch), io.<label>, journal.fsync.<subsystem>, budget.check, "
        "ledger.predict_fit, serve.tick, incremental.suffix, ckpt.*, "
        "aot.store_load, fleet.replay, twin.poll, twin.apply_delta. "
        "Production paths are unmodified when unset",
    )


def _arm_injection(args) -> None:
    """Arm the injector from --inject (overriding any SIMON_INJECT the
    process imported with). Bad specs raise InputError -> exit 2,
    including a malformed SIMON_INJECT the import stashed instead of
    crashing on (runtime/inject.py IMPORT_SPEC_ERROR)."""
    from .runtime import inject as _inject

    spec = getattr(args, "inject", "")
    if spec:
        _inject.INJECT.configure(spec)
    elif _inject.IMPORT_SPEC_ERROR is not None:
        # the stashed value IS an InputError (taxonomy-rooted); the
        # lint cannot see through the variable
        raise _inject.IMPORT_SPEC_ERROR  # simonlint: disable=EXC001


def _add_guard_flags(p: argparse.ArgumentParser):
    """Execution-guard flags shared by the long-running commands:
    fault injection, wall-clock budget and the resumable journal."""
    _add_inject_flag(p)
    p.add_argument(
        "--deadline",
        type=float,
        default=None,
        metavar="SECONDS",
        help="wall-clock budget: on expiry (or SIGINT) the run stops at "
        "the next safe boundary and emits a machine-readable PARTIAL "
        "report (exit 3 deadline / 4 interrupt) instead of a traceback",
    )
    p.add_argument(
        "--journal",
        default="",
        metavar="PATH",
        help="append completed probe results and scenario verdicts to "
        "this crash-safe JSONL journal (created when missing, continued "
        "when it matches this run's config fingerprint)",
    )
    p.add_argument(
        "--resume",
        default="",
        metavar="PATH",
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
    try:
        _arm_injection(args)
    except ValueError as e:  # InputError: a typo'd --inject is exit 2
        print(f"error: {e}", file=sys.stderr)
        return 2
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
