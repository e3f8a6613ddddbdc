"""simon-compatible CLI of the GPU port: the `apply` subcommand.

  python -m open_simulator_tpu_torch.cli apply -f <simon-config.yaml>
        [--format table|json] [--extended-resources gpu,open-local]
        [--engine cuda|oracle] [--device DEVICE] [--no-sweep]
        [--use-greed] [--default-scheduler-config FILE] [--trace]

Mirrors the JAX package's `simon apply` (cli.py cmd_apply), whose JSON
report this one reproduces byte for byte. The capacity plan runs on the
card unless `--device cpu` is given (the kernels' plain versions);
without a card the default exits 2 with the "needs a GPU" error. Log
level comes from the LogLevel env var (cmd/simon/simon.go:60-80).

Not ported yet (ROADMAP.md A1): the interactive shell (-i), snapshots,
explain, mesh, deadline/journal and observability flags, and every
other subcommand.
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
    p_apply.add_argument(
        "--device",
        default=None,
        help="torch device of the scans (default: the CUDA card; `cpu` runs "
        "the kernels' plain PyTorch versions)",
    )
    p_apply.add_argument(
        "--no-sweep", action="store_true", help="disable the batched capacity sweep"
    )
    p_apply.add_argument(
        "--format", choices=["table", "json"], default="table", help="result output format"
    )
    p_apply.add_argument(
        "--trace",
        action="store_true",
        help="print per-phase wall-clock JSON to stderr",
    )
    p_apply.set_defaults(func=cmd_apply)
    return parser


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
