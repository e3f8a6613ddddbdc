"""Interactive capacity-planning shell.

Mirrors the reference's survey-driven flow (pkg/apply/apply.go):
- app multi-select before planning (apply.go:157-173)
- the per-iteration capacity loop: simulate with N new nodes; while
  pods stay unschedulable, ask
  {show error event of unscheduled pods | add node(s) | exit}
  (apply.go:186-239, option strings apply.go:33-35)
- node multi-select before the report (reportNodeInfo,
  apply.go:510-530) narrowing the Pod Info table

Each iteration is NOT a full re-simulation. When the batched sweep is
available, the padded cluster is encoded once (parallel/sweep.py
CapacitySweep) and each user guess is one masked scan on the sweep's
device: one launch of the fused-scan kernel on the card (the torch scan
for a batch the kernel does not carry). Priority workloads and
extenders take a serial simulate() per guess, the reference's cost
model, on the Applier's engine and device.

Deviation (documented): in the reference, a plan whose pods all fit but
whose utilization caps fail loops forever re-printing the reason
(apply.go:230-238 has no prompt on that path). Here the same
{add node(s) | exit} menu appears so the shell stays usable.

The prompts are plain-text numbered menus over stdin/stdout (the
`survey` TUI has no Python counterpart here), injectable for scripted
tests.

The port's counterpart of the JAX package's apply/interactive.py.
"""

from __future__ import annotations

import sys
from typing import List, Optional

SURVEY_ADD_NODE = "add node(s)"
SURVEY_SHOW_RESULTS = "show error event of unscheduled pods"
SURVEY_EXIT = "exit"


class Shell:
    """Plain-text prompt driver (injectable stdin/stdout for tests)."""

    def __init__(self, fin=None, fout=None):
        self.fin = fin or sys.stdin
        self.fout = fout or sys.stdout

    def say(self, msg: str = ""):
        print(msg, file=self.fout)

    def _read(self) -> str:
        line = self.fin.readline()
        if not line:  # EOF: behave like survey's ^C -> exit
            return ""
        return line.strip()

    def ask_select(self, message: str, options: List[str]) -> str:
        """Single-choice menu; accepts an index or the exact option
        text. EOF or unparseable input selects the last option (exit)."""
        self.say(message)
        for i, opt in enumerate(options):
            self.say(f"  [{i}] {opt}")
        self.fout.write("> ")
        self.fout.flush()
        raw = self._read()
        if raw in options:
            return raw
        try:
            return options[int(raw)]
        except (ValueError, IndexError):
            return options[-1]

    def ask_multiselect(self, message: str, options: List[str]) -> List[str]:
        """Multi-choice: comma-separated indices or names; empty = all."""
        self.say(message)
        for i, opt in enumerate(options):
            self.say(f"  [{i}] {opt}")
        self.fout.write("(comma-separated indices, empty = all) > ")
        self.fout.flush()
        raw = self._read()
        if not raw:
            return list(options)
        picked = []
        for tok in raw.split(","):
            tok = tok.strip()
            if tok in options:
                picked.append(tok)
                continue
            try:
                picked.append(options[int(tok)])
            except (ValueError, IndexError):
                continue
        return picked or list(options)

    def ask_int(self, message: str) -> Optional[int]:
        self.fout.write(f"{message}: ")
        self.fout.flush()
        raw = self._read()
        try:
            return int(raw)
        except ValueError:
            return None


class _ProbeEvaluator:
    """One masked scan per guess over the once-encoded padded cluster."""

    def __init__(self, sweep):
        self.sweep = sweep

    def evaluate(self, count: int):
        from .applier import replay_scenario

        res = self.sweep.probe(count)
        result, _ = replay_scenario(self.sweep, count, res.placements)
        return result


class _SerialEvaluator:
    """Full simulate() per guess (priority workloads, extenders, or
    encode failures) — the reference's per-iteration cost model."""

    def __init__(self, applier, cluster, apps, new_node):
        self.applier = applier
        self.cluster = cluster
        self.apps = apps
        self.new_node = new_node

    def evaluate(self, count: int):
        from ..models.workloads import reset_name_counter

        reset_name_counter()
        return self.applier._simulate_with_count(
            self.cluster, self.apps, self.new_node, count
        )


def _make_evaluator(applier, cluster, apps, new_node):
    if new_node is not None and applier.engine == "cuda" and applier.use_sweep:
        from ..parallel.sweep import CapacitySweep, PrioritySignalError
        from ..utils.trace import GLOBAL
        from .applier import MAX_NUM_NEW_NODE

        try:
            return _ProbeEvaluator(
                CapacitySweep(
                    cluster,
                    apps,
                    new_node,
                    MAX_NUM_NEW_NODE,
                    use_greed=applier.use_greed,
                    score_weights=applier.score_weights,
                    device=applier.device,
                )
            )
        except PrioritySignalError as e:
            # expected: priority workloads / stateful plugins plan
            # serially per guess, the reference's cost model
            GLOBAL.note("interactive-evaluator", f"serial per guess: {e}")
    return _SerialEvaluator(applier, cluster, apps, new_node)


def run_interactive(applier, shell: Optional[Shell] = None, max_iterations: int = 1000):
    """The `-i` flow. Returns an ApplyResult."""
    from .applier import ApplyResult, satisfy_resource_setting
    from .report import report

    if getattr(applier, "tolerate_node_failures", 0) > 0:
        from ..models.validation import InputError

        # the guess-a-count loop has no N+K escalation; silently
        # returning an unvetted plan would let the user believe it
        # survives K failures
        raise InputError(
            "--tolerate-node-failures is not available in interactive "
            "mode; run the one-shot plan (drop -i) or `simon chaos`"
        )
    shell = shell or Shell()

    from ..utils.trace import phase

    with phase("apply/load"):
        cluster = applier.load_cluster()
        applier.last_cluster = cluster
        apps = applier.load_apps()
        new_node = applier.load_new_node()

    # app multi-select (apply.go:157-173)
    if apps:
        names = [a.name for a in apps]
        chosen = set(shell.ask_multiselect("Confirm your apps :", names))
        apps = [a for a in apps if a.name in chosen]

    evaluator = _make_evaluator(applier, cluster, apps, new_node)

    count = 0
    result = None
    for _ in range(max_iterations):
        result = evaluator.evaluate(count)
        if result.unscheduled_pods:
            choice = shell.ask_select(
                f"there are still {len(result.unscheduled_pods)} pod(s) that "
                f"can not be scheduled when add {count} nodes, you can:",
                [SURVEY_SHOW_RESULTS, SURVEY_ADD_NODE, SURVEY_EXIT],
            )
            if choice == SURVEY_SHOW_RESULTS:
                for i, up in enumerate(result.unscheduled_pods):
                    meta = up.pod.get("metadata") or {}
                    shell.say(
                        f"{i:4d} {meta.get('namespace', 'default')}/"
                        f"{meta.get('name', '')}: {up.reason}"
                    )
                from ..obs.explain import EXPLAIN

                if EXPLAIN.enabled:
                    # `simon apply -i --explain`: the per-node verdict
                    # tables recorded during this iteration's replay
                    from ..obs.explain import render_explanations

                    shell.say(render_explanations())
            elif choice == SURVEY_ADD_NODE:
                if new_node is None:
                    shell.say("no newNode spec configured; cannot add nodes")
                    continue
                num = shell.ask_int("input node number")
                if num is not None and num >= 0:
                    count = num
            else:  # exit
                return ApplyResult(
                    success=False,
                    new_node_count=count,
                    result=result,
                    message="exited by user with unscheduled pods",
                )
            continue
        ok, reason = satisfy_resource_setting(result.node_status)
        if not ok:
            shell.say(reason)
            choice = shell.ask_select(
                f"utilization caps not met with {count} new node(s), you can:",
                [SURVEY_ADD_NODE, SURVEY_EXIT],
            )
            if choice == SURVEY_ADD_NODE and new_node is not None:
                num = shell.ask_int("input node number")
                if num is not None and num >= 0:
                    count = num
                continue
            return ApplyResult(
                success=False, new_node_count=count, result=result, message=reason
            )
        break
    else:  # pragma: no cover - loop bound safety
        return ApplyResult(
            success=False,
            new_node_count=count,
            result=result,
            message="interactive loop exceeded max iterations",
        )

    # node multi-select before the report (apply.go:510-530)
    node_names = [
        (ns.node.get("metadata") or {}).get("name", "") for ns in result.node_status
    ]
    selected = set(
        shell.ask_multiselect("select nodes that you want to report:", node_names)
    )
    report_text = report(
        result.node_status, applier.extended_resources, select_nodes=selected
    )
    return ApplyResult(
        success=True, new_node_count=count, result=result, report_text=report_text
    )
