#!/usr/bin/env python3
"""Smoke test of the GPU port (open_simulator_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no `ok` line):

1. build the CUDA kernels from the checkout's two sources (one nvcc for
   each, sm_90a, started together) and print each instantiation's
   registers and spills; each of the 22 instantiations' static shared
   memory must be at most what the wrapper counts beside a resident
   slice;
2. B1 on the default scenario (10,000 nodes x 20,000 pods in 5 classes,
   seed 0 — every 11th node tainted, one class with a nodeSelector, one
   with tolerations): the kernel and its plain PyTorch version on the
   same plan on the card, identical placements and final int64 state;
   time both; then the kernel on clusters of 1, 8 and 16 blocks (the
   private launcher) beside the rule's choice, each == plain, in us a
   pod step;
3. the base main path, `simulate(cluster, apps, engine="cuda")`, on that
   scenario with the launch counters at 0: the kernel ran, the trace
   names it and its cluster size, and all 20,000 pods were placed where
   phase 2's plain version placed them;
4. B2: (a) GPU-share at 1,000 nodes of 8 x 32 Gi devices and 10,000
   pods (4/8/16/32 Gi single-GPU and 16 Gi two-GPU asks), kernel ==
   plain including the per-device GPU rows, then `simulate(engine=
   "cuda")` on it with the counters at 0, placed as the plain version
   placed; (b) hostPorts plus an extended resource on the 10,000-node
   scenario with 10% of the pods each (the pod count cut to 10,000 to
   keep the plain loop short), kernel == plain including the port and
   scalar rows;
5. B6 at 10,000 nodes x 20,000 pods: three scenarios (all nodes; the
   last 10% off; every 7th off with 10% of the pods inactive) in one
   batch launch, equal to the batch plain version and to one
   `fused_scan_base` launch per scenario;
6. the slice's path at full width: a 10,000-node x 100,000-pod capacity
   plan written as a simon config and run through the port's CLI
   (`apply -f cfg --format json`) with the counters at 0. It must
   succeed, launch the single and the batch kernel, be minimal, and
   answer the JAX package's new-node count. Every scan the plan ran
   (placements and final rows) must equal the plain version on its
   scenarios, a batch launch of those scenarios must too, and every
   probe pair must equal single-kernel launches; B6's entry in the
   `kernels` line (time by CUDA events, plain time, bound) is that
   batch launch, which then runs again on one block a scenario;
7. B3 (`fused_scan_store`) on bench.py's storage scenario (10,000 nodes
   with 2 VGs, an SSD and an HDD; 20,000 pods with 1-3 LVM volumes or
   an exclusive device): kernel == plain, placements and every row
   (VG usage and device bits included), then `simulate(engine="cuda")`
   on it; then the 6-VG shape (past the TPU plan's 4-VG cap), kernel ==
   plain. Phases 7-10 also run their instantiation at the rule's
   cluster size and on one block a scenario (the private launcher),
   each == plain, in us a scanned pod step;
8. B4 (`fused_scan_terms`) on the affinity stress (10,000 nodes in 16
   zones, 100 StatefulSets x 100 replicas with hostname anti-affinity,
   hard zone spread, soft hostname spread and preferred zone affinity):
   kernel == plain including every value-space term row, then
   `simulate(engine="cuda")`;
9. B5: the same block on the same stress at 25,000 nodes (where the
   JAX package streams its term state), kernel == plain, then
   `simulate(engine="cuda")`;
10. every block in one plan (bench.py's conformance mix: terms, ports,
    scalars, pins, storage, more than 128 classes, a zone soft spread
    and a required affinity group) as one launch and as a batch of
    three node masks, both == the plain version;
11. the slice's path: `apply -f example/simon-config.yaml --format
    json` through the port's CLI on the card, byte-identical to its
    `--device cpu` run and planning the JAX package's +1 with the
    storage-and-terms kernel; then a full-width plan (10,000 storage
    nodes in 16 zones, the `hello` chart, the stress at 50 replicas, an
    LVM StatefulSet and a Deployment that fits only new nodes) that
    must plan the JAX package's count. Every scan either plan ran (its
    single probes and its pairs) == the batch plain version;
12. B7, the streaming-bandwidth probe: its entry point `run()` at the
    TPU tool's four sizes (8, 16, 32 and 64 MiB of int32 state) with
    the launch counter at 0, the kernel == its plain version exactly at
    each size, the 64 MiB size timed beside the plain version, its
    bound and one `torch.amax` over the same bytes; then a scan-step
    probe (the six int64 state rows of B1 at 10,000 nodes, 20,000
    steps) in microseconds a step;
13. A2, the eager torch scan: `simulate(engine="cuda",
    select_host="sample")` with a min-max custom score plugin on the
    default scenario's 10,000 nodes, with the counters at 0: it runs on
    the torch scan on CUDA tensors (the trace notes) and launches no
    fused kernel, equals the same call with `device="cpu"` (placements,
    node status, unscheduled reasons, the RNG's 607-word history) and
    the JAX package's digest (tools/jax_sample_answer.py);
14. the 8-spec what-if (bench.py run_whatif's specs) on the capacity
    scenario through `probe_plan_multi` on the card with the counters
    at 0: one batch launch a live spec a round; every spec's count ==
    its single-spec search, the 96-cpu spec's whole result (report,
    placements) == its `probe_plan`, and that spec plans the JAX
    package's +55;
15. phase 6's plan through the CLI with `--journal` (and `--snapshot`),
    then `--resume`: the resume launches no kernel and prints the same
    JSON;
16. defrag: (a) bench.py run_defrag's shape (1,000 nodes x 6,000 pods,
    max_drain 16) through `plan_defrag`, the 17 depths in one batch
    launch, every row == plain; (b) `simon defrag --max-drain 100` on
    phase 15's snapshot of the capacity plan (10,055 nodes x 100,000
    pods): 101 depths in one launch, the chosen depth validated by the
    module's replay, depths 0, chosen and chosen + 1 == plain;
17. outages on the pins-first mode of the batch kernel: (a) `simon
    chaos --failures 0` (the replacement study) on the capacity
    scenario, its row == plain over its first 5,000 pods; (b) `simon
    chaos --failures 2 --trials 32` on the capacity shape cut to 2,000
    nodes x 20,000 pods (about 2,040 scenarios in one launch): three
    rows == plain, the worst outage re-simulated serially to the same
    verdict, us a pinned and a free pod step; then the same command on a
    500 x 5,000 cut prints the JAX package's bytes
    (tools/jax_chaos_answer.py); (c) `apply --tolerate-node-failures 1`
    on the 2,000-node cut (serial confirmation noted ok), and on the
    500-node cut the JAX package's bytes;
18. A1g: a capacity plan with a custom min-max score plugin (the
    capacity shape cut to 100 nodes x 1,000 pods) through the CLI: its
    probes ride the torch scan, no fused kernel launches, and stdout ==
    the JAX package's bytes (tools/jax_custom_plan_answer.py);
19. A1e: a live cluster (the capacity shape's 10,000 nodes, 20,000
    Running pods bound to them, and DaemonSet-owned, Pending and
    terminating pods the import must drop, with a PDB, a service, a
    storage class and a PVC) served by a stub apiserver on 127.0.0.1 in
    a thread, paged at 500 with one continue answered 410, planned with
    the capacity apps through `apply --format json --trace-out` with the
    counters at 0: the report == the same cluster as a customConfig
    directory; one `launch/<site>` span a launch; the observatory block
    holds costs, ledger and histograms; the launch counter == the
    kernels' launches;
20. phase 6's plan under the guard flags: `--journal --inject
    budget.check=deadline@2` exits 3 with a PARTIAL JSON and `--resume`
    answers +55 launching only what the journal lacks; `-i` on a
    scripted shell prints that table report, one launch a guess;
    `--inject jit.sweep_many=oom@1 --explain NS/NAME` halves the batch
    launch and answers phase 6's JSON, the pod's chosen node its node
    in the report and its verdicts covering every node;
21. the quickstart with `--explain POD --profile-dir DIR`: stdout == the
    JAX package's (tools/jax_explain_answer.py), and the captures name
    the fused-scan kernel;
22. the timeline (`simon timeline`) on the default scenario's 10,000
    nodes with a day-0 pod bound to every untainted node (TL_FREE_CPU
    cores left free on each) and the capacity scenario's 96-cpu new node
    as a pool of 64 candidates: a synthetic trace of 20,000 arrivals
    (TL_FLAGS) through static:0, threshold and probe with the counters
    at 0. Every window and probe decision is one pins-first launch of
    the batch kernel (launches == `launches_timeline_sweep` == the
    report's dispatches), threshold and probe scale up, static:0 ends
    with pods pending, no trace note reports a downgrade; the first
    window's launch == run_fused_scan_batch on the CPU plain version;
    at two cuts the report == the JAX package's
    (tools/jax_timeline_answer.py, engine aside), at the smaller one
    the port's serial oracle's too;
23. the shadow auditor (`simon shadow`) on the same nodes: `--record` of
    the default pods' first SHADOW_DECISIONS decisions on the serial
    oracle, then `--decision-log` on the card with the counters at 0:
    agreement 1.0, one `fused_scan_base` launch a decision, zero nvcc
    builds; `timeline --from-decision-log` over the log; at a cut the
    log's bytes and the replay report == the JAX package's
    (tools/jax_shadow_answer.py, the engine and compiler fields aside);
24. the what-if daemon (`simon serve`'s Session and ServeDaemon, in this
    process) on SERVE_NODES nodes of 64 cores and 256 GiB in 8 zones:
    (a) SERVE_PODS bare pods committed on the card (one B1 launch), then
    8 evictions near the tail and 8 arrivals through
    `Session.apply_delta`, each a suffix re-simulation (one B1 launch):
    every delta applied, suffix pods x 20 < deltas x roster, the
    re-simulated state == a fresh committed scan, the committed scan ==
    B1's plain version over its first SERVE_PLAIN_PODS pods; (b) an
    in-process daemon (--max-batch 8) under a warm and a measured storm
    of 8 client threads x 6 POST /v1/simulate of a 50-replica
    Deployment, then POST /v1/cluster-delta, GET /v1/state-digest and a
    what-if: every reply 200, fewer ticks than requests, one
    `scenario_scan` launch of the batch kernel a tick (== the dispatch
    counter), the first tick's launch == run_fused_scan_batch on the CPU
    plain version, 4 sampled bodies and the what-if == a standalone
    simulate(engine="cuda"); qps, latency, launches a request, the
    launches' card time by CUDA events and the host phases; (c) a cut
    of 500 nodes x 2,000 pods through the same daemon, two ticks around
    four deltas over HTTP: the bodies and state digests == the JAX
    package's (tools/jax_serve_answer.py);
25. the kernel-library store (incremental/store.py) and the library key
    (utils/nvcc.py: source, nvcc version, FLAGS, arch) in three
    subprocesses sharing one store, each with an empty build directory
    and one B1 launch at 10,000 nodes x 1,000 pods == the plain version:
    the first builds with nvcc and fills the store, the second loads it
    (0 nvcc builds), the third, after a byte of the stored payload is
    flipped, refuses it (1 reject), builds once and saves it again; the
    time to each first launch;
26. serve failover: a daemon in a subprocess (phase 24's cluster, the
    store armed, a checkpoint every 5 deltas) takes 8 deltas and a
    what-if, then SIGKILL; `simon serve -f cfg --snapshot S
    --replay-snapshot --aot-store D` (the cluster written as a
    customConfig, an empty build directory) restores the checkpoint and
    replays the journal's suffix: its state digest and first answer ==
    the dead daemon's, 0 nvcc builds, one restore, replayed deltas == the
    suffix, `simon top --once` and `--format json` against it exit 0;
27. the digital twin (`simon twin`'s ClusterMirror and TwinDaemon, in
    this process) on the default scenario's 10,000 nodes with 20,000
    bound pods: the feed (the bound pods and 16 decisions, recorded on
    the serial oracle) tailed at --feed-batch 64 at agreement 1.0, one B1
    launch a decision; over HTTP a what-if of 50 replicas (one B1 launch
    == its plain version), a drain of a zone by selector (one launch),
    N+K at k=1 over 4 trials (one launch a trial), a forecast (one
    pins-first launch a window that places pods); 0 nvcc builds; at a cut
    of 500 nodes x 1,000 bound pods the what-if and drain answers == the
    oracle engine's and everything == the JAX package's
    (tools/jax_twin_answer.py);
28. the serve fleet (`simon fleet`, a subprocess; its replicas port
    `simon serve` subprocesses on the card) in front of phase 24's
    cluster, with 1 and then 2 replicas, each in a fresh fleet directory:
    r0 builds the kernel library into the fleet's store, r1 loads it; a
    warm storm, then 8 clients x 4 POSTs of a 50-replica Deployment with
    the tenants balanced over the slots (qps, p50/p95); on 2 replicas a
    delta for a tenant of r0, r0 killed with SIGKILL in the middle of a
    storm: every reply 200 or 429/503 with Retry-After and its own
    request id, the rerouted first 200 == the survivor's answer, the
    respawned replacement 0 nvcc builds with the dead replica's state
    digest (deltaSeq 1), the audit log valid, `simon top --fleet`
    exits 0, each replica's B6 launches == its ticks + its warm-up;
29. the device mesh (parallel/mesh.py), in the second lane: (a) `apply`
    on the quickstart with `--mesh auto`, `--mesh 1` and SIMON_MESH=auto
    == the bytes with no mesh, `--mesh 2` on one card exits 2 with the
    JAX package's message; (b) on a 2-shard mesh of cuda:0 (one card
    repeated, the tests' seam): `probe_many` over 8 counts at phase 6's
    10,000 nodes x 100,000 pods is 2 B6 launches == the one-launch
    answer, `probe_scenarios` over 64 K=2 outage rows at phase 17b's
    2,000 x 20,000 is 2 pins-first launches == the unsharded launch, and
    `TorchEngine.scan_scenarios` over 16 request rows on phase 24's
    10,000 nodes x 20,000 pods is 2 launches == one; each a scenario-axis
    decision of the layout planner; (c) phase 18's custom-plugin batch
    at MESH_NODES nodes (the node threshold) x MESH_PODS pods through
    `TorchEngine.scan_active` on the node-sharded torch scan ==
    unsharded on the card == the plain path (the torch scan on the
    CPU), ms a pod step for each; (d) (b) and (c) again on a mesh of real
    cards where there are two or more, else one line saying so.

Phase 2 also times B1 through the instrumented wrapper against the bare
launcher in turns; phases 2-10 and 17b hold one launch of each
instantiation's counted workspace (obs/costs.py) at or above the
allocator's measured peak rise; phase 17b also runs under `--inject
ledger.predict_fit=lie:high` at its committed count: the rows split
before launch, the same report, no OOM caught.

Phases 14-27 fail the run when a trace note reports a downgrade or the
serial floor, unless the phase injected that fault, as do the CLI runs
of phases 6 and 11; phase 28 when a replica counts a failed, serial or
degraded tick.

    python3 chip_smoke.py --only 25,26,27

runs phase 1 and the named phases that stand alone (14, 17, 18, 19, 21,
22, 23, 24, 25, 26, 27, 28, 29), and prints no kernels or ok line.

Cuts that keep the script inside its time (the kernels always run every
pod; the plain version runs the first pods of a scan, whose placements
do not depend on the later pods): phase 4b 5,000 pods; phase 5's plain
check the first 5,000 pods; phases 7 and 8's the first 5,000 (cut
from 20,000 and 10,000 to make room for phases 14-18; their
kernels also run every pod); phase 6's the first 30,000 of each of the
plan's scans; phase 7b 2,000 pods; phase 9's the first 4,000 pods;
phase 13's pods 2,000 of the default scenario's 20,000 (the torch scan
is an eager loop of some hundred launches a pod step); phase 17b-c's
node count 10,000 -> 2,000 (single-node outages scale as nodes x pods)
and the JAX package's answers at 500 x 5,000 (there its vmapped XLA
scan takes 56 s and 101 s on a CPU; nodes x pods x scenarios grow 64-
fold to 2,000 x 20,000, so not run there); phase 17a's plain check the
first 5,000 pods; phase 18's 100 nodes x 1,000 pods (the torch scan);
phase 27's decisions 200 -> TWIN_DECISIONS.

Host work runs beside the card's phases, so that the script fits its
time with no further depth cut: phase 23's two decision logs and phase
27's feed are recorded on the serial oracle in subprocesses started
after phase 1; phases 14-19, 21, 22 and 29 run in a second process on
the card (`lane`, started after phase 13, its lines printed after phase
28's) beside phases 20 and 23-28 in this one; and phase 25's three
processes (each at a small scenario: the store does not depend on the
shape) run beside phases 20-24. Phases 14-28 share the card and the
host's cores with the other lane, so their times are those of a shared
machine.

The last lines are the card (nvidia-smi name and power limit), a JSON
`kernels` line (every fused-scan entry but the B2 one carries
`cluster`, the cluster size its main path ran, and `prev_ms`, the same
work on one block a scenario, timed in this run; the B3, B4 and B5
entries' `ms`, `bound_ms` and `prev_ms` are the launch over all pods,
their `plain_ms` the plain version over the first `plain_pods` and their
`prefix_ms` the kernel's on that cut; the
`fused_scan_store_terms` entry is phase 10's single launch with the
launches of phase 11's full-width plan; the `fused_scan_batch
(pins-first)` entry is phase 17b's launch, with phase 17's and phase
22's launches and its us a pinned and a free pod step; the
`fused_scan_base` entry's launches are phase 3's, 23's, 24's, 25's (the
subprocesses' own counts), 26's (the daemons' `scan` site), 27's and
28's (the fleet's replicas, at `scan`; the killed replica's as it read
just before the kill), the `fused_scan_batch` entry's phase 6's, 24's,
26's, 28's (at `scenario_scan`) and 29's (its sharded runs), the
pins-first entry's 17's, 22's, 27's and 29's, each entry's
`launches_by_phase` splits them), and
`{"ok": true, "device": {...}}`. It imports nothing of JAX and nothing of
the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_NODES = 10_000
N_PODS = 20_000
SEED = 0
GPU_NODES = 1_000
GPU_PODS = 10_000
MIXED_PODS = 5_000  # phase 4b, cut from 20,000 for the plain loop
# the plain version's pods in phases 5 and 6: the first this many of
# each scan (the kernel runs every pod; a scan's first pods do not
# depend on the later ones), to keep the script near 5 minutes
PHASE5_PLAIN_PODS = 5_000
CAP_PLAIN_PODS = 30_000
CAP_NODES = 10_000
CAP_PODS = 100_000
# new nodes the JAX package plans for the phase-6 scenario: its
# probe_plan on the XLA scan (CPU) answers +55, as its TPU benchmark
# records did (BENCH_r02-r05.json)
JAX_CAPACITY_ANSWER = 55
# phase 7: bench.py's storage scenario; the 6-VG storage-fallback shape
# with its pods cut from 20,000 for the plain loop
STOR_NODES = 10_000
STOR_PODS = 20_000
FALLBACK_VGS = 6
FALLBACK_PODS = 2_000
# phases 8 and 9: the affinity stress (100 StatefulSets x 100 replicas,
# 16 zones) at 10,000 nodes and at 25,000, where the JAX package streams
# its term state
AFF_NODES = 10_000
AFF_STS = 100
AFF_REPLICAS = 100
AFF_ZONES = 16
B5_NODES = 25_000
B5_PLAIN_PODS = 4_000  # phase 9's kernel-vs-plain, cut from 10,000
# phases 7 and 8's kernel-vs-plain, cut from 20,000 and 10,000 pods so
# that phases 14-18 fit the script's time (the kernel also runs all pods)
B3_PLAIN_PODS = 5_000
B4_PLAIN_PODS = 5_000
# phase 10: bench.py's conformance mix
FUZZ_NODES = 1_000
FUZZ_PODS = 2_000
# phase 11: the repo's quickstart, whose plan the JAX package's CLI
# answers with one new node, and the full-width plan
# (write_plan_config), for which tools/jax_plan_answer.py (the JAX
# package's CLI on its XLA scan, on a CPU) answers +50 for 6,102 pods
QUICKSTART = "example/simon-config.yaml"
JAX_QUICKSTART_ANSWER = 1
PLAN_NODES = 10_000
PLAN_REPLICAS = 50
PLAN_KV_REPLICAS = 1_000
PLAN_HEAVY_REPLICAS = 100
JAX_PLAN_ANSWER = 50
# phase 12: B7, the streaming probe at the TPU tool's four sizes, and a
# scan-step probe: the six int64 state rows of B1 at 10,000 nodes
# (480,000 bytes, 936 rows of 128 int32 lanes at block_rows 8) for
# 20,000 steps, beside B1's 38 us a pod step on one block
PROBE_BYTES = 6 * 8 * N_NODES
PROBE_BLOCK_ROWS = 8
PROBE_STEPS = 20_000
# phase 13: A2, the eager torch scan, on the default scenario's 10,000
# nodes with its pods cut from 20,000, a custom min-max score plugin and
# select_host="sample" on a GoRand(A2_SEED) stream; JAX_SAMPLE_ANSWER is
# the digest (a2_digest) of the JAX package's simulate(engine="tpu") on
# the same inputs, from tools/jax_sample_answer.py (its XLA scan on a
# CPU)
A2_PODS = 2_000
A2_SEED = 7
A2_APP = "a2"
JAX_SAMPLE_ANSWER = "4812b742297bc9d0f0a42fb91eddcc08d8f41de149ce0bacd2d1cd2403f14a9f"
# phase 14: the 8-spec what-if on the capacity scenario (bench.py
# run_whatif's specs: name, cpu, GiB); "c96" is phase 6's new node, for
# which the JAX package plans +55
WHATIF_SPECS = (("c16", 16, 64), ("c32", 32, 128), ("c48", 48, 192), ("c64", 64, 256),
                ("c96", 96, 384), ("m32", 32, 256), ("m64", 64, 512), ("c128", 128, 512))
# phase 16: bench.py run_defrag's shape (1,000 nodes of 32 cpu in 16
# zones, 6,000 nodeSelector-free pods of the default classes, dealt
# round-robin, max_drain 16), and the full-width drain of phase 15's
# snapshot of the capacity plan
DEFRAG_NODES = 1_000
DEFRAG_PODS = 6_000
DEFRAG_MAX = 16
DEFRAG_FULL_MAX = 100
# phase 17: outages. (a) the replacement study on the capacity scenario;
# (b) and (c) its shape cut to 2,000 nodes x 20,000 pods (single-node
# outages are nodes x pods), --failures 2 --trials 32; the JAX package's
# answers (tools/jax_chaos_answer.py, its XLA scan on a CPU) are for a
# smaller cut, CHAOS_JAX_NODES x CHAOS_JAX_PODS, on which chaos and N+1
# must print the JAX package's bytes (sha256 of stdout)
CHAOS_NODES = 2_000
CHAOS_PODS = 20_000
# phase 17a's plain check: the first this many pods of the replacement
# scan (every pod free: about 1.5 ms a plain step at 10,000 nodes)
CHAOS_PLAIN_PODS = 5_000
CHAOS_JAX_NODES = 500
CHAOS_JAX_PODS = 5_000
JAX_CHAOS_ANSWER = "10fa0a4686fc573b7cc6e5f45f1ee66f1b4426a38e40f9fb8c3bd326f241c48f"
JAX_NPLUSK_ANSWER = "280c47f34f8dd1fb433bb8ce111c778ebf81bc267ac46a0f58c57cf676930eaa"
# phase 19: A1e, a live cluster behind a stub apiserver: the capacity
# shape's nodes with this many Running pods bound to them, and for one
# bound pod in KUBE_DROP_EVERY a DaemonSet-owned, a Pending and a
# terminating pod the import must drop
KUBE_BOUND_PODS = 20_000
KUBE_DROP_EVERY = 50
# phase 21: the quickstart's pod whose placement --explain records, and
# the JAX package's stdout for it (tools/jax_explain_answer.py, sha256)
EXPLAIN_POD = "default/web-frontend-482d9673cf-9537f"
JAX_EXPLAIN_ANSWER = "433fdc2332ae03fc7b2bfd87fa397c2f318efbc6325d9aa618b1d934d12821f8"
# each phase's workspace estimate beside the allocator's measured peak
# rise (workspace_check), for the summary line
WORKSPACE = []
# phase 18: A1g, a capacity plan with a custom score plugin on the torch
# scan, the capacity shape cut to A1G_NODES x A1G_PODS; the JAX package's
# answer from tools/jax_custom_plan_answer.py (sha256 of stdout)
A1G_NODES = 100
A1G_PODS = 1_000
JAX_A1G_ANSWER = "26e7edb98805e7c69d5c09e6fd795ba07502490e4f9735969805be7f56c1a296"
# phase 2: the cluster sizes B1 runs at beside the rule's choice
PHASE2_CLUSTERS = (1, 8, 16)
# phase 22: the timeline on the default scenario's nodes, a day-0 pod
# bound to every untainted node that leaves it TL_FREE_CPU cores (and
# 4 GiB) free, and the capacity shape's 96-cpu new node as the candidate
# pool; the synthetic trace and the policies below. The JAX package's
# answers are for two cuts (tools/jax_timeline_answer.py, its XLA scan on
# a CPU; timeline_digest of its stdout): TL_JAX_NODES nodes and
# TL_JAX_ARRIVALS arrivals with TL_JAX_MAX_NODES candidates, which the
# port's cuda engine on the card must print, and a smaller one
# (TL_ORACLE_*) that the port's serial oracle prints too (the oracle
# re-schedules every pending pod of every window on the host, so it is
# held at the smaller cut)
TL_NODES = N_NODES
TL_ARRIVALS = 20_000
TL_FREE_CPU = 1
TL_FLAGS = ["--arrival-rate", "20", "--mean-lifetime", "300", "--long-running-frac", "0.7",
            "--spot-frac", "0.01", "--spot-hazard", "0.0005", "--seed", "11",
            "--compare", "static:0,threshold,probe", "--cadence", "60", "--warmup", "30",
            "--window-arrivals", "256"]
TL_MAX_NODES = 64
TL_JAX_NODES = 500
TL_JAX_ARRIVALS = 2_000
TL_JAX_MAX_NODES = 8
JAX_TIMELINE_ANSWER = "fc853f2c2202c683dde429b3aef685fc3cbace229cc8adc4b6f24a067325da0a"
TL_ORACLE_NODES = 60
TL_ORACLE_ARRIVALS = 300
TL_ORACLE_MAX_NODES = 2
JAX_TIMELINE_ORACLE_ANSWER = "9c0db1b0be0cbb2ce90c720f008113afbaa3cefee9f46b0120a5222ffb14add8"
# phase 23: the shadow auditor on the default scenario's nodes: `--record`
# of its first SHADOW_DECISIONS pods on the serial oracle, replayed on
# the card; the JAX package's answers (tools/jax_shadow_answer.py: the
# log's sha256 and shadow_digest of the replay report) for a cut of
# SHADOW_JAX_NODES nodes and SHADOW_JAX_DECISIONS pods
SHADOW_NODES = N_NODES
SHADOW_DECISIONS = 200
SHADOW_JAX_NODES = 500
SHADOW_JAX_DECISIONS = 1_000
JAX_SHADOW_LOG_ANSWER = "62fbd9fa2a04a4447b9d8fb3787a06fe4c96631b0a794058e7c21e3d7fdae4be"
JAX_SHADOW_ANSWER = "250ba829407fe5b662460d960f16153396e6c093da8bd30acc219ca4af83a58b"
# the report fields that name the engine or count its compiler, set aside
# when a shadow report is held against the JAX package's
SHADOW_ASIDE = ("engine", "obs", "recompileSteps", "newShapeRecompiles", "warmRecompiles",
                "buildSteps", "newShapeBuilds", "warmBuilds")
# phase 24: the what-if daemon (bench.py run_delta_resim's committed scan
# and deltas, run_serve_qps's storms at this cluster): SERVE_NODES nodes
# of 64 cores and 256 GiB in SERVE_ZONES zones, SERVE_PODS bare pods of
# 500m / 1 GiB committed; SERVE_EVICTIONS evictions near the tail and
# SERVE_ARRIVALS arrivals; SERVE_CLIENTS threads x SERVE_PER_CLIENT
# POSTs of a SERVE_REPLICAS-replica Deployment at --max-batch
# SERVE_MAX_BATCH; the committed scan held against B1's plain version
# over its first SERVE_PLAIN_PODS pods; SERVE_SAMPLES bodies against a
# standalone simulate(). The JAX package's answer
# (tools/jax_serve_answer.py) for the cut of SERVE_JAX_NODES nodes x
# SERVE_JAX_PODS pods: a tick of the SERVE_CUT_REQUESTS, two evictions
# and two arrivals over HTTP, the same requests again
SERVE_NODES = N_NODES
SERVE_PODS = N_PODS
SERVE_ZONES = 8
SERVE_EVICTIONS = 8
SERVE_ARRIVALS = 8
SERVE_EVICT_FROM = 19_200
SERVE_PLAIN_PODS = 5_000
SERVE_CLIENTS = 8
SERVE_PER_CLIENT = 6
SERVE_REPLICAS = 50
SERVE_MAX_BATCH = 8
SERVE_SAMPLES = 4
SERVE_JAX_NODES = 500
SERVE_JAX_PODS = 2_000
# (replicas, cpu, memory, zone selector): one asks more cores than any
# node has, so its body carries the failure reasons
SERVE_CUT_REQUESTS = ((50, "500m", "1Gi", None), (20, "2", "4Gi", None),
                      (5, "100", "1Gi", None), (80, "250m", "512Mi", None),
                      (1, "8", "32Gi", None), (30, "1", "2Gi", "z3"),
                      (10, "4", "8Gi", None), (64, "500m", "1Gi", "z5"))
JAX_SERVE_ANSWER = "d06907cdcc28769b05b9e583d094f7c42071909fbc76a68fbac8405673ce9c3d"
# phase 25: the kernel-library store; each subprocess launches B1 once at
# STORE_NODES nodes x STORE_PODS pods of the default scenario and holds it
# against the plain version (the library does not depend on the shape)
STORE_NODES = 300
STORE_PODS = 200
# phase 26: serve failover on phase 24's cluster: FAILOVER_DELTAS deltas
# (evictions near the tail, then arrivals), a checkpoint every
# FAILOVER_INTERVAL, then SIGKILL and `serve --replay-snapshot`
FAILOVER_DELTAS = 8
FAILOVER_INTERVAL = 5
# phase 27: the digital twin on the default scenario's TWIN_NODES nodes
# with TWIN_BOUND pods of 250m / 512 MiB bound to them; a feed of the
# default pods' first TWIN_DECISIONS decisions (cut from 200 for the
# script's time: with the bound pods the recorder and the mirror's probe
# each cost ~0.4-0.5 s a decision at 10,000 nodes) tailed at
# TWIN_FEED_BATCH steps a poll; the queries: a what-if of a
# TWIN_WHATIF_REPLICAS-replica Deployment, a drain of zone TWIN_DRAIN_ZONE,
# N+K at k=1 over TWIN_NPLUSK_TRIALS trials, a forecast of
# TWIN_FORECAST_S seconds at one arrival a second stepped every 60 s.
# The JAX package's answer (tools/jax_twin_answer.py) for the cut of
# TWIN_JAX_NODES nodes x TWIN_JAX_BOUND bound pods and TWIN_JAX_DECISIONS
# decisions
TWIN_NODES = N_NODES
TWIN_BOUND = 20_000
TWIN_DECISIONS = 16
TWIN_FEED_BATCH = 64
TWIN_WHATIF_REPLICAS = 50
TWIN_DRAIN_ZONE = "z5"
TWIN_NPLUSK_TRIALS = 8
TWIN_FORECAST_S = 240
TWIN_JAX_NODES = 500
TWIN_JAX_BOUND = 1_000
TWIN_JAX_DECISIONS = 100
JAX_TWIN_ANSWER = "aa795ec5e84caaaaa19d5619272d44874e9df5e6d035f3ea06194db2b42a9a3e"
# phase 28: the serve fleet on phase 24's cluster (phase 26's config):
# `simon fleet` with 1 and then 2 replicas, each in a fresh fleet
# directory (its kernel-library store empty); FLEET_CLIENTS clients x
# FLEET_PER_CLIENT POSTs of a SERVE_REPLICAS-replica Deployment of 500m /
# 1 GiB pods (bench.py run_fleet_qps's request), the tenants balanced
# over the slots, one warm storm first;
# on the 2-replica fleet a delta journaled for a tenant of r0, then r0
# killed with SIGKILL once FLEET_KILL_AFTER replies of a storm are back.
# Both fleets start together (the 2-replica one idles while the other
# is measured), so their boots and nvcc builds overlap
# phase 29: the mesh. MESH_SHARDS shards of cuda:0; probe_many's
# MESH_COUNTS at phase 6's shape (around its answer, +55); MESH_ROWS of
# phase 17b's K=2 outage rows; MESH_REQUESTS request rows of
# SERVE_REPLICAS pods on phase 24's cluster; the node axis at
# MESH_NODES (the layout planner's node threshold) x MESH_PODS pods of
# phase 18's plugin, its CPU plain path over the first MESH_PLAIN_PODS
MESH_SHARDS = 2
MESH_COUNTS = tuple(range(51, 59))
MESH_ROWS = 64
MESH_REQUESTS = 16
MESH_NODES = 25_000
MESH_PODS = 200
MESH_PLAIN_PODS = 200
FLEET_CLIENTS = 8
FLEET_PER_CLIENT = 4
FLEET_WARM_PER_CLIENT = 1
FLEET_KILL_AFTER = 8
FLEET_PROBE_S = 0.5


# processes started beside the card's phases; any still running at exit
# is killed (atexit)
_CHILDREN: list = []


def start_child(root, label, fn, *args, env=None):
    """`python -c "chip_smoke.<fn>(*args)"` started now, its output in
    files under `root`; `wait_child` reads its last stdout line (JSON)."""
    import os

    out, err = (open(Path(root) / f"{label}.{k}", "w+") for k in ("out", "err"))
    code = f"import sys, chip_smoke; sys.exit(chip_smoke.{fn}(*sys.argv[1:]))"
    proc = subprocess.Popen([sys.executable, "-c", code, *map(str, args)], cwd=str(ROOT),
                            stdout=out, stderr=err, env=dict(os.environ, **(env or {})),
                            text=True)
    proc.files = (out, err)
    proc.label = label
    _CHILDREN.append(proc)
    return proc


def wait_child(proc, timeout=1200, echo=False):
    """(the child's last stdout line as JSON, its stderr); raises when it
    failed. With `echo` its other stdout lines are printed first (all of
    them when it failed)."""
    rc = proc.wait(timeout=timeout)
    out, err = proc.files
    out.seek(0)
    err.seek(0)
    stdout, stderr = out.read(), err.read()
    out.close()
    err.close()
    lines = stdout.strip().splitlines()
    if echo:
        print("\n".join(lines if rc else lines[:-1]), flush=True)
    if rc != 0:
        raise AssertionError(f"{proc.label}: exit {rc}: {stderr[-3000:]}")
    return json.loads(lines[-1]), stderr


@__import__("atexit").register
def stop_children():
    for proc in _CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


class Background:
    """`fn(*args)` in a daemon thread beside the card's phases; `result()`
    joins it and raises what it raised."""

    def __init__(self, fn, *args):
        import threading

        self._out: dict = {}
        self._thread = threading.Thread(target=self._run, args=(fn, args), daemon=True)
        self._thread.start()

    def _run(self, fn, args):
        try:
            self._out["value"] = fn(*args)
        except BaseException as e:  # re-raised by result()
            self._out["error"] = e

    def result(self):
        self._thread.join()
        if "error" in self._out:
            raise self._out["error"]
        return self._out["value"]


# phases 14-19, 21 and 22 run in a second process on the card beside the
# main one's 20 and 23-28: the host leads each of them (the card is idle
# most of the time), so the two lanes share the machine's cores instead
# of taking turns. LANE_KEEP: what the main process reads of each one's
# result (the rest stays in the lane)
LANE_B = ("14", "15", "16", "17", "18", "19", "21", "22", "29")
LANE_KEEP = {"14": ("launches", "rounds"), "16": ("launches",), "17": ("launches", "cut"),
             "19": ("launches",), "22": ("launches", "windows", "device_ms"),
             "29": ("batch_launches", "pins_launches")}


def lane(root, names) -> int:
    """Phases `names` (comma-separated, of LANE_B) in this process, in
    order, in the directory `root`; the last stdout line is {"walls":
    {phase: LANE_KEEP's part of its result}, "workspace": this process's
    WORKSPACE entries}."""
    import torch

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    gpu = card()
    runs = {"14": lambda w: phase14(gpu), "15": lambda w: phase15(gpu, root),
            "16": lambda w: phase16(gpu, w["15"]), "17": lambda w: phase17(gpu, root),
            "18": lambda w: phase18(gpu, root), "19": lambda w: phase19(gpu, root),
            "21": lambda w: phase21(gpu, root), "22": lambda w: phase22(gpu, root),
            "29": lambda w: phase29(gpu, root)}
    walls = {}
    for name in names.split(","):
        t0 = time.perf_counter()
        walls[name] = runs[name](walls)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s wall [{gpu}] (lane b)",
              flush=True)
        torch.cuda.empty_cache()
    keep = {k: {f: walls[k][f] for f in fields} for k, fields in LANE_KEEP.items()
            if k in walls}
    print(json.dumps({"walls": keep, "workspace": WORKSPACE}, default=lambda o: o.item()),
          flush=True)
    return 0


# host-only inputs, recorded on the serial oracle in subprocesses that
# see no card: name -> (function, its arguments after `root`)
PREP_TASKS = {
    "shadow-full": ("prep_shadow", ("shadow-full", SHADOW_NODES, SHADOW_DECISIONS)),
    "shadow-cut": ("prep_shadow", ("shadow-cut", SHADOW_JAX_NODES, SHADOW_JAX_DECISIONS)),
    "twin-feed": ("prep_twin_feed", ()),
    "failover-config": ("prep_failover_config", ()),
}
_PREP: dict = {}


def start_prep(root, names=tuple(PREP_TASKS)) -> None:
    """Start the named host-only input tasks now, beside what follows."""
    for name in names:
        fn, args = PREP_TASKS[name]
        _PREP[name] = start_child(root, f"prep-{name}", fn, root, *args,
                                  env={"CUDA_VISIBLE_DEVICES": ""})


def prepared(root, name) -> dict:
    """The JSON line of input task `name`: waited for if it was started
    beside the earlier phases, else run now."""
    if name not in _PREP:
        start_prep(root, (name,))
    return wait_child(_PREP.pop(name))[0]


def prep_shadow(root, tag, n_nodes, n_pods) -> int:
    """Phase 23's input: the shadow config of `n_nodes` x `n_pods` and
    `simon shadow --record` of it on the serial oracle (no card)."""
    cfg = write_shadow_config(Path(root) / tag, int(n_nodes), int(n_pods))
    log = str(Path(root) / f"{tag}.jsonl")
    t0 = time.perf_counter()
    rc, out, err = run_cli(["shadow", "-f", cfg, "--record", log])
    print(json.dumps({"cfg": cfg, "log": log, "rc": rc, "out": out, "err": err[-3000:],
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


def prep_twin_feed(root) -> int:
    """Phase 27's feed: TWIN_BOUND bound pods' placements and
    TWIN_DECISIONS decisions recorded on the serial oracle (no card),
    written as a decision log."""
    from open_simulator_tpu_torch.models.decode import ResourceTypes
    from open_simulator_tpu_torch.models.workloads import reset_name_counter
    from open_simulator_tpu_torch.scheduler.core import AppResource
    from open_simulator_tpu_torch.shadow.log import DecisionLogWriter, cluster_fingerprint
    from open_simulator_tpu_torch.shadow.record import record_simulation

    nodes, bound, feed = twin_cluster(TWIN_NODES, TWIN_BOUND, TWIN_DECISIONS)
    cluster = ResourceTypes()
    cluster.nodes, cluster.pods = nodes, bound
    app = ResourceTypes()
    app.pods = feed
    t0 = time.perf_counter()
    reset_name_counter()
    steps = record_simulation(cluster, [AppResource("feed", app)])
    secs = time.perf_counter() - t0
    log = str(Path(root) / "twin-feed.jsonl")
    with DecisionLogWriter(log, cluster_fingerprint(cluster)) as w:
        for st in steps:
            w.append(st)
    print(json.dumps({"log": log, "seconds": secs}), flush=True)
    return 0


def prep_failover_config(root) -> int:
    """Phase 26's input: phase 24's cluster written as a customConfig."""
    t0 = time.perf_counter()
    cfg = write_serve_config(Path(root) / "failover")
    print(json.dumps({"cfg": cfg, "seconds": time.perf_counter() - t0}), flush=True)
    return 0


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def build_scenario(n_nodes=N_NODES, n_pods=N_PODS, seed=SEED, port_frac=0.0,
                   scalar_frac=0.0):
    """Node and pod dicts of the default scenario; `port_frac` /
    `scalar_frac` give that fraction of the pods a hostPort / an
    `example.com/accel` request (every node then offers 8 of it)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    nodes = []
    for i in range(n_nodes):
        cpu = int(rng.choice([16, 32, 64, 96]))
        name = f"node-{i:05d}"
        node = {
            "kind": "Node",
            "metadata": {
                "name": name,
                "labels": {"kubernetes.io/hostname": name, "zone": f"z{i % 16}"},
            },
            "status": {
                "allocatable": {"cpu": str(cpu), "memory": f"{cpu * 4}Gi", "pods": "110"}
            },
        }
        if i % 11 == 0:
            node["spec"] = {"taints": [
                {"key": "dedicated", "value": "infra", "effect": "NoSchedule"}
            ]}
        if scalar_frac:
            node["status"]["allocatable"]["example.com/accel"] = "8"
        nodes.append(node)
    classes = [
        ("small", "250m", "512Mi", None, False),
        ("medium", "1", "2Gi", None, False),
        ("large", "4", "8Gi", None, False),
        ("zonal", "500m", "1Gi", {"zone": "z3"}, False),
        ("tolerant", "2", "4Gi", None, True),
    ]
    pods = []
    for p in range(n_pods):
        name, cpu, mem, selector, tol = classes[p % len(classes)]
        spec = {
            "containers": [{
                "name": "c",
                "image": f"img-{name}",
                "resources": {"requests": {"cpu": cpu, "memory": mem}},
            }],
            "schedulerName": "default-scheduler",
        }
        if selector:
            spec["nodeSelector"] = selector
        if tol:
            spec["tolerations"] = [{"key": "dedicated", "operator": "Exists"}]
        if port_frac and p % max(int(1 / port_frac), 1) == 0:
            hp = 8000 + (p // 100) % 4
            spec["containers"][0]["ports"] = [
                {"containerPort": hp, "hostPort": hp, "protocol": "TCP"}
            ]
        if scalar_frac and p % max(int(1 / scalar_frac), 1) == 1:
            spec["containers"][0]["resources"]["requests"]["example.com/accel"] = "1"
        pods.append({
            "metadata": {"name": f"pod-{p:06d}", "namespace": "bench",
                         "labels": {"cls": name}, "annotations": {}},
            "spec": spec,
        })
    return nodes, pods


def build_gpushare_scenario(n_nodes=GPU_NODES, n_pods=GPU_PODS):
    """V100-style nodes (8 devices x 32 Gi) and a fragmentation mix of
    4/8/16/32 Gi single-GPU shares and 16 Gi two-GPU jobs."""
    gi = 1 << 30
    nodes = []
    for i in range(n_nodes):
        name = f"gpu-node-{i:04d}"
        nodes.append({
            "kind": "Node",
            "metadata": {"name": name, "labels": {"kubernetes.io/hostname": name},
                         "annotations": {}},
            # gpu-count/gpu-mem live in CAPACITY (the open-gpu-share codec)
            "status": {
                "allocatable": {"cpu": "64", "memory": "256Gi", "pods": "110"},
                "capacity": {"cpu": "64", "memory": "256Gi", "pods": "110",
                             "alibabacloud.com/gpu-count": "8",
                             "alibabacloud.com/gpu-mem": str(8 * 32 * gi)},
            },
        })
    shapes = [(4 * gi, 1), (8 * gi, 1), (16 * gi, 1), (32 * gi, 1), (16 * gi, 2)]
    pods = []
    for p in range(n_pods):
        mem, cnt = shapes[p % len(shapes)]
        pods.append({
            "metadata": {"name": f"gpu-pod-{p:05d}", "namespace": "bench", "labels": {},
                         "annotations": {"alibabacloud.com/gpu-mem": str(mem),
                                         "alibabacloud.com/gpu-count": str(cnt)}},
            "spec": {"containers": [{"name": "c", "image": "img-gpu",
                                     "resources": {"requests": {"cpu": "4",
                                                                "memory": "16Gi"}}}],
                     "schedulerName": "default-scheduler"},
        })
    return nodes, pods


def cap_node(name, cpu, mem_gi, labels=None, taints=None):
    """A node of the capacity scenario's shape."""
    out = {"kind": "Node", "metadata": {
        "name": name, "labels": {"kubernetes.io/hostname": name, **(labels or {})}},
        "status": {"allocatable": {"cpu": str(cpu), "memory": f"{mem_gi}Gi",
                                   "pods": "110"}}}
    if taints:
        out["spec"] = {"taints": taints}
    return out


def build_capacity_scenario(n_nodes=CAP_NODES, n_pods=CAP_PODS):
    """10,000 base nodes of 16 cpu / 64 Gi (every 23rd tainted) short of
    five Deployments of 20,000 replicas each, and a 96 cpu / 384 Gi new
    node: the planner must find the minimal new-node count. `n_nodes` /
    `n_pods` cut it to size."""
    taint = [{"key": "dedicated", "value": "infra", "effect": "NoSchedule"}]
    nodes = [cap_node(f"node-{i:05d}", 16, 64, {"zone": f"z{i % 16}"},
                      taint if i % 23 == 0 else None) for i in range(n_nodes)]

    def deploy(name, replicas, cpu, mem, tolerant=False):
        spec = {"containers": [{"name": "c", "image": f"img-{name}",
                                "resources": {"requests": {"cpu": cpu, "memory": mem}}}]}
        if tolerant:
            spec["tolerations"] = [{"key": "dedicated", "operator": "Exists"}]
        return {"kind": "Deployment",
                "metadata": {"name": name, "namespace": "bench", "labels": {"app": name}},
                "spec": {"replicas": replicas, "template": {"spec": spec}}}

    rep = n_pods // 5
    deployments = [
        deploy("memheavy", rep, "750m", "8Gi"),
        deploy("large", rep, "4", "8Gi"),
        deploy("medium", rep, "1", "2Gi"),
        deploy("small", rep, "250m", "512Mi"),
        deploy("tolerant", rep, "2", "4Gi", tolerant=True),
    ]
    return nodes, deployments, cap_node("template", 96, 384)


def write_capacity_config(root, n_nodes=CAP_NODES, n_pods=CAP_PODS) -> str:
    """The phase-6 scenario (cut to `n_nodes` x `n_pods`) as a simon
    config under `root`."""
    from pathlib import Path

    import yaml

    dumper = getattr(yaml, "CSafeDumper", yaml.SafeDumper)
    root = Path(root)
    nodes, deployments, new_node = build_capacity_scenario(n_nodes, n_pods)
    for sub, docs in (("cluster", nodes), ("app", deployments), ("newnode", [new_node])):
        (root / sub).mkdir()
        with open(root / sub / "objects.yaml", "w") as f:
            yaml.dump_all(docs, f, Dumper=dumper)
    cfg = root / "simon-config.yaml"
    cfg.write_text(yaml.safe_dump({
        "apiVersion": "simon/v1alpha1", "kind": "Config", "metadata": {"name": "capacity"},
        "spec": {"cluster": {"customConfig": str(root / "cluster")},
                 "appList": [{"name": "bench", "path": str(root / "app")}],
                 "newNode": str(root / "newnode")},
    }))
    return str(cfg)


GI = 1 << 30


def storage_anno(n_vgs):
    """The open-local annotation of bench.py's storage nodes: `n_vgs`
    VGs of 100 / 200 GiB, a 120 GiB SSD and a 500 GiB HDD."""
    return json.dumps({
        "vgs": [{"name": f"pool-{chr(ord('a') + v)}",
                 "capacity": str((100 + 100 * (v % 2)) * GI), "requested": "0"}
                for v in range(n_vgs)],
        "devices": [{"name": "/dev/vdb", "capacity": str(120 * GI), "mediaType": "ssd",
                     "isAllocated": "false"},
                    {"name": "/dev/vdc", "capacity": str(500 * GI), "mediaType": "hdd",
                     "isAllocated": "false"}],
    })


def build_storage_scenario(n_nodes=STOR_NODES, n_pods=STOR_PODS, n_vgs=2):
    """bench.py's storage scenario: 32 cpu / 128 GiB nodes with the
    storage of storage_anno; 90% of the pods bin-pack 1-3 LVM volumes,
    10% claim an exclusive SSD or HDD."""
    anno = storage_anno(n_vgs)
    nodes = [{"kind": "Node", "metadata": {
        "name": f"stor-node-{i:05d}", "labels": {"kubernetes.io/hostname": f"stor-node-{i:05d}"},
        "annotations": {"simon/node-local-storage": anno}},
        "status": {"allocatable": {"cpu": "32", "memory": "128Gi", "pods": "110"},
                   "capacity": {"cpu": "32", "memory": "128Gi", "pods": "110"}}}
        for i in range(n_nodes)]
    lvm = [[("LVM", 1)], [("LVM", 5)], [("LVM", 10), ("LVM", 2)],
           [("LVM", 8), ("LVM", 4), ("LVM", 1)]]
    dev = [[("SSD", 100)], [("HDD", 400)]]
    pods = []
    for p in range(n_pods):
        vols = dev[(p // 10) % 2] if p % 10 == 9 else lvm[p % 4]
        payload = {"volumes": [{"kind": k, "size": str(s * GI),
                                "scName": f"open-local-{k.lower()}"} for k, s in vols]}
        pods.append({
            "metadata": {"name": f"stor-pod-{p:06d}", "namespace": "bench", "labels": {},
                         "annotations": {"simon/pod-local-storage": json.dumps(payload)}},
            "spec": {"containers": [{"name": "c", "image": "kv", "resources": {
                "requests": {"cpu": "250m", "memory": "512Mi"}}}],
                "schedulerName": "default-scheduler"},
        })
    return nodes, pods


def affinity_nodes(n_nodes, zones, anno=None):
    """32 cpu / 64 GiB nodes in `zones` zones (the affinity stress's),
    with an open-local annotation when `anno` is given."""
    nodes = []
    for i in range(n_nodes):
        name = f"sn-{i:05d}"
        node = {"kind": "Node", "apiVersion": "v1", "metadata": {
            "name": name, "labels": {"kubernetes.io/hostname": name, "zone": f"z{i % zones}"},
            "annotations": {}},
            "status": {"allocatable": {"cpu": "32", "memory": "64Gi", "pods": "110"},
                       "capacity": {"cpu": "32", "memory": "64Gi", "pods": "110"}}}
        if anno is not None:
            node["metadata"]["annotations"]["simon/node-local-storage"] = anno
        nodes.append(node)
    return nodes


def affinity_stateful_sets(n_sts=AFF_STS, replicas=AFF_REPLICAS, namespace="stress"):
    """The affinity stress of the JAX package's testing.py: every
    StatefulSet has required hostname anti-affinity on its own app
    label and a hard zone spread (maxSkew 1); odd ones a soft hostname
    spread (maxSkew 2); every third one a preferred zone affinity
    (weight 50) to the previous StatefulSet's pods."""
    stss = []
    for s in range(n_sts):
        app = f"sts-{s:03d}"
        selector = {"matchLabels": {"app": app}}
        affinity = {"podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
            {"labelSelector": selector, "topologyKey": "kubernetes.io/hostname"}]}}
        if s % 3 == 2:
            affinity["podAffinity"] = {"preferredDuringSchedulingIgnoredDuringExecution": [
                {"weight": 50, "podAffinityTerm": {
                    "labelSelector": {"matchLabels": {"app": f"sts-{s - 1:03d}"}},
                    "topologyKey": "zone"}}]}
        spread = [{"maxSkew": 1, "topologyKey": "zone", "whenUnsatisfiable": "DoNotSchedule",
                   "labelSelector": selector}]
        if s % 2 == 1:
            spread.append({"maxSkew": 2, "topologyKey": "kubernetes.io/hostname",
                           "whenUnsatisfiable": "ScheduleAnyway", "labelSelector": selector})
        stss.append({
            "kind": "StatefulSet", "apiVersion": "apps/v1",
            "metadata": {"name": app, "namespace": namespace, "labels": {"app": app}},
            "spec": {"selector": {"matchLabels": {"app": app}}, "replicas": replicas,
                     "template": {"metadata": {"labels": {"app": app}}, "spec": {
                         "containers": [{"name": "c", "image": f"image-{app}", "resources": {
                             "requests": {"cpu": "500m", "memory": "1Gi"}}}],
                         "affinity": affinity, "topologySpreadConstraints": spread}}},
        })
    return stss


def expand(nodes, workloads, app="stress"):
    """Pods of StatefulSets in simulate()'s queue order (the port's
    workload expansion)."""
    from open_simulator_tpu_torch.models import workloads as wl
    from open_simulator_tpu_torch.models.decode import ResourceTypes
    from open_simulator_tpu_torch.scheduler.core import _sort_app_pods

    wl.reset_name_counter()
    res = ResourceTypes()
    res.stateful_sets = workloads
    return _sort_app_pods(wl.generate_valid_pods_from_app(app, res, nodes))


def build_fuzz_scenario(n_nodes=FUZZ_NODES, n_pods=FUZZ_PODS, seed=0):
    """bench.py run_conformance_fuzz's mix: the affinity stress over 20
    StatefulSets in 8 zones with hostPorts, an extended resource, pins
    and open-local volumes stamped on a tenth of the pods (each a class
    of its own: more than 128 classes), plus a zone-keyed ScheduleAnyway
    spread and a required zone affinity on some StatefulSets, so that the
    non-hostname soft path and the affinity-group path run."""
    import copy

    import numpy as np

    rng = np.random.RandomState(seed)
    nodes = affinity_nodes(n_nodes, 8)
    stss = affinity_stateful_sets(20, max(n_pods // 20, 1), "fuzz")
    for s, sts in enumerate(stss):
        spec = sts["spec"]["template"]["spec"]
        if s % 4 == 0:
            spec["topologySpreadConstraints"].append({
                "maxSkew": 2, "topologyKey": "zone", "whenUnsatisfiable": "ScheduleAnyway",
                "labelSelector": {"matchLabels": {"app": sts["metadata"]["name"]}}})
        if s % 5 == 4:
            spec["affinity"]["podAffinity"] = {"requiredDuringSchedulingIgnoredDuringExecution": [
                {"labelSelector": {"matchLabels": {"app": "sts-000"}}, "topologyKey": "zone"}]}
    pods = expand(nodes, stss, "fuzz")
    for node in nodes[: n_nodes // 2]:
        node["status"]["allocatable"]["example.com/accel"] = "4"
    anno = json.dumps({"vgs": [{"name": "a", "capacity": str(100 * GI), "requested": "0"}],
                       "devices": [{"name": "/dev/vdb", "capacity": str(120 * GI),
                                    "mediaType": "ssd", "isAllocated": "false"}]})
    for node in nodes[: n_nodes // 3]:
        node["metadata"]["annotations"]["simon/node-local-storage"] = anno
    for i, pod in enumerate(pods[:n_pods]):
        k = rng.randint(0, 40)
        if k > 3:
            continue
        pod["spec"] = spec = copy.deepcopy(pod["spec"])
        if k == 0:
            port = 9000 + int(rng.randint(0, 3))
            spec["containers"][0]["ports"] = [
                {"containerPort": port, "hostPort": port, "protocol": "TCP"}]
        elif k == 1:
            spec["containers"][0]["resources"]["requests"]["example.com/accel"] = str(1 + i % 4)
        elif k == 2:
            spec["nodeName"] = nodes[int(rng.randint(0, n_nodes))]["metadata"]["name"]
        else:
            vols = ([{"kind": "LVM", "size": str((1 + i % 8) * GI), "scName": "open-local-lvm"}]
                    if i % 3 else
                    [{"kind": "SSD", "size": str(60 * GI), "scName": "open-local-device-ssd"}])
            pod["metadata"] = meta = dict(pod["metadata"])
            meta["annotations"] = dict(meta.get("annotations") or {})
            meta["annotations"]["simon/pod-local-storage"] = json.dumps({"volumes": vols})
    return nodes, pods[:n_pods]


def plan_workloads():
    """The apps of the full-width plan, after the `hello` chart: the
    affinity stress at PLAN_REPLICAS replicas, a StatefulSet of open-local
    LVM volumeClaimTemplates (example/application/storage/sts-local.yaml's
    shape) and a Deployment whose pods fit no existing node (40 cpu on 32
    cpu nodes), so that the planner must add nodes."""
    kv = {"apiVersion": "apps/v1", "kind": "StatefulSet",
          "metadata": {"name": "kv-store", "namespace": "default"},
          "spec": {"serviceName": "kv", "replicas": PLAN_KV_REPLICAS,
                   "selector": {"matchLabels": {"app": "kv-store"}},
                   "template": {"metadata": {"labels": {"app": "kv-store"}}, "spec": {
                       "containers": [{"name": "kv", "image": "kv:5.2", "resources": {
                           "requests": {"cpu": "500m", "memory": "1Gi"}}}]}},
                   "volumeClaimTemplates": [{"metadata": {"name": "data"}, "spec": {
                       "accessModes": ["ReadWriteOnce"], "storageClassName": "open-local-lvm",
                       "resources": {"requests": {"storage": "8Gi"}}}}]}}
    heavy = {"apiVersion": "apps/v1", "kind": "Deployment",
             "metadata": {"name": "batch-heavy", "namespace": "default",
                          "labels": {"app": "batch-heavy"}},
             "spec": {"replicas": PLAN_HEAVY_REPLICAS,
                      "selector": {"matchLabels": {"app": "batch-heavy"}},
                      "template": {"metadata": {"labels": {"app": "batch-heavy"}}, "spec": {
                          "containers": [{"name": "w", "image": "worker", "resources": {
                              "requests": {"cpu": "40", "memory": "64Gi"}}}]}}}}
    return [("stress", affinity_stateful_sets(AFF_STS, PLAN_REPLICAS)),
            ("local-storage", [kv]), ("batch-heavy", [heavy])]


def write_plan_config(root) -> str:
    """The full-width plan as a simon config under `root`: PLAN_NODES
    zone-labelled storage nodes (32 cpu / 128 GiB, phase 7's storage),
    the apps `hello` (the repo's example chart), the stress, the LVM
    StatefulSet and the heavy Deployment, in that order, and a 96 cpu /
    384 GiB new node."""
    from pathlib import Path

    import yaml

    dumper = getattr(yaml, "CSafeDumper", yaml.SafeDumper)
    root = Path(root)
    nodes = affinity_nodes(PLAN_NODES, AFF_ZONES, storage_anno(2))
    for node in nodes:
        for key in ("allocatable", "capacity"):
            node["status"][key]["memory"] = "128Gi"
    new_node = {"kind": "Node", "apiVersion": "v1", "metadata": {
        "name": "template", "labels": {"kubernetes.io/hostname": "template"}},
        "status": {"allocatable": {"cpu": "96", "memory": "384Gi", "pods": "110"},
                   "capacity": {"cpu": "96", "memory": "384Gi", "pods": "110"}}}
    apps = [{"name": "hello-chart", "path": str(ROOT / "example/application/charts/hello"),
             "chart": True}]
    dirs = [("cluster", nodes), ("newnode", [new_node])]
    for name, objs in plan_workloads():
        dirs.append((f"app-{name}", objs))
        apps.append({"name": name, "path": str(root / f"app-{name}")})
    for sub, docs in dirs:
        (root / sub).mkdir()
        with open(root / sub / "objects.yaml", "w") as f:
            yaml.dump_all(docs, f, Dumper=dumper)
    cfg = root / "simon-config.yaml"
    cfg.write_text(yaml.safe_dump({
        "apiVersion": "simon/v1alpha1", "kind": "Config", "metadata": {"name": "plan"},
        "spec": {"cluster": {"customConfig": str(root / "cluster")}, "appList": apps,
                 "newNode": str(root / "newnode")},
    }))
    return str(cfg)


def encode(nodes, pods, device):
    """The fused-scan plan of `pods` (in simulate()'s queue order) on a
    fresh cluster, and the pod names in that order."""
    import copy

    from open_simulator_tpu_torch.ops import encode as enc
    from open_simulator_tpu_torch.ops import fused_scan
    from open_simulator_tpu_torch.scheduler.core import _sort_app_pods
    from open_simulator_tpu_torch.scheduler.oracle import Oracle

    oracle = Oracle(copy.deepcopy(nodes))
    ordered = _sort_app_pods(copy.deepcopy(pods))
    cluster = enc.encode_cluster(oracle)
    batch = enc.encode_batch(oracle, cluster, ordered)
    dyn = enc.encode_dynamic(oracle, cluster)
    features = enc.features_of_batch(cluster, batch)
    plan = fused_scan.build_plan(cluster, batch, dyn, features, device=device)
    names = [p["metadata"]["name"] for p in ordered]
    return plan, batch, names


def timed(fn, runs):
    import torch

    times = []
    out = None
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, times


def cuda_ms(fn):
    """fn()'s result and the card's milliseconds between two CUDA events
    around it (the wrapper's input copies and its launch)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def prefix(scenarios, k):
    """The scenarios with only their first `k` pods active."""
    import numpy as np

    return [(np.asarray(a, bool) & (np.arange(len(a)) < k), v, q) for a, v, q in scenarios]


def max_abs_err(got, want) -> int:
    """Largest difference over placements and every final state row of
    one scan; raises when the rows differ in name."""
    (gp, gf), (wp, wf) = got, want
    if gf.keys() != wf.keys():
        raise AssertionError(f"final rows differ: {sorted(gf)} vs {sorted(wf)}")
    errs = [int((gp.long() - wp.long()).abs().max())]
    errs += [int((gf[f].long() - wf[f].long()).abs().max()) for f in gf]
    return max(errs)


def kernel_vs_plain(label, gpu, plan, batch, active, valid, runs=3) -> dict:
    """One kernel against its plain version on the same plan on the
    card: identical placements and rows, or the run fails."""
    import numpy as np

    from open_simulator_tpu_torch.ops import fused_scan

    args = (plan, batch.class_of_pod, active, valid)
    kw = {"pinned": batch.pinned_node}
    fused_scan.run_fused_scan(*args, **kw)  # warm
    got, k_times = timed(lambda: fused_scan.run_fused_scan(*args, **kw), runs)
    want, r_times = timed(lambda: fused_scan.fused_scan_reference(*args, **kw), 1)
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"{label}: kernel != plain, max abs err {err}")
    from open_simulator_tpu_torch.obs import costs

    b_ms, b_by = costs.bound(plan, batch.class_of_pod, [(active, valid, batch.pinned_node)])
    workspace_check(label, gpu, plan, batch.class_of_pod, [(active, valid, batch.pinned_node)])
    name = fused_scan.kernel_name(plan)
    res = {"ms": statistics.median(k_times), "times": k_times, "plain_ms": r_times[0],
           "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
           "placements": want[0].cpu().numpy(), "rows": sorted(want[1]), "want": want,
           "cluster": fused_scan.CLUSTERS[name]}
    steps = int((np.asarray(active, bool) & (np.asarray(batch.pinned_node) < 0)).sum())
    print(f"{label}: kernel == plain (placements and rows {res['rows']}); kernel "
          f"{res['ms']:.3f} ms (median of {runs}: {[round(t, 3) for t in k_times]}; cluster "
          f"{res['cluster']}: {res['ms'] * 1e3 / max(steps, 1):.3f} us a scanned pod step), "
          f"plain {res['plain_ms']:.1f} ms, bound {b_ms:.4f} ms by {b_by} [{gpu}]",
          flush=True)
    return res


def cluster_sweep(label, gpu, plan, batch, scenarios, want, clusters,
                  is_batch=False) -> dict:
    """The plan's kernel at each cluster size of `clusters` through the
    private launcher, on `scenarios` (one, or a batch): each run == the
    plain version's `want` (a list, one result a scenario); ms by CUDA
    events and us a scanned pod step of each, keyed by the cluster
    size."""
    import numpy as np

    from open_simulator_tpu_torch.ops import fused_scan

    steps = sum(int((np.asarray(a, bool) & (np.asarray(q) < 0 if q is not None else True)).sum())
                for a, _v, q in scenarios)
    out = {}
    for c in clusters:
        def run():
            return fused_scan._run_with_cluster(plan, batch.class_of_pod, scenarios,
                                                is_batch, c)
        run()  # warm: the attribute calls of a new size
        got, ms = cuda_ms(run)
        err = max(max_abs_err(g, w) for g, w in zip(got, want))
        if err:
            raise AssertionError(f"{label}: cluster {c}: kernel != plain ({err})")
        shape = fused_scan.launch_shape(plan, c)
        out[c] = ms
        rows = ("shared memory, cached" if shape.cached else
                "shared memory" if shape.resident else "global")
        if plan.has_terms:
            rows += ", replica in " + ("shared memory" if shape.replica else "global")
        print(f"{label}: {fused_scan.kernel_name(plan, is_batch)} at cluster {c} (slice "
              f"{-(-plan.n // c)} nodes, {rows} rows, {shape.smem} bytes): {ms:.3f} ms = "
              f"{ms * 1e3 / max(steps, 1):.3f} us a scanned pod step, == plain [{gpu}]",
              flush=True)
    return out


def simulate_path(label, gpu, nodes, pods, names, plain_place, kernel) -> int:
    """Drive simulate(engine="cuda") with the counters at 0; require
    that `kernel` ran and every pod landed where `plain_place` (a scan
    already held against the plain version) put it. Returns the
    kernel's launch count."""
    import torch

    from open_simulator_tpu_torch.models.decode import ResourceTypes
    from open_simulator_tpu_torch.models.workloads import reset_name_counter
    from open_simulator_tpu_torch.ops import fused_scan
    from open_simulator_tpu_torch.scheduler.core import AppResource, simulate
    from open_simulator_tpu_torch.utils.trace import GLOBAL

    cluster = ResourceTypes()
    cluster.nodes = nodes
    app = ResourceTypes()
    app.pods = pods
    reset_name_counter()
    GLOBAL.reset()
    fused_scan.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = simulate(cluster, [AppResource("bench", app)], engine="cuda")
    torch.cuda.synchronize()
    sim_s = time.perf_counter() - t0
    launches = dict(fused_scan.LAUNCHES)
    note = GLOBAL.notes.get("batch-kernel")
    scan_s = GLOBAL.phase_seconds("engine/scan")
    placed = {p["metadata"]["name"]: ns.node["metadata"]["name"]
              for ns in result.node_status for p in ns.pods}
    node_names = [n["metadata"]["name"] for n in nodes]
    expect = {nm: node_names[i] for nm, i in zip(names, plain_place) if i >= 0}
    if launches[kernel] < 1:
        raise AssertionError(f"{label}: simulate() did not launch {kernel}: {launches}")
    if note != f"cuda-{kernel} (cluster {fused_scan.CLUSTERS[kernel]})":
        raise AssertionError(f"{label}: batch-kernel note {note!r}")
    if placed != expect:
        raise AssertionError(f"{label}: simulate() placements differ from the checked scan's")
    print(f"{label}: simulate(engine='cuda') placed {len(placed)}/{len(pods)} as the checked "
          f"scan did ({len(result.unscheduled_pods)} unscheduled); launches {launches}; "
          f"note {note!r}; {sim_s:.3f} s end to end = {len(pods) / sim_s:.1f} pods/s; "
          f"engine/scan {scan_s * 1e3:.1f} ms ({100 * scan_s / sim_s:.1f}%) [{gpu}]",
          flush=True)
    phases = ", ".join(f"{ph['name']} {ph['seconds'] * 1e3:.1f} ms"
                       for ph in GLOBAL.as_dict()["phases"])
    print(f"{label}: host clock by phase: {phases} [{gpu}]", flush=True)
    return launches[kernel]


def print_build(lib):
    """Registers and spills of each instantiation from nvcc's report:
    flags (batch, scalars, gpu, ports, storage, terms) of
    fused_scan_kernel<...>; then each instantiation's static shared
    memory as the card reports it, which must be at most the wrapper's
    figure (STATIC_SMEM for the 16 base and B2 ones, STATIC_SMEM_STORE
    and STATIC_SMEM_TERMS for the 6 storage and term ones)."""
    import ctypes
    import re

    from open_simulator_tpu_torch.ops import fused_scan

    flags = None
    for line in lib.with_suffix(".log").read_text().splitlines():
        m = re.search(r"fused_scan_kernelI" + "Lb(\\d)E" * 6, line)
        if m:
            flags = "".join(m.groups())
        elif flags and ("registers" in line or "spill" in line):
            print(f"  ptxas <batch,scal,gpu,ports,store,terms>={flags}: {line.strip()}")
    big = [b | 7 | blk for b in (0, 8) for blk in (16, 32, 48)]
    sizes = {}
    for flags in list(range(16)) + big:
        want = (fused_scan.STATIC_SMEM_TERMS if flags & 32 else
                fused_scan.STATIC_SMEM_STORE if flags & 16 else fused_scan.STATIC_SMEM)
        out = ctypes.c_int64(-1)
        err = fused_scan._library().fused_scan_static_smem(flags, ctypes.byref(out))
        if err or not 0 < out.value <= want:
            raise AssertionError(f"phase 1: instantiation {flags}: static shared memory "
                                 f"{out.value} (cudaError {err}), the wrapper counts {want}")
        sizes.setdefault(want, []).append(out.value)
    print("phase 1: static shared memory of the 22 instantiations: " + "; ".join(
        f"{len(v)} at {min(v)}-{max(v)} bytes <= the wrapper's {k}"
        for k, v in sorted(sizes.items())))


def run_cli(argv, cwd=None, allow=()):
    """The port's CLI in this process: (exit code, stdout, stderr), with
    the pod-name counter reset first; a degradation note fails it unless
    `allow` names it."""
    import contextlib
    import io
    import os

    from open_simulator_tpu_torch import cli
    from open_simulator_tpu_torch.models.workloads import reset_name_counter

    from open_simulator_tpu_torch.utils.trace import GLOBAL

    out, err = io.StringIO(), io.StringIO()
    reset_name_counter()
    with contextlib.chdir(cwd or os.getcwd()), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    check_notes(" ".join(argv[:3]), GLOBAL.notes, allow)
    return rc, out.getvalue(), err.getvalue()


def plan_on_card(argv, cwd=None) -> dict:
    """Run a plan through the port's CLI on the card with the launch
    counters at 0, recording the sweep and every scan it runs (plan,
    kind, scenarios, outputs, start and end CUDA events)."""
    import torch

    from open_simulator_tpu_torch.ops import fused_scan
    from open_simulator_tpu_torch.parallel import sweep as sweep_mod
    from open_simulator_tpu_torch.utils.trace import GLOBAL

    sweeps, calls = [], []
    real_find = sweep_mod.CapacitySweep.find_min_count
    real_single, real_batch = fused_scan.run_fused_scan, fused_scan.run_fused_scan_batch

    def find(self, *a, **k):
        sweeps.append(self)
        return real_find(self, *a, **k)

    def recorded(kind, plan, scenarios, run):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs = run()
        end.record()
        calls.append((plan, kind, list(scenarios), outs, start, end))
        return outs

    def single(plan, cls, active, valid, pinned=None, **kw):
        return recorded("single", plan, [(active, valid, pinned)],
                        lambda: [real_single(plan, cls, active, valid, pinned, **kw)])[0]

    def batch(plan, cls, scenarios, **kw):
        return recorded("batch", plan, scenarios, lambda: real_batch(plan, cls, scenarios, **kw))

    sweep_mod.CapacitySweep.find_min_count = find
    fused_scan.run_fused_scan, fused_scan.run_fused_scan_batch = single, batch
    try:
        fused_scan.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc, out, err = run_cli(argv, cwd)
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        launches = dict(fused_scan.LAUNCHES)
    finally:
        sweep_mod.CapacitySweep.find_min_count = real_find
        fused_scan.run_fused_scan, fused_scan.run_fused_scan_batch = real_single, real_batch
    if rc != 0:
        raise AssertionError(f"{argv}: exited {rc}: {err[-2000:]}")
    sweep = sweeps[0]
    if any(c[0] is not sweep.plan for c in calls):
        raise AssertionError(f"{argv}: a scan ran on another plan than the sweep's")
    kinds = [c[1] for c in calls]
    singles = sum(v for k, v in launches.items() if k != fused_scan.BATCH_KERNEL_NAME)
    if (kinds.count("single") != singles
            or kinds.count("batch") != launches[fused_scan.BATCH_KERNEL_NAME]):
        raise AssertionError(f"{argv}: recorded scans {kinds} != launches {launches}")

    def counts(scenarios):
        return [int(valid.sum()) - sweep.n_base for _a, valid, _p in scenarios]

    return {"doc": json.loads(out), "out": out, "launches": launches, "calls": calls,
            "sweep": sweep, "trace": GLOBAL.as_dict(), "plan_s": plan_s, "counts": counts,
            "main_ms": [(kind, counts(scen), start.elapsed_time(end))
                        for _, kind, scen, _, start, end in calls]}


def hold_plan_scans(label, gpu, res) -> None:
    """Every scan a plan ran (its single probes and its pairs) against
    one call of the batch plain version on all their scenarios:
    placements and every final row."""
    from open_simulator_tpu_torch.ops import fused_scan

    sweep, calls = res["sweep"], res["calls"]
    scenarios = [sc for c in calls for sc in c[2]]
    outs = [o for c in calls for o in c[3]]
    want, r_times = timed(lambda: fused_scan.fused_scan_batch_reference(
        sweep.plan, sweep.batch.class_of_pod, scenarios), 1)
    err = max(max_abs_err(o, w) for o, w in zip(outs, want))
    if err:
        raise AssertionError(f"{label}: a scan of the plan != batch plain ({err})")
    print(f"{label}: every scan of the plan (kinds {[c[1] for c in calls]}, counts "
          f"{res['counts'](scenarios)}) == batch plain ({r_times[0]:.1f} ms for all in one "
          f"call), placements and every row [{gpu}]", flush=True)


def print_plan(label, gpu, res) -> None:
    doc = res["doc"]
    placed = sum(len(n["pods"]) for n in doc["nodes"])
    print(f"{label}: apply planned +{doc['newNodeCount']} nodes for {placed} pods on "
          f"{len(doc['nodes'])} nodes in {res['plan_s']:.3f} s; launches {res['launches']}; "
          f"card time of each scan (kind, counts, ms by CUDA events) {res['main_ms']} [{gpu}]",
          flush=True)
    print(f"{label}: host clock by phase: " + ", ".join(
        f"{ph['name']} {ph['seconds'] * 1e3:.1f} ms x{ph['count']}"
        for ph in res["trace"]["phases"]) + f" [{gpu}]", flush=True)


def phase6(gpu) -> dict:
    """The capacity plan through the port's CLI at full width."""
    import tempfile

    from open_simulator_tpu_torch.apply.applier import _capacity_feasible
    from open_simulator_tpu_torch.ops import fused_scan

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        cfg = write_capacity_config(root)
        print(f"phase 6: wrote {CAP_NODES} nodes x {CAP_PODS} pods as a simon config in "
              f"{time.perf_counter() - t0:.2f} s (set-up)", flush=True)
        res = plan_on_card(["apply", "-f", cfg, "--format", "json", "--trace"])
    doc, launches, calls = res["doc"], res["launches"], res["calls"]
    count = doc["newNodeCount"]
    placed = sum(len(n["pods"]) for n in doc["nodes"])
    if not doc["success"] or doc["unscheduledPods"] or placed != CAP_PODS:
        raise AssertionError(f"phase 6: success {doc['success']}, placed {placed}, "
                             f"{len(doc['unscheduledPods'])} unscheduled")
    if count != JAX_CAPACITY_ANSWER:
        raise AssertionError(f"phase 6: +{count} nodes, the JAX package plans "
                             f"+{JAX_CAPACITY_ANSWER}")
    if launches[fused_scan.KERNEL_NAME] < 1 or launches[fused_scan.BATCH_KERNEL_NAME] < 1:
        raise AssertionError(f"phase 6: the plan did not launch both kernels: {launches}")
    print_plan("phase 6 (the JAX package's answer)", gpu, res)
    sweep, counts = res["sweep"], res["counts"]
    plan, cls = sweep.plan, sweep.batch.class_of_pod

    # checks outside the main path (the counters are read): B6 on every
    # scan of the plan in one launch, equal to the plan's own scans;
    # the plan's scans over their first CAP_PLAIN_PODS pods against the
    # plain version in one call, kernel (one batch launch) and plain;
    # single launches of each batch scenario; and one node fewer than
    # the answer
    import numpy as np

    scenarios = [sc for c in calls for sc in c[2]]
    outs = [(c[1], o) for c in calls for o in c[3]]
    got, full_ms = cuda_ms(lambda: fused_scan.run_fused_scan_batch(plan, cls, scenarios))
    if max(max_abs_err(g, o) for g, (_k, o) in zip(got, outs)):
        raise AssertionError("phase 6: a batch launch of the plan's scans != its own scans")
    cut = prefix(scenarios, CAP_PLAIN_PODS)
    want, r_times = timed(lambda: fused_scan.fused_scan_batch_reference(plan, cls, cut), 1)
    got, batch_ms = cuda_ms(lambda: fused_scan.run_fused_scan_batch(plan, cls, cut))
    batch_cluster = fused_scan.CLUSTERS[fused_scan.BATCH_KERNEL_NAME]
    errs = {"single": 0, "batch": max(max_abs_err(g, w) for g, w in zip(got, want))}
    # the same launch on one block a scenario (the previous design's shape)
    fused_scan._run_with_cluster(plan, cls, prefix(cut[:1], 10), True, 1)  # warm
    one, one_ms = cuda_ms(lambda: fused_scan._run_with_cluster(plan, cls, cut, True, 1))
    errs["batch"] = max(errs["batch"], max(max_abs_err(g, w) for g, w in zip(one, want)))
    for (kind, o), w in zip(outs, want):
        head = np.asarray(o[0].cpu())[:CAP_PLAIN_PODS] != np.asarray(w[0].cpu())[:CAP_PLAIN_PODS]
        errs[kind] = max(errs[kind], int(head.sum()))
    if errs["single"] or errs["batch"]:
        raise AssertionError(f"phase 6: scans of the plan != plain version: {errs}")
    single_ms = []
    for _, kind, scen, c_outs, _, _ in calls:
        if kind != "batch":
            continue
        for sc, o in zip(scen, c_outs):
            s, ms = cuda_ms(lambda: fused_scan.run_fused_scan(plan, cls, *sc))
            single_ms.append(ms)
            if max_abs_err(s, o):
                raise AssertionError(f"phase 6: probe_pair != single launch at "
                                     f"count {counts([sc])[0]}")
    pair = next(c[2] for c in calls if c[1] == "batch")
    _, pair_ms = cuda_ms(lambda: fused_scan.run_fused_scan_batch(plan, cls, pair))
    feasible, caps = _capacity_feasible()
    lower = sweep.lower_bound(*caps)
    if count > lower and feasible(sweep.probe(count - 1)):
        raise AssertionError(f"phase 6: +{count - 1} nodes already satisfy the caps")
    from open_simulator_tpu_torch.obs import costs

    b_ms, b_by = costs.bound(plan, cls, cut)
    print(f"phase 6: one batch launch of every scan of the plan (counts "
          f"{counts(scenarios)}) {full_ms:.1f} ms == the plan's own scans; their first "
          f"{CAP_PLAIN_PODS} pods (placements of the plan's scans, and one batch launch "
          f"{batch_ms:.1f} ms, on one block a scenario {one_ms:.1f} ms, placements and every "
          f"row) == plain version "
          f"({r_times[0]:.1f} ms for all in one call), bound {b_ms:.4f} ms by {b_by}; every "
          f"probe pair == single launches; +{count - 1} fails (lower bound {lower}); one "
          f"probe {statistics.median(single_ms):.1f} ms, one pair launch {pair_ms:.1f} ms "
          f"(CUDA events, {CAP_PODS} pods x {sweep.n} nodes; clusters of {batch_cluster}) "
          f"[{gpu}]", flush=True)
    workspace_check("phase 6", gpu, plan, cls, cut, batch=True)
    batch_res = {"ms": batch_ms, "plain_ms": r_times[0], "max_abs_err": errs["batch"],
                 "bound_ms": b_ms, "bound_by": b_by, "cluster": batch_cluster,
                 "prev_ms": one_ms}
    return {"launches": launches, "batch": batch_res, "single_err": errs["single"],
            "doc": doc, "launches_total": sum(launches.values()),
            "shape": (CAP_NODES, CAP_PODS)}


def block_phase(label, gpu, nodes, pods, kernel, runs=1, simulate=True,
                plain_pods=None) -> dict:
    """One scenario of a new block: the kernel against its plain version
    on the card (placements and every final row; with `plain_pods`, over
    the first that many pods, and the kernel once more over all of them,
    at the rule's cluster and on one block), then, with `simulate`,
    simulate(engine="cuda") on it with the counters at 0. Returns the
    comparison's numbers with the main path's launches: with
    `plain_pods`, ms, bound and prev_ms are those of the launch over all
    pods, plain_ms the cut's, and prefix_ms the kernel's on the cut."""
    import numpy as np
    import torch

    from open_simulator_tpu_torch.ops import fused_scan

    t0 = time.perf_counter()
    plan, batch, names = encode(nodes, pods, "cuda")
    if fused_scan.kernel_name(plan) != kernel:
        raise AssertionError(f"{label}: the plan runs {fused_scan.kernel_name(plan)}, "
                             f"not {kernel}")
    d = fused_scan.block_dims(plan)
    print(f"{label}: encoded {plan.n} nodes x {len(names)} pods, {plan.u} classes, block "
          f"sizes { {k: v for k, v in d.items() if v} } in {time.perf_counter() - t0:.2f} s "
          f"(host); scratch and block state {fused_scan.scratch_bytes(plan) / 2**20:.1f} MiB "
          f"a scenario", flush=True)
    p, valid = len(names), np.ones(plan.n, bool)
    active = np.arange(p) < (p if plain_pods is None else plain_pods)
    res = kernel_vs_plain(label, gpu, plan, batch, active, valid, runs=runs)
    # the rule's cluster size and one block a scenario, timed in turn
    sweep = cluster_sweep(label, gpu, plan, batch, [(active, valid, batch.pinned_node)],
                          [res.pop("want")], (res["cluster"], 1))
    res["cluster_ms"], res["prev_ms"] = sweep[res["cluster"]], sweep[1]
    placements = res["placements"]
    print(f"{label}: {int((placements >= 0).sum())}/{int(active.sum())} placed by both",
          flush=True)
    if plain_pods is not None:
        # the main path's launch is over every pod: the entry's ms, bound
        # and one-block ms are taken there, the plain time on the cut
        every = [(np.ones(p, bool), valid, batch.pinned_node)]
        (full, final), ms = cuda_ms(lambda: fused_scan.run_fused_scan(
            plan, batch.class_of_pod, *every[0]))
        placements = full.cpu().numpy()
        if (placements[:plain_pods] != res["placements"][:plain_pods]).any():
            raise AssertionError(f"{label}: the full scan's first pods differ from the cut's")
        one = cluster_sweep(label, gpu, plan, batch, every, [(full, final)], (1,))
        from open_simulator_tpu_torch.obs import costs

        b_ms, b_by = costs.bound(plan, batch.class_of_pod, every)
        res.update(plain_pods=plain_pods, prefix_ms=res["ms"], ms=ms, bound_ms=b_ms,
                   bound_by=b_by, prev_ms=one[1])
        print(f"{label}: the kernel over all {p} pods {ms:.1f} ms (CUDA events; one block "
              f"{one[1]:.1f} ms, == the rule's cluster), its first {plain_pods} placements "
              f"those of the cut; {int((placements >= 0).sum())}/{p} placed; bound "
              f"{b_ms:.4f} ms by {b_by} [{gpu}]", flush=True)
    res["launches"] = 0
    if simulate:
        del plan
        torch.cuda.empty_cache()
        res["launches"] = simulate_path(label, gpu, nodes, pods, names, placements, kernel)
    return res


def phase10(gpu) -> dict:
    """Every block in one plan: bench.py's conformance mix as one launch
    and as a B6 batch of three node masks, both equal to the plain
    version, each at the rule's cluster size and on one block a
    scenario. Returns the single launch's numbers (fused_scan_store_terms
    at this shape) and the batch's."""
    import numpy as np

    from open_simulator_tpu_torch.ops import fused_scan

    nodes, pods = build_fuzz_scenario()
    plan, batch, names = encode(nodes, pods, "cuda")
    blocks = (plan.has_store, plan.has_terms, plan.has_scal, plan.has_ports, plan.has_pins)
    host_soft = plan.s_host.cpu().numpy()
    soft_rows = plan.cls_srows.cpu().numpy()
    zone_soft = bool(((soft_rows >= 0) & ~host_soft[np.maximum(soft_rows, 0)].astype(bool)).any())
    groups = bool((plan.cls_gid.cpu().numpy() >= 0).any())
    if not all(blocks) or plan.u <= 128 or not zone_soft or not groups:
        raise AssertionError(f"phase 10: blocks {blocks}, {plan.u} classes, zone soft "
                             f"spread {zone_soft}, affinity group {groups}")
    n, p = plan.n, len(names)
    pin = batch.pinned_node
    every5 = np.arange(n) % 5 != 0
    last_off = np.ones(n, bool)
    last_off[int(n * 0.9):] = False
    scen = [(np.ones(p, bool), np.ones(n, bool), pin), (np.ones(p, bool), every5, pin),
            (np.ones(p, bool), last_off, pin)]
    cls = batch.class_of_pod
    want, r_times = timed(lambda: fused_scan.fused_scan_batch_reference(plan, cls, scen), 1)
    one, o_times = timed(lambda: fused_scan.fused_scan_reference(plan, cls, *scen[0]), 1)
    fused_scan.run_fused_scan(plan, cls, *scen[0])  # warm
    single, s_ms = cuda_ms(lambda: fused_scan.run_fused_scan(plan, cls, *scen[0]))
    got, b_ms = cuda_ms(lambda: fused_scan.run_fused_scan_batch(plan, cls, scen))
    err = max([max_abs_err(single, one), max_abs_err(one, want[0])]
              + [max_abs_err(g, w) for g, w in zip(got, want)])
    if err:
        raise AssertionError(f"phase 10: kernel != batch plain, max abs err {err}")
    c_single = fused_scan.CLUSTERS[fused_scan.kernel_name(plan)]
    c_batch = fused_scan.CLUSTERS[fused_scan.BATCH_KERNEL_NAME]
    print(f"phase 10 (all blocks, {n} nodes x {p} pods, {plan.u} classes): one "
          f"{fused_scan.kernel_name(plan)} launch {s_ms:.1f} ms (cluster {c_single}) and one "
          f"batch launch of 3 node masks {b_ms:.1f} ms (cluster {c_batch}) == plain "
          f"({o_times[0]:.1f} ms one, {r_times[0]:.1f} ms the batch), placements and every "
          f"row [{gpu}]", flush=True)
    singles = cluster_sweep("phase 10", gpu, plan, batch, scen[:1], [one], (c_single, 1))
    batched = cluster_sweep("phase 10", gpu, plan, batch, scen, want, (c_batch, 1),
                            is_batch=True)
    from open_simulator_tpu_torch.obs import costs

    b_ms_bound, b_by = costs.bound(plan, cls, scen[:1])
    workspace_check("phase 10", gpu, plan, cls, scen[:1])
    workspace_check("phase 10", gpu, plan, cls, scen, batch=True)
    return {"ms": s_ms, "plain_ms": o_times[0], "max_abs_err": err, "bound_ms": b_ms_bound,
            "bound_by": b_by, "cluster": c_single, "prev_ms": singles[1],
            "batch_ms": b_ms, "batch_cluster": c_batch, "batch_prev_ms": batched[1]}


def phase11(gpu) -> dict:
    """The slice's path: the quickstart through the CLI on the card and
    on the CPU, byte for byte; then the full-width plan. Each plan's
    scans are held against the batch plain version."""
    import tempfile

    from open_simulator_tpu_torch.ops import fused_scan

    argv = ["apply", "-f", QUICKSTART, "--format", "json"]
    quick = plan_on_card(argv, cwd=ROOT)
    rc, cpu_out, err = run_cli(argv + ["--device", "cpu"], cwd=ROOT)
    doc, launches = quick["doc"], quick["launches"]
    if rc != 0 or quick["out"] != cpu_out:
        raise AssertionError(f"phase 11: the card's JSON differs from the CPU's (rc {rc}): "
                             f"{err[-1000:]}")
    if not doc["success"] or doc["newNodeCount"] != JAX_QUICKSTART_ANSWER:
        raise AssertionError(f"phase 11: success {doc['success']}, +{doc['newNodeCount']} "
                             f"nodes; the JAX package plans +{JAX_QUICKSTART_ANSWER}")
    plan = quick["sweep"].plan
    if not (plan.has_store and plan.has_terms) or (
            launches[fused_scan.STORE_TERMS_KERNEL_NAME] < 1):
        raise AssertionError(f"phase 11: the quickstart did not launch the storage and "
                             f"term instantiation: {launches}")
    print(f"phase 11: {' '.join(argv)} on the card ({quick['plan_s']:.3f} s) == --device "
          f"cpu, byte for byte ({len(cpu_out)} bytes): success, +{doc['newNodeCount']} node "
          f"(the JAX package's answer), launches {launches} [{gpu}]", flush=True)
    print(cpu_out.strip())
    hold_plan_scans("phase 11 (quickstart)", gpu, quick)

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        cfg = write_plan_config(root)
        print(f"phase 11: wrote the full-width plan ({PLAN_NODES} nodes) in "
              f"{time.perf_counter() - t0:.2f} s (set-up)", flush=True)
        res = plan_on_card(["apply", "-f", cfg, "--format", "json", "--trace"])
    doc, launches = res["doc"], res["launches"]
    if not doc["success"] or doc["unscheduledPods"]:
        raise AssertionError(f"phase 11: full-width plan success {doc['success']}, "
                             f"{len(doc['unscheduledPods'])} unscheduled")
    if doc["newNodeCount"] != JAX_PLAN_ANSWER:
        raise AssertionError(f"phase 11: +{doc['newNodeCount']} nodes, the JAX package "
                             f"plans +{JAX_PLAN_ANSWER}")
    if (launches[fused_scan.STORE_TERMS_KERNEL_NAME] < 1
            or launches[fused_scan.BATCH_KERNEL_NAME] < 1):
        raise AssertionError(f"phase 11: the plan did not launch both kernels: {launches}")
    print_plan("phase 11 (full width, the JAX package's answer)", gpu, res)
    hold_plan_scans("phase 11 (full width)", gpu, res)
    plan = res["sweep"].plan
    pair = fused_scan.scratch_bytes(plan, 2, fused_scan.choose_cluster(plan, 2, True))
    many = fused_scan.scratch_bytes(plan, 101, fused_scan.choose_cluster(plan, 101, True))
    print(f"phase 11: scratch and block state {pair / 2**20:.1f} MiB for a pair, "
          f"{many / 2**30:.2f} GiB for 101 counts [{gpu}]", flush=True)
    return launches


def print_stream_build(lib):
    """Registers and spills of stream_kernel from nvcc's report."""
    entry = False
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "entry function" in line:
            entry = "stream_kernel" in line
        elif entry and ("registers" in line or "spill" in line):
            print(f"  ptxas stream_kernel: {line.strip()}")


def phase12(gpu) -> dict:
    """B7: the tool's entry point at its four sizes with the counter at
    0, each size's kernel == plain exactly, the 64 MiB size timed beside
    its plain version, its bound and one PyTorch reduction over the same
    bytes; then the scan-step probe."""
    import torch

    from open_simulator_tpu_torch.obs import costs
    from open_simulator_tpu_torch.tools import stream_bench as sb

    l2 = sb.l2_bytes(0)
    sb.reset_launch_counts()
    rates = {mb: sb.run(mb, sb.tool_steps(mb)) for mb in sb.SIZES_MB}
    torch.cuda.synchronize()
    launches = sb.LAUNCHES[sb.KERNEL_NAME]
    if launches < len(sb.SIZES_MB):
        raise AssertionError(f"phase 12: run() launched {sb.KERNEL_NAME} {launches} times")
    res = {"launches": launches, "max_abs_err": 0}
    for mb in sb.SIZES_MB:
        steps = sb.tool_steps(mb)
        state = sb.make_state(mb, device="cuda")
        nbytes = state.numel() * 4
        regime = "in L2 after the first step" if nbytes <= l2 else "from device memory"
        got = sb.run_stream(state, steps)
        want, plain_ms = cuda_ms(lambda: sb.stream_reference(state, steps))
        err = int((got.long() - want.long()).abs().max())
        if err:
            raise AssertionError(f"phase 12: {mb} MiB kernel != plain, max abs err {err}")
        print(f"phase 12: state {mb} MiB ({nbytes} bytes, {regime}; L2 {l2} bytes), "
              f"{steps} steps: run() {rates[mb]:.1f} GB/s; kernel == plain exactly "
              f"(plain {plain_ms:.1f} ms) [{gpu}]", flush=True)
        if mb == max(sb.SIZES_MB):
            times = [cuda_ms(lambda: sb.run_stream(state, steps))[1] for _ in range(3)]
            expanded = state.unsqueeze(0).expand(steps, -1, -1)
            torch.amax(expanded, dim=1)  # warm
            _out, lib_ms = cuda_ms(lambda: torch.amax(expanded, dim=1))
            bound_ms = costs.bound_of(nbytes * steps, 0)[0]
            res.update(ms=statistics.median(times), plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound_ms, bound_by="bytes")
            print(f"phase 12: {mb} MiB x {steps} steps: kernel {res['ms']:.3f} ms (median "
                  f"of 3: {[round(t, 3) for t in times]}) = "
                  f"{nbytes * steps / res['ms'] / 1e6:.1f} GB/s, plain {plain_ms:.1f} ms, "
                  f"torch.amax over the expanded state {lib_ms:.3f} ms, bound "
                  f"{bound_ms:.3f} ms by bytes [{gpu}]", flush=True)
        del state, got, want

    state = sb.make_state(PROBE_BYTES / 2**20, PROBE_BLOCK_ROWS, device="cuda")
    if state.numel() * 4 != PROBE_BYTES - PROBE_BYTES % (PROBE_BLOCK_ROWS * 512):
        raise AssertionError(f"phase 12: probe state {tuple(state.shape)}")
    sb.run_stream(state, 10)  # warm
    got, probe_ms = cuda_ms(lambda: sb.run_stream(state, PROBE_STEPS))
    want = sb.stream_reference(state, PROBE_STEPS)
    err = int((got.long() - want.long()).abs().max())
    if err:
        raise AssertionError(f"phase 12: scan-step probe kernel != plain, max abs err {err}")
    res["probe_us"] = probe_ms * 1e3 / PROBE_STEPS
    print(f"phase 12: scan-step probe, {state.shape[0]} rows ({state.numel() * 4} bytes) x "
          f"{PROBE_STEPS} steps over every SM with a grid barrier a step: {probe_ms:.3f} ms = "
          f"{res['probe_us']:.3f} us a step (B1: 38 us a pod step on one block); kernel == "
          f"plain [{gpu}]", flush=True)
    return res


def a2_inputs():
    """Phase 13's nodes and pods: the default scenario, pods cut."""
    return build_scenario(N_NODES, A2_PODS)


def a2_plugin(base):
    """Phase 13's custom score plugin on `base` (either package's
    SchedulerPlugin): a score of five levels from the node's zone and
    the pod's class, normalised min-max, so many nodes tie."""
    class ZoneClass(base):
        name = "zone-class"
        normalize = "minmax"

        def score(self, pod, node):
            zone = int(node["metadata"]["labels"]["zone"][1:])
            return (zone + len(pod["metadata"]["labels"]["cls"])) % 5

    return ZoneClass()


def a2_view(result, rng):
    """What phase 13 compares: every node's pods in order, the
    unscheduled pods with their reasons, and the RNG's 607-word history."""
    return {
        "nodes": [[ns.node["metadata"]["name"], [p["metadata"]["name"] for p in ns.pods]]
                  for ns in result.node_status],
        "unscheduled": [[u.pod["metadata"]["name"], u.reason] for u in result.unscheduled_pods],
        "rng": [str(w) for w in rng.history()],
    }


def a2_digest(view) -> str:
    import hashlib

    return hashlib.sha256(json.dumps(view, sort_keys=True).encode()).hexdigest()


def phase13(gpu) -> dict:
    """A2: simulate(engine="cuda", select_host="sample") with a custom
    plugin on the torch scan, on the card with the counters at 0, then
    the same call on the CPU and the JAX package's digest."""
    import copy

    import torch

    from open_simulator_tpu_torch.models.decode import ResourceTypes
    from open_simulator_tpu_torch.models.workloads import reset_name_counter
    from open_simulator_tpu_torch.ops import fused_scan
    from open_simulator_tpu_torch.scheduler.core import AppResource, simulate
    from open_simulator_tpu_torch.scheduler.plugins import SchedulerPlugin, default_registry
    from open_simulator_tpu_torch.utils.gorand import GoRand
    from open_simulator_tpu_torch.utils.trace import GLOBAL

    nodes, pods = a2_inputs()

    def run(device):
        cluster = ResourceTypes()
        cluster.nodes = copy.deepcopy(nodes)
        app = ResourceTypes()
        app.pods = copy.deepcopy(pods)
        reset_name_counter()
        GLOBAL.reset()
        rng = GoRand(A2_SEED)
        if device is None:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = simulate(cluster, [AppResource(A2_APP, app)], engine="cuda", device=device,
                          select_host="sample", rng=rng)
        if device is None:
            torch.cuda.synchronize()
        return {"view": a2_view(result, rng), "s": time.perf_counter() - t0,
                "notes": dict(GLOBAL.notes), "scan_s": GLOBAL.phase_seconds("engine/scan"),
                "placed": sum(len(ns.pods) for ns in result.node_status),
                "unscheduled": len(result.unscheduled_pods)}

    plugin = a2_plugin(SchedulerPlugin)
    default_registry.register(plugin)
    try:
        fused_scan.reset_launch_counts()
        card = run(None)
        launches = dict(fused_scan.LAUNCHES)
        cpu = run("cpu")
    finally:
        default_registry.unregister(plugin.name)
    want_note = 'torch-scan (custom score plugins and select_host="sample")'
    for label, r, dev in (("card", card, "cuda"), ("cpu", cpu, "cpu")):
        notes = r["notes"]
        if notes.get("batch-kernel") != want_note or notes.get("scan-device") != dev:
            raise AssertionError(f"phase 13 ({label}): notes {notes}")
    if any(launches.values()):
        raise AssertionError(f"phase 13: the torch scan's batch launched a kernel: {launches}")
    if card["view"] != cpu["view"]:
        raise AssertionError("phase 13: the card's placements, reasons or RNG history differ "
                             "from the CPU run's")
    digest = a2_digest(card["view"])
    if digest != JAX_SAMPLE_ANSWER:
        raise AssertionError(f"phase 13: digest {digest}, the JAX package's is "
                             f"{JAX_SAMPLE_ANSWER}")
    p = len(pods)
    card_us, cpu_us = card["scan_s"] * 1e6 / p, cpu["scan_s"] * 1e6 / p
    print(f"phase 13 (A2, {N_NODES} nodes x {p} pods, sample + a min-max custom plugin): "
          f"simulate(engine='cuda') on the card == device='cpu' (placements, node status, "
          f"{card['unscheduled']} unscheduled with reasons, the RNG's 607 words) == the JAX "
          f"package's digest {digest[:16]}; fused launches {launches}; card {card['s']:.3f} s "
          f"end to end, engine/scan {card['scan_s'] * 1e3:.1f} ms = {card_us:.1f} us a pod "
          f"step (the CPU: {cpu['s']:.3f} s, {cpu_us:.1f} us a step) [{gpu}]", flush=True)
    return {"card_us": card_us, "cpu_us": cpu_us}


def check_notes(label, notes, allow=()) -> None:
    """Fail the phase when a trace note reports a downgrade or the
    serial floor (the chunked executor's OOM path), unless `allow` names
    it (a phase that injects the fault): on the card the kernels run
    every scenario."""
    bad = {k: v for k, v in notes.items() if k not in allow and (
           k.endswith("-downgrade") or "serial-fallback" in k or k.endswith("-degraded"))}
    if bad:
        raise AssertionError(f"{label}: degraded: {bad}")


def record_rows(pins_first_only=False, site=None):
    """Patch fused_scan.run_fused_scan_batch (the chunk launch of defrag
    and of the outage rows) to record every call, or with
    `pins_first_only` every pins-first call, or with `site` every call
    at that launch site: (plan, class of pod, scenarios, pins_first,
    outputs, start and end CUDA events). Returns (calls, restore)."""
    import torch

    from open_simulator_tpu_torch.ops import fused_scan

    real = fused_scan.run_fused_scan_batch
    calls = []

    def rows(plan, cls, scenarios, pins_first=False, **kw):
        if (pins_first_only and not pins_first) or (site and kw.get("site") != site):
            return real(plan, cls, scenarios, pins_first=pins_first, **kw)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs = real(plan, cls, scenarios, pins_first=pins_first, **kw)
        end.record()
        calls.append((plan, cls, list(scenarios), pins_first, outs, start, end))
        return outs

    fused_scan.run_fused_scan_batch = rows

    def restore():
        fused_scan.run_fused_scan_batch = real

    return calls, restore


def hold_rows(label, gpu, call, picks, plain_pods=None) -> dict:
    """Rows `picks` of one recorded batch launch against the batch
    plain version on the same scenarios (with `plain_pods`, over their
    first that many pods, the kernel launched again on the cut), and
    the same launch again timed by CUDA events: placements and every
    final row equal, or the run fails."""
    from open_simulator_tpu_torch.ops import fused_scan

    plan, cls, scenarios, pins_first, outs, start, end = call
    chosen = [scenarios[i] for i in picks]
    got = [outs[i] for i in picks]
    if plain_pods is not None:
        chosen = prefix(chosen, plain_pods)
        got = fused_scan.run_fused_scan_batch(plan, cls, chosen, pins_first=pins_first)
    want, r_times = timed(lambda: fused_scan.fused_scan_batch_reference(
        plan, cls, chosen, pins_first=pins_first), 1)
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    if err:
        raise AssertionError(f"{label}: rows {picks} != plain version ({err})")
    _, ms = cuda_ms(lambda: fused_scan.run_fused_scan_batch(plan, cls, scenarios,
                                                            pins_first=pins_first))
    from open_simulator_tpu_torch.obs import costs

    b_ms, b_by = costs.bound(plan, cls, scenarios)
    print(f"{label}: rows {picks} of the {len(scenarios)}-scenario launch == plain version"
          + (f" over their first {plain_pods} pods" if plain_pods else "")
          + f" ({r_times[0]:.1f} ms), placements and every row; the launch "
          f"{start.elapsed_time(end):.1f} ms in the path, {ms:.1f} ms again (CUDA events; "
          f"clusters of {fused_scan.CLUSTERS[fused_scan.PINS_FIRST_KERNEL_NAME if pins_first else fused_scan.BATCH_KERNEL_NAME]}), "
          f"bound {b_ms:.4f} ms by {b_by} [{gpu}]", flush=True)
    return {"ms": ms, "plain_ms": r_times[0], "max_abs_err": err, "bound_ms": b_ms,
            "bound_by": b_by}


def phase14(gpu) -> dict:
    """The 8-spec what-if on the capacity scenario through
    probe_plan_multi on the card (one batch launch a live spec a round),
    each spec's count held against its single-spec search on its sweep,
    and the capacity spec's whole result against probe_plan."""
    import torch

    from open_simulator_tpu_torch.apply.applier import probe_plan, probe_plan_multi
    from open_simulator_tpu_torch.models.decode import ResourceTypes
    from open_simulator_tpu_torch.models.workloads import reset_name_counter
    from open_simulator_tpu_torch.ops import fused_scan
    from open_simulator_tpu_torch.parallel import sweep as sweep_mod
    from open_simulator_tpu_torch.scheduler.core import AppResource
    from open_simulator_tpu_torch.utils.trace import GLOBAL

    nodes, deployments, capacity_node = build_capacity_scenario()
    cluster = ResourceTypes()
    cluster.nodes = nodes
    res = ResourceTypes()
    res.deployments = deployments
    apps = [AppResource("bench", res)]
    templates = [capacity_node if (cpu, mem) == (96, 384) else cap_node(f"tpl-{nm}", cpu, mem)
                 for nm, cpu, mem in WHATIF_SPECS]
    jobs = []
    real_multi = sweep_mod.find_min_count_multi

    def multi_search(js, *a, **k):
        jobs.extend(js)
        return real_multi(js, *a, **k)

    sweep_mod.find_min_count_multi = multi_search
    try:
        reset_name_counter()
        GLOBAL.reset()
        fused_scan.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        multi = probe_plan_multi(cluster, apps, templates)
        torch.cuda.synchronize()
        multi_s = time.perf_counter() - t0
    finally:
        sweep_mod.find_min_count_multi = real_multi
    launches = dict(fused_scan.LAUNCHES)
    notes = dict(GLOBAL.notes)
    phases = GLOBAL.as_dict()["phases"]
    check_notes("phase 14", notes)
    rounds, per_round = notes["whatif-rounds"], notes["whatif-round-log"]
    # a spec with no feasible count reports its max-count probe: one
    # single launch each
    failed = sum(1 for r in multi if not r.success)
    if (launches[fused_scan.BATCH_KERNEL_NAME] != notes["whatif-launches"]
            or launches[fused_scan.KERNEL_NAME] != failed
            or any(v for k, v in launches.items()
                   if k not in (fused_scan.BATCH_KERNEL_NAME, fused_scan.KERNEL_NAME))):
        raise AssertionError(f"phase 14: launches {launches}, notes {notes}")

    def view(r):
        return (r.success, r.new_node_count, r.message, r.report_text,
                [(ns.node["metadata"]["name"], [p["metadata"]["name"] for p in ns.pods])
                 for ns in r.result.node_status])

    # checks outside the main path: every spec's single-spec search on
    # its own sweep (the probe_plan search: count and placements), and
    # the whole single-spec probe_plan (report and placements) for the
    # capacity spec
    t0 = time.perf_counter()
    for (nm, _c, _m), r, (sweep, feasible, start) in zip(WHATIF_SPECS, multi, jobs):
        best = sweep.find_min_count(feasible, start=start)
        if (best is None) != (not r.success) or (
                best is not None and best.count != r.new_node_count):
            raise AssertionError(f"phase 14: spec {nm}: multi +{r.new_node_count}, the "
                                 f"single-spec search {best and best.count}")
    cap_i = [nm for nm, _c, _m in WHATIF_SPECS].index("c96")
    reset_name_counter()
    solo = probe_plan(cluster, apps, templates[cap_i])
    if view(solo) != view(multi[cap_i]):
        raise AssertionError("phase 14: the capacity spec's multi result != its probe_plan")
    solo_s = time.perf_counter() - t0
    counts = {nm: (r.new_node_count if r.success else None)
              for (nm, _c, _m), r in zip(WHATIF_SPECS, multi)}
    if counts["c96"] != JAX_CAPACITY_ANSWER:
        raise AssertionError(f"phase 14: the capacity spec plans {counts['c96']}, the JAX "
                             f"package +{JAX_CAPACITY_ANSWER}")
    print(f"phase 14 (8-spec what-if, {CAP_NODES} nodes x {CAP_PODS} pods): counts {counts}, "
          f"each == its single-spec search on the card, the c96 result == its whole "
          f"probe_plan (report and placements; {solo_s:.1f} s for the checks); "
          f"{rounds} rounds, {launches[fused_scan.BATCH_KERNEL_NAME]} batch launches "
          f"(one a live spec a round; launches/time a round {per_round}); probe_plan_multi "
          f"{multi_s:.3f} s [{gpu}]", flush=True)
    print("phase 14: host clock by phase: " + ", ".join(
        f"{ph['name']} {ph['seconds'] * 1e3:.1f} ms x{ph['count']}" for ph in phases)
          + f" [{gpu}]", flush=True)
    return {"launches": launches[fused_scan.BATCH_KERNEL_NAME], "rounds": rounds,
            "s": multi_s}


def phase15(gpu, root) -> str:
    """Phase 6's plan through the CLI with --journal (and --snapshot,
    for phase 16), then with --resume: the resume launches no kernel
    and prints the same JSON. Returns the snapshot's path."""
    import torch

    from open_simulator_tpu_torch.ops import fused_scan

    cfg_root = Path(root) / "capacity"
    cfg_root.mkdir()
    cfg = write_capacity_config(cfg_root)
    journal, snap = str(Path(root) / "plan.jsonl"), str(Path(root) / "snapshot.json")
    runs = []
    for flags in (["--journal", journal, "--snapshot", snap], ["--resume", journal]):
        fused_scan.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc, out, err = run_cli(["apply", "-f", cfg, "--format", "json", "--trace", *flags])
        torch.cuda.synchronize()
        if rc != 0:
            raise AssertionError(f"phase 15: {flags[0]} exited {rc}: {err[-2000:]}")
        runs.append((out, dict(fused_scan.LAUNCHES), time.perf_counter() - t0,
                     json.loads(err.strip().splitlines()[-1])))
    (out1, l1, s1, t1), (out2, l2, s2, t2) = runs
    records = sum(1 for _ in open(journal)) - 1
    if out1 != out2 or any(l2.values()) or not any(l1.values()):
        raise AssertionError(f"phase 15: resume launches {l2} (journal run {l1}), same JSON "
                             f"{out1 == out2}")
    if t2["notes"].get("journal-resume") != f"{records} record(s) replayed":
        raise AssertionError(f"phase 15: resume notes {t2['notes']}")
    print(f"phase 15 (journal): the --journal plan ({s1:.3f} s, launches "
          f"{ {k: v for k, v in l1.items() if v} }, {records} probe records) and its --resume "
          f"({s2:.3f} s, no launch, {records} records replayed) print the same JSON "
          f"(+{json.loads(out1)['newNodeCount']}); snapshot {Path(snap).stat().st_size} bytes "
          f"[{gpu}]", flush=True)
    return snap


def defrag_bench_snapshot():
    """bench.py run_defrag's snapshot at DEFRAG_NODES x DEFRAG_PODS."""
    from open_simulator_tpu_torch.scheduler.core import NodeStatus, SimulateResult

    nodes = [cap_node(f"node-{i:05d}", 32, 128, {"zone": f"z{i % 16}"})
             for i in range(DEFRAG_NODES)]
    _, pods = build_scenario(DEFRAG_NODES, DEFRAG_PODS * 5 // 4)
    pods = [p for p in pods if "nodeSelector" not in p["spec"]][:DEFRAG_PODS]
    statuses = [NodeStatus(node=n, pods=[]) for n in nodes]
    for i, pod in enumerate(pods):
        ns = statuses[i % DEFRAG_NODES]
        pod = dict(pod)
        pod["spec"] = dict(pod["spec"])
        pod["spec"]["nodeName"] = ns.node["metadata"]["name"]
        pod["status"] = {"phase": "Running"}
        ns.pods.append(pod)
    return SimulateResult(unscheduled_pods=[], node_status=statuses)


def phase16(gpu, snap) -> dict:
    """Defrag: (a) bench.py's shape through plan_defrag, every depth in
    one batch launch, all 17 rows == plain; (b) `simon defrag` on phase
    15's full-width snapshot, 101 depths in one launch, the chosen depth
    validated by the module, depths 0, chosen and chosen + 1 == plain."""
    import torch

    from open_simulator_tpu_torch.ops import fused_scan
    from open_simulator_tpu_torch.parallel.defrag import plan_defrag
    from open_simulator_tpu_torch.utils.trace import GLOBAL

    snapshot = defrag_bench_snapshot()
    calls, restore = record_rows()
    try:
        GLOBAL.reset()
        fused_scan.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = plan_defrag(snapshot, max_drain=DEFRAG_MAX)
        torch.cuda.synchronize()
        a_s = time.perf_counter() - t0
        a_launches = dict(fused_scan.LAUNCHES)
        a_notes, a_phases = dict(GLOBAL.notes), GLOBAL.as_dict()["phases"]
    finally:
        restore()
    check_notes("phase 16a", a_notes)
    if (a_launches[fused_scan.BATCH_KERNEL_NAME] != 1 or len(calls) != 1
            or len(calls[0][2]) != DEFRAG_MAX + 1):
        raise AssertionError(f"phase 16a: launches {a_launches}, {len(calls)} row calls")
    print(f"phase 16a (defrag, {DEFRAG_NODES} nodes x {DEFRAG_PODS} pods, max_drain "
          f"{DEFRAG_MAX}): chose depth {res.chosen_depth}, {len(res.moves)} moves, "
          f"unscheduled by depth {[int(x) for x in res.unscheduled]}; {a_s:.3f} s; launches "
          f"{ {k: v for k, v in a_launches.items() if v} }; note "
          f"{a_notes.get('defrag-kernel')!r}; host clock: " + ", ".join(
              f"{ph['name']} {ph['seconds'] * 1e3:.1f} ms" for ph in a_phases)
          + f" [{gpu}]", flush=True)
    small = hold_rows("phase 16a", gpu, calls[0], list(range(DEFRAG_MAX + 1)))

    calls, restore = record_rows()
    try:
        fused_scan.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc, out, err = run_cli(["defrag", "--snapshot", snap, "--max-drain",
                                str(DEFRAG_FULL_MAX), "--format", "json", "--trace"])
        torch.cuda.synchronize()
        b_s = time.perf_counter() - t0
        b_launches = dict(fused_scan.LAUNCHES)
    finally:
        restore()
    if rc != 0:
        raise AssertionError(f"phase 16b: defrag exited {rc}: {err[-2000:]}")
    trace = json.loads(err.strip().splitlines()[-1])
    doc = json.loads(out)
    depth = doc["chosenDepth"]
    unsched = doc["unscheduledByDepth"]
    if (b_launches[fused_scan.BATCH_KERNEL_NAME] != 1 or len(calls) != 1
            or len(unsched) != DEFRAG_FULL_MAX + 1 or unsched[depth] != 0
            or len(doc["drainedNodes"]) != depth):
        raise AssertionError(f"phase 16b: launches {b_launches}, depths {len(unsched)}, "
                             f"chose {depth}")
    n_nodes = len(calls[0][0].alloc[0])
    print(f"phase 16b (defrag of the capacity plan's snapshot, {n_nodes} nodes x "
          f"{len(calls[0][1])} pods, {DEFRAG_FULL_MAX + 1} depths in one launch): chose depth "
          f"{depth} ({len(doc['moves'])} moves), validated by the module's replay; unscheduled "
          f"by depth {unsched[:depth + 3]}...; {b_s:.3f} s through the CLI; launches "
          f"{ {k: v for k, v in b_launches.items() if v} }; host clock: " + ", ".join(
              f"{ph['name']} {ph['seconds'] * 1e3:.1f} ms" for ph in trace["phases"])
          + f" [{gpu}]", flush=True)
    picks = sorted({0, depth, min(depth + 1, DEFRAG_FULL_MAX)})
    full = hold_rows("phase 16b", gpu, calls[0], picks)
    return {"small": small, "full": full,
            "launches": a_launches[fused_scan.BATCH_KERNEL_NAME]
            + b_launches[fused_scan.BATCH_KERNEL_NAME]}


def chaos_cli(label, gpu, argv, want_digest=None, allow=()) -> dict:
    """`simon chaos` (or `apply`) through the port's CLI on the card with
    the counters at 0, the pins-first rows recorded and the ChaosEngine
    kept; with `want_digest`, stdout's sha256 must equal it."""
    import hashlib

    import torch

    from open_simulator_tpu_torch.ops import fused_scan
    from open_simulator_tpu_torch.resilience import chaos as chaos_mod

    engines = []
    real_run = chaos_mod.ChaosEngine.run

    def run(self, *a, **k):
        engines.append(self)
        return real_run(self, *a, **k)

    calls, restore = record_rows(pins_first_only=True)
    chaos_mod.ChaosEngine.run = run
    try:
        fused_scan.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc, out, err = run_cli([*argv, "--trace"], allow=allow)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(fused_scan.LAUNCHES)
    finally:
        restore()
        chaos_mod.ChaosEngine.run = real_run
    if rc not in (0, 1):
        raise AssertionError(f"{label}: {argv[0]} exited {rc}: {err[-2000:]}")
    trace = trace_json(err)
    check_notes(label, trace.get("notes", {}), allow)
    digest = hashlib.sha256(out.encode()).hexdigest()
    if want_digest is not None and digest != want_digest:
        raise AssertionError(f"{label}: stdout digest {digest}, the JAX package's "
                             f"{want_digest}")
    if calls and launches[fused_scan.PINS_FIRST_KERNEL_NAME] != len(calls):
        raise AssertionError(f"{label}: {len(calls)} row calls, launches {launches}")
    return {"rc": rc, "out": out, "calls": calls, "engines": engines, "s": secs,
            "launches": launches, "trace": trace, "digest": digest}


def print_chaos(label, gpu, res) -> None:
    from open_simulator_tpu_torch.ops import fused_scan

    notes = res["trace"].get("notes", {})
    rows = [len(c[2]) for c in res["calls"]]
    ms = [round(c[5].elapsed_time(c[6]), 1) for c in res["calls"]]
    print(f"{label}: exit {res['rc']}, {res['s']:.3f} s through the CLI; pins-first launches "
          f"{res['launches'][fused_scan.PINS_FIRST_KERNEL_NAME]} of {rows} scenarios "
          f"({ms} ms by CUDA events); other launches "
          f"{ {k: v for k, v in res['launches'].items() if v and 'pins-first' not in k} }; "
          f"notes {[notes.get(k) for k in ('chaos-kernel', 'chaos-scenarios')]}; host clock: "
          + ", ".join(f"{ph['name']} {ph['seconds'] * 1e3:.1f} ms"
                      for ph in res["trace"]["phases"]) + f" [{gpu}]", flush=True)


def step_us(call, cluster) -> dict:
    """What a pinned and a free pod step of the pins-first kernel cost,
    on the first scenario of a recorded launch, alone (one cluster at
    the rule's size, so no waves), by CUDA events: the scenario with its
    free pods inactive (its pinned pass, and a second pass that skips
    every pod) over its pinned steps, and the scenario with every pin
    cleared (a pass that skips every pod, then every pod free) over its
    pods. Also the waves of the launch, which ran on clusters of
    `cluster` blocks."""
    import numpy as np

    from open_simulator_tpu_torch.ops import fused_scan

    plan, cls, scenarios, _pf, _outs, start, end = call
    a, v, q = scenarios[0]
    a, q = np.asarray(a, bool), np.asarray(q)
    pinned_only = [(a & (q >= 0), v, q)]
    all_free = [(a, v, np.full_like(q, -1))]

    def run(scen):
        return fused_scan.run_fused_scan_batch(plan, cls, scen, pins_first=True)

    run(pinned_only)  # warm
    _, pin_ms = cuda_ms(lambda: run(pinned_only))
    _, free_ms = cuda_ms(lambda: run(all_free))
    n_pin, n_free = int((a & (q >= 0)).sum()), int(a.sum())
    s_n = len(scenarios)
    one_c = fused_scan.CLUSTERS[fused_scan.PINS_FIRST_KERNEL_NAME]
    resident = fused_scan.max_active_clusters(plan, s_n, True, cluster)
    return {"pin_us": pin_ms * 1e3 / max(n_pin, 1), "free_us": free_ms * 1e3 / max(n_free, 1),
            "pin_ms": pin_ms, "free_ms": free_ms, "n_pin": n_pin, "n_free": n_free,
            "one_cluster": one_c, "resident": resident, "waves": -(-s_n // max(resident, 1)),
            "launch_ms": start.elapsed_time(end)}


def phase17(gpu, root) -> dict:
    """Outages: (a) `simon chaos --failures 0` on the capacity scenario;
    (b) `--failures 2 --trials 32` on its 2,000-node cut, three rows ==
    plain and the worst outage confirmed serially, and the JAX package's
    bytes on the smaller cut; (c) `apply --tolerate-node-failures 1` on
    the 2,000-node cut, and the JAX package's bytes on the smaller cut."""
    from open_simulator_tpu_torch.ops import fused_scan

    out = {}
    cfgs = {}
    for name, n, p in (("full", CAP_NODES, CAP_PODS), ("cut", CHAOS_NODES, CHAOS_PODS),
                       ("jax", CHAOS_JAX_NODES, CHAOS_JAX_PODS)):
        d = Path(root) / f"chaos-{name}"
        d.mkdir()
        cfgs[name] = write_capacity_config(d, n, p)

    a = chaos_cli("phase 17a", gpu, ["chaos", "-f", cfgs["full"], "--failures", "0",
                                     "--format", "json"])
    doc = json.loads(a["out"])
    if doc["total"] != 1 or doc["baselineNewNodeCount"] != JAX_CAPACITY_ANSWER or len(
            a["calls"]) != 1:
        raise AssertionError(f"phase 17a: {doc['total']} scenarios at "
                             f"+{doc['baselineNewNodeCount']}, {len(a['calls'])} launches")
    print_chaos(f"phase 17a (replacement study, {CAP_NODES} nodes x {CAP_PODS} pods, "
                f"+{doc['baselineNewNodeCount']}; survived {doc['survived']}/1)", gpu, a)
    out["full"] = hold_rows("phase 17a", gpu, a["calls"][0], [0], plain_pods=CHAOS_PLAIN_PODS)

    b = chaos_cli("phase 17b", gpu, ["chaos", "-f", cfgs["cut"], "--failures", "2",
                                     "--trials", "32", "--format", "json"])
    doc = json.loads(b["out"])
    if doc["total"] < CHAOS_NODES or len(b["calls"]) != 1:
        raise AssertionError(f"phase 17b: {doc['total']} scenarios, {len(b['calls'])} calls")
    print_chaos(f"phase 17b ({CHAOS_NODES} nodes x {CHAOS_PODS} pods at "
                f"+{doc['baselineNewNodeCount']}, K=2: {doc['total']} scenarios "
                f"({doc['mode']}), survived {doc['survived']})", gpu, b)
    call = b["calls"][0]
    s_n = len(call[2])
    cluster = fused_scan.CLUSTERS[fused_scan.PINS_FIRST_KERNEL_NAME]
    out["cut"] = hold_rows("phase 17b", gpu, call, [0, s_n // 2, s_n - 1])
    st = step_us(call, cluster)
    out["cut"].update(pin_us=st["pin_us"], free_us=st["free_us"], cluster=cluster)
    workspace_check("phase 17b", gpu, call[0], call[1], call[2], batch=True, pins_first=True)
    out["lie"] = chaos_lie(gpu, cfgs["cut"], b)
    engine = b["engines"][0]
    worst_label = max(doc["scenarios"], key=lambda o: (o["unschedulable"], o["displaced"]))
    scen = next(sc for sc in engine.build_scenarios(2, 1, 32)[0]
                if list(sc.failed_names) == worst_label["failedNodes"])
    t0 = time.perf_counter()
    ok, newly = engine.confirm_serial(scen)
    if ok != (worst_label["unschedulable"] == 0) or newly != worst_label["unschedulable"]:
        raise AssertionError(f"phase 17b: serial confirmation of [{scen.label()}] found "
                             f"{newly} newly unschedulable, the batch {worst_label}")
    print(f"phase 17b: the worst outage [{scen.label()}] re-simulated serially: {newly} newly "
          f"unschedulable, as the batch row says ({time.perf_counter() - t0:.1f} s host) "
          f"[{gpu}]", flush=True)
    print(f"phase 17b: the launch {st['launch_ms']:.1f} ms for {s_n} scenarios on clusters of "
          f"{cluster}, {st['resident']} resident at once ({st['waves']} waves); its first "
          f"scenario alone on {st['one_cluster']} blocks: its {st['n_pin']} pinned pods "
          f"{st['pin_ms']:.3f} ms = {st['pin_us']:.3f} us a pinned pod step; all "
          f"{st['n_free']} pods free {st['free_ms']:.3f} ms = {st['free_us']:.3f} us a free "
          f"pod step [{gpu}]", flush=True)

    j = chaos_cli("phase 17b (the JAX package's cut)", gpu,
                  ["chaos", "-f", cfgs["jax"], "--failures", "2", "--trials", "32",
                   "--format", "json"], want_digest=JAX_CHAOS_ANSWER)
    print(f"phase 17b: {CHAOS_JAX_NODES} nodes x {CHAOS_JAX_PODS} pods, K=2: stdout == the "
          f"JAX package's (sha256 {j['digest'][:16]}), exit {j['rc']} [{gpu}]", flush=True)

    c = chaos_cli("phase 17c", gpu, ["apply", "-f", cfgs["cut"], "--format", "json",
                                     "--tolerate-node-failures", "1"])
    doc = json.loads(c["out"])
    notes = c["trace"]["notes"]
    if not doc["success"] or not notes.get("chaos-serial-confirm", "").endswith("ok"):
        raise AssertionError(f"phase 17c: success {doc['success']}, notes {notes}")
    print_chaos(f"phase 17c (apply --tolerate-node-failures 1, {CHAOS_NODES} nodes x "
                f"{CHAOS_PODS} pods): +{doc['newNodeCount']}, escalation "
                f"{notes.get('nplusk-escalation')!r}, serial confirmation "
                f"{notes.get('chaos-serial-confirm')!r}", gpu, c)
    jn = chaos_cli("phase 17c (the JAX package's cut)", gpu,
                   ["apply", "-f", cfgs["jax"], "--format", "json",
                    "--tolerate-node-failures", "1"], want_digest=JAX_NPLUSK_ANSWER)
    print(f"phase 17c: {CHAOS_JAX_NODES} nodes x {CHAOS_JAX_PODS} pods, N+1: stdout == the "
          f"JAX package's (sha256 {jn['digest'][:16]}) [{gpu}]", flush=True)
    out["launches"] = sum(r["launches"][fused_scan.PINS_FIRST_KERNEL_NAME] for r in (a, b, c))
    return out


def chaos_lie(gpu, cfg, b) -> dict:
    """Phase 17b's outages at its committed count under
    `--inject ledger.predict_fit=lie:high`: the ledger's first verdict
    (the outage rows' chunk) says nothing fits, so the rows split in two
    before any launch; the report is phase 17b's, and no OOM is caught."""
    from open_simulator_tpu_torch.utils.trace import COUNTERS

    doc = json.loads(b["out"])
    reactive = COUNTERS.get("guard_oom_reactive_total")
    lie = chaos_cli("phase 17b (ledger.predict_fit=lie:high)", gpu,
                    ["chaos", "-f", cfg, "--failures", "2", "--trials", "32", "--format", "json",
                     "--new-node-count", str(doc["baselineNewNodeCount"]),
                     "--inject", "ledger.predict_fit=lie:high"],
                    allow=("chaos-chunk-predicted-split", "chaos-degraded"))
    notes = lie["trace"]["notes"]
    caught = COUNTERS.get("guard_oom_reactive_total") - reactive
    if (lie["out"] != b["out"] or len(lie["calls"]) != 2 or caught
            or "chaos-chunk-predicted-split" not in notes):
        raise AssertionError(f"phase 17b (lie:high): same report {lie['out'] == b['out']}, "
                             f"{len(lie['calls'])} launches, {caught} OOMs caught, notes {notes}")
    print(f"phase 17b (--inject ledger.predict_fit=lie:high, --new-node-count "
          f"{doc['baselineNewNodeCount']}): split before launch "
          f"({notes['chaos-chunk-predicted-split']!r}), {len(lie['calls'])} pins-first launches "
          f"of {[len(c[2]) for c in lie['calls']]} scenarios, 0 OOMs caught; the report is "
          f"phase 17b's, byte for byte, in {lie['s']:.3f} s [{gpu}]", flush=True)
    return {"s": lie["s"]}


def a1g_plugin(base):
    """Phase 18's custom score plugin on `base` (either package's
    SchedulerPlugin): five levels from the node's zone (none on a new
    node) and the pod's app, normalised min-max."""
    class ZoneApp(base):
        name = "zone-app"
        normalize = "minmax"

        def score(self, pod, node):
            zone = node["metadata"].get("labels", {}).get("zone", "z16")
            app = (pod["metadata"].get("labels") or {}).get("app", "")
            return (int(zone[1:]) + len(app)) % 5

    return ZoneApp()


def phase18(gpu, root) -> dict:
    """A1g: a capacity plan with a registered custom score plugin through
    the CLI on the card: the sweep's probes ride the torch scan
    (trace-noted), no fused kernel launches, and stdout equals the JAX
    package's bytes (tools/jax_custom_plan_answer.py)."""
    import hashlib

    import torch

    from open_simulator_tpu_torch.ops import fused_scan
    from open_simulator_tpu_torch.scheduler.plugins import SchedulerPlugin, default_registry

    d = Path(root) / "a1g"
    d.mkdir()
    cfg = write_capacity_config(d, A1G_NODES, A1G_PODS)
    plugin = a1g_plugin(SchedulerPlugin)
    default_registry.register(plugin)
    try:
        fused_scan.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc, out, err = run_cli(["apply", "-f", cfg, "--format", "json", "--trace"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(fused_scan.LAUNCHES)
    finally:
        default_registry.unregister(plugin.name)
    trace = json.loads(err.strip().splitlines()[-1])
    notes = trace["notes"]
    digest = hashlib.sha256(out.encode()).hexdigest()
    if rc != 0 or notes.get("sweep-kernel") != "torch-scan (custom score plugins)" or any(
            launches.values()):
        raise AssertionError(f"phase 18: exit {rc}, notes {notes}, launches {launches}: "
                             f"{err[-1000:]}")
    if digest != JAX_A1G_ANSWER:
        raise AssertionError(f"phase 18: stdout digest {digest}, the JAX package's "
                             f"{JAX_A1G_ANSWER}")
    probe_s = sum(ph["seconds"] for ph in trace["phases"] if ph["name"] == "sweep/probe")
    n_probe = sum(ph["count"] for ph in trace["phases"] if ph["name"] == "sweep/probe")
    print(f"phase 18 (A1g, {A1G_NODES} nodes x {A1G_PODS} pods, a min-max custom plugin): "
          f"+{json.loads(out)['newNodeCount']} == the JAX package's bytes (sha256 "
          f"{digest[:16]}); {n_probe} torch-scan probes, {probe_s:.3f} s = "
          f"{probe_s * 1e6 / max(n_probe * A1G_PODS, 1):.1f} us a pod step; {secs:.3f} s "
          f"through the CLI; no fused launch [{gpu}]", flush=True)
    return {"s": secs}


# ---- phases 19-21: the live-cluster import, the guard and observability
# flags, the observatory against the card

class StubApiServer:
    """The seven LIST endpoints of a live cluster on 127.0.0.1, in a
    thread: pages of `limit` items with `continue` tokens, and one
    `continue` of `expire_path` answered with HTTP 410 (the client then
    restarts its pagination anchored at the resourceVersion)."""

    def __init__(self, routes, expire_path="/api/v1/pods"):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qs, urlsplit

        self.routes = routes
        self.requests = 0
        self.expired = []
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                split = urlsplit(self.path)
                query = parse_qs(split.query)
                outer.requests += 1
                route = outer.routes.get(split.path)
                if route is None:
                    self.send_response(404)
                    self.end_headers()
                    self.wfile.write(b"{}")
                    return
                kind, api_version, items = route
                if "continue" in query and split.path == expire_path and not outer.expired:
                    outer.expired.append(query["continue"][0])
                    self.send_response(410)
                    self.end_headers()
                    self.wfile.write(b"{}")
                    return
                limit = int(query.get("limit", ["0"])[0] or 0)
                start = int(query.get("continue", ["0"])[0] or 0)
                meta = {"resourceVersion": "7"}
                page = items
                if limit:
                    page = items[start:start + limit]
                    if start + limit < len(items):
                        meta["continue"] = str(start + limit)
                body = json.dumps({"kind": kind, "apiVersion": api_version,
                                   "metadata": meta, "items": page}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.server.server_port}"

    def stop(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)


def build_live_cluster(n_nodes=CAP_NODES, n_bound=KUBE_BOUND_PODS):
    """The capacity shape's nodes with `n_bound` Running pods bound to
    them (a fifth owned by a ReplicaSet), the objects the import must
    drop (DaemonSet-owned, Pending and terminating pods, one every
    KUBE_DROP_EVERY), and a PDB, a service, a storage class and a PVC.
    Returns (nodes, kept pods, every served pod, extras by kind)."""
    nodes, _deployments, _new = build_capacity_scenario(n_nodes, 0)
    def pod(i, node=None, phase="Running", owner=None, deleting=False):
        # no requests (BestEffort, as sidecar-less agents often are): the
        # capacity apps still plan within MAX_NUM_NEW_NODE new nodes
        out = {"kind": "Pod", "apiVersion": "v1",
               "metadata": {"name": f"live-{i:06d}", "namespace": "live",
                            "labels": {"app": f"live-{i % 7}"}},
               "spec": {"containers": [{"name": "c", "image": "img-live"}]},
               "status": {"phase": phase}}
        if node is not None:
            out["spec"]["nodeName"] = node
        if owner:
            out["metadata"]["ownerReferences"] = [{"kind": owner, "name": f"{owner.lower()}-x"}]
        if deleting:
            out["metadata"]["deletionTimestamp"] = "2026-01-01T00:00:00Z"
        return out

    names = [n["metadata"]["name"] for n in nodes]
    kept, served = [], []
    for i in range(n_bound):
        p = pod(i, names[i % n_nodes], owner="ReplicaSet" if i % 5 == 0 else None)
        kept.append(p)
        served.append(p)
        if i % KUBE_DROP_EVERY == 0:
            j = n_bound + i
            served += [pod(j, names[i % n_nodes], owner="DaemonSet"),
                       pod(j + 1, phase="Pending"),
                       pod(j + 2, names[i % n_nodes], deleting=True)]
    extras = {
        "pod_disruption_budgets": [{"kind": "PodDisruptionBudget", "apiVersion": "policy/v1beta1",
                                    "metadata": {"name": "live-pdb", "namespace": "live"},
                                    "spec": {"minAvailable": 1,
                                             "selector": {"matchLabels": {"app": "live-1"}}}}],
        "services": [{"kind": "Service", "apiVersion": "v1",
                      "metadata": {"name": "live-svc", "namespace": "live"},
                      "spec": {"selector": {"app": "live-2"}}}],
        "storage_classes": [{"kind": "StorageClass", "apiVersion": "storage.k8s.io/v1",
                             "metadata": {"name": "standard"}, "provisioner": "x"}],
        "persistent_volume_claims": [{"kind": "PersistentVolumeClaim", "apiVersion": "v1",
                                      "metadata": {"name": "live-claim", "namespace": "live"},
                                      "spec": {"storageClassName": "standard"}}],
    }
    return nodes, kept, served, extras


def write_live_configs(root, n_nodes=CAP_NODES, n_bound=KUBE_BOUND_PODS, n_pods=CAP_PODS):
    """The live cluster behind a stub apiserver, and two simon configs
    that plan the capacity apps on it: one with `kubeConfig` (the
    import), one with the same cluster as a customConfig directory (the
    objects the import keeps). Returns (server, kube cfg, custom cfg,
    kept pods, served pods)."""
    import yaml

    dumper = getattr(yaml, "CSafeDumper", yaml.SafeDumper)
    root = Path(root)
    nodes, kept, served, extras = build_live_cluster(n_nodes, n_bound)
    _n, deployments, new_node = build_capacity_scenario(n_nodes, n_pods)
    routes = {
        "/api/v1/nodes": ("NodeList", "v1", nodes),
        "/api/v1/pods": ("PodList", "v1", served),
        "/apis/policy/v1beta1/poddisruptionbudgets": (
            "PodDisruptionBudgetList", "policy/v1beta1", extras["pod_disruption_budgets"]),
        "/api/v1/services": ("ServiceList", "v1", extras["services"]),
        "/apis/storage.k8s.io/v1/storageclasses": (
            "StorageClassList", "storage.k8s.io/v1", extras["storage_classes"]),
        "/api/v1/persistentvolumeclaims": (
            "PersistentVolumeClaimList", "v1", extras["persistent_volume_claims"]),
        "/apis/apps/v1/daemonsets": ("DaemonSetList", "apps/v1", []),
    }
    server = StubApiServer(routes)
    for sub, docs in (("cluster", nodes + kept + [o for v in extras.values() for o in v]),
                      ("app", deployments), ("newnode", [new_node])):
        (root / sub).mkdir()
        with open(root / sub / "objects.yaml", "w") as f:
            yaml.dump_all(docs, f, Dumper=dumper)
    kubeconfig = root / "kubeconfig"
    kubeconfig.write_text(yaml.safe_dump({
        "apiVersion": "v1", "kind": "Config", "current-context": "live",
        "contexts": [{"name": "live", "context": {"cluster": "live", "user": "u"}}],
        "clusters": [{"name": "live", "cluster": {"server": server.url}}],
        "users": [{"name": "u", "user": {"token": "stub"}}]}))
    cfgs = []
    for name, cluster in (("kube", {"kubeConfig": str(kubeconfig)}),
                          ("custom", {"customConfig": str(root / "cluster")})):
        cfg = root / f"simon-{name}.yaml"
        cfg.write_text(yaml.safe_dump({
            "apiVersion": "simon/v1alpha1", "kind": "Config", "metadata": {"name": name},
            "spec": {"cluster": cluster, "appList": [{"name": "bench", "path": str(root / "app")}],
                     "newNode": str(root / "newnode")}}))
        cfgs.append(str(cfg))
    return server, cfgs[0], cfgs[1], kept, served


def trace_json(err) -> dict:
    """The `--trace` JSON a CLI run printed to stderr (its last JSON
    line: `--trace-out` prints its own line after it)."""
    return json.loads(next(line for line in reversed(err.strip().splitlines())
                           if line.startswith("{")))


def launch_spans(path) -> list:
    """The `launch/<site>` spans of a Chrome trace, by name."""
    with open(path) as f:
        doc = json.load(f)
    return doc, [e["name"] for e in doc["traceEvents"]
                 if e.get("ph") == "X" and e["name"].startswith("launch/")]


def phase19(gpu, root, n_nodes=CAP_NODES, n_bound=KUBE_BOUND_PODS, n_pods=CAP_PODS,
            device=None) -> dict:
    """A1e: a live cluster (n_nodes nodes, n_bound bound Running pods and
    the objects the import must drop) served by a stub apiserver, paged
    at 500 with one continue answered 410, planned with the capacity
    apps through `apply --format json --trace-out` on the card with the
    counters at 0; the report == the same cluster as a customConfig
    directory planned on the card; one span a launch; the observatory
    block with costs, ledger and histograms; the launch counter == the
    fused scan's launches."""
    import torch

    from open_simulator_tpu_torch.models import kubeclient
    from open_simulator_tpu_torch.obs import profile
    from open_simulator_tpu_torch.ops import fused_scan

    on_card = device is None
    extra = [] if on_card else ["--device", device]
    t0 = time.perf_counter()
    server, kube_cfg, custom_cfg, kept, served = write_live_configs(root, n_nodes, n_bound,
                                                                   n_pods)
    print(f"phase 19: a stub apiserver at {server.url} serving {n_nodes} nodes and "
          f"{len(served)} pods ({len(kept)} bound Running, {len(served) - len(kept)} the "
          f"import must drop), a PDB, a service, a storage class and a PVC; the same cluster "
          f"as a customConfig directory ({time.perf_counter() - t0:.2f} s set-up)", flush=True)
    trace_path = str(Path(root) / "kube-trace.json")
    try:
        before = profile.snapshot()
        fused_scan.reset_launch_counts()
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc, out, err = run_cli(["apply", "-f", kube_cfg, "--format", "json", "--trace",
                                "--trace-out", trace_path, *extra])
        if on_card:
            torch.cuda.synchronize()
        kube_s = time.perf_counter() - t0
        launches = dict(fused_scan.LAUNCHES)
        delta = profile.delta(before)
        requests, expired = server.requests, list(server.expired)
    finally:
        server.stop()
    if rc != 0:
        raise AssertionError(f"phase 19: the kubeConfig plan exited {rc}: {err[-2000:]}")
    trace = trace_json(err)
    if not expired or requests < len(served) // kubeclient.LIST_PAGE_LIMIT + 2:
        raise AssertionError(f"phase 19: {requests} requests, expired continues {expired}")
    t0 = time.perf_counter()
    rc2, out2, err2 = run_cli(["apply", "-f", custom_cfg, "--format", "json", *extra])
    custom_s = time.perf_counter() - t0
    if rc2 != 0 or out2 != out:
        raise AssertionError(f"phase 19: the kubeConfig report != the customConfig report "
                             f"(rc {rc2}, {len(out)} vs {len(out2)} bytes)")
    doc = json.loads(out)
    placed = {p["name"] for n in doc["nodes"] for p in n["pods"]}
    dropped = {p["metadata"]["name"] for p in served} - {p["metadata"]["name"] for p in kept}
    if not doc["success"] or placed & dropped or not {
            p["metadata"]["name"] for p in kept} <= placed:
        raise AssertionError(f"phase 19: success {doc['success']}; the report holds "
                             f"{len(placed & dropped)} dropped pods")
    tdoc, spans = launch_spans(trace_path)
    block = tdoc.get("simonObservatory", {})
    want_blocks = {"costs", "histograms"} | ({"ledger"} if on_card else set())
    kernel_launches = sum(launches.values())
    if len(spans) != delta["launches_total"] or not want_blocks <= set(block):
        raise AssertionError(f"phase 19: {len(spans)} launch spans for "
                             f"{delta['launches_total']} launches; observatory "
                             f"{sorted(block)}")
    if on_card and delta["device_launches_total"] != kernel_launches:
        raise AssertionError(f"phase 19: the launch counter {delta} != the fused scan's "
                             f"launches {launches}")
    load_ms = next(ph["seconds"] for ph in trace["phases"] if ph["name"] == "apply/load") * 1e3
    print(f"phase 19 (A1e): apply on the kubeConfig cluster: +{doc['newNodeCount']} nodes, "
          f"{len(placed)} pods placed ({len(kept)} bound pods kept, {len(dropped)} dropped) in "
          f"{kube_s:.3f} s (the customConfig run {custom_s:.3f} s): the two reports are "
          f"byte-identical ({len(out)} bytes); import and load (apply/load) {load_ms:.1f} ms "
          f"over {requests} requests, one 410 on continue {expired[0]}; launches {launches}, "
          f"counted {delta['launches_total']} ({delta['device_launches_total']} on the card), "
          f"{len(spans)} launch spans; h2d {delta['device_transfer_h2d_bytes_total']} B, "
          f"d2h {delta['device_transfer_d2h_bytes_total']} B [{gpu}]", flush=True)
    print(f"phase 19: host clock by phase: " + ", ".join(
        f"{ph['name']} {ph['seconds'] * 1e3:.1f} ms" for ph in trace["phases"]) + f" [{gpu}]",
        flush=True)
    costs_block = {k: v for k, v in block["costs"].items() if k != "_totals"}
    hist = {k: {q: v[q] for q in ("count", "p50_ms", "p95_ms")}
            for k, v in block["histograms"].items()}
    print(f"phase 19: observatory: cost records {json.dumps(costs_block)}; launch "
          f"histograms {json.dumps(hist)}; ledger "
          f"{json.dumps({k: block.get('ledger', {}).get(k) for k in ('peak_bytes', 'samples', 'watermarks')})} "
          f"[{gpu}]", flush=True)
    return {"launches": launches, "doc": doc, "load_ms": load_ms, "s": kube_s}


def phase20(gpu, root, cap, device=None) -> dict:
    """Phase 6's plan under the guard and observability flags: (a)
    `--journal J --inject budget.check=deadline@2` exits 3 with a PARTIAL
    JSON; `--resume J` (table) answers phase 6's count and launches only
    the probes the journal lacks; (b) `-i` on a scripted shell (all apps,
    add 55 nodes, all nodes) prints that table report, one launch a
    guess; (c) `--inject jit.sweep_many=oom@1 --explain NS/NAME` halves
    the batch launch, notes it and answers phase 6's JSON; the named
    pod's chosen node is its node in the report and its verdicts cover
    every node."""
    import torch

    from open_simulator_tpu_torch.obs import profile
    from open_simulator_tpu_torch.ops import fused_scan

    extra = [] if device is None else ["--device", device]
    want = cap["doc"]
    count = want["newNodeCount"]
    d = Path(root) / "guard"
    d.mkdir()
    cfg = write_capacity_config(d, *cap["shape"])
    journal = str(d / "plan.jsonl")

    def cli(argv, stdin=None, allow=()):
        """(exit code, stdout, stderr, launches counted by the
        instrumented launch, seconds); on the card the counter must
        equal the fused scan's launches."""
        fused_scan.reset_launch_counts()
        before = profile.snapshot()
        if device is None:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _stdin(stdin or ""):
            rc, out, err = run_cli(argv + extra, allow=allow)
        if device is None:
            torch.cuda.synchronize()
        launches = profile.delta(before)["launches_total"]
        if device is None and launches != sum(fused_scan.LAUNCHES.values()):
            raise AssertionError(f"phase 20: {launches} counted launches, the fused scan's "
                                 f"{fused_scan.LAUNCHES}")
        return rc, out, err, launches, time.perf_counter() - t0

    rc, out, err, l_halt, s_halt = cli(["apply", "-f", cfg, "--format", "json", "--journal",
                                        journal, "--inject", "budget.check=deadline@2"])
    partial = json.loads(out)
    done = [p["count"] for p in partial["detail"]["completedProbes"]]
    if rc != 3 or not partial["partial"] or partial["reason"] != "deadline" or not done:
        raise AssertionError(f"phase 20a: exit {rc}, {out[:500]}")
    rc, table, err, l_res, s_res = cli(["apply", "-f", cfg, "--resume", journal])
    if rc != 0 or f"new nodes added: {count}\n" not in table:
        raise AssertionError(f"phase 20a: --resume exited {rc} without +{count}: {err[-800:]}")
    if l_res != cap["launches_total"] - l_halt:
        raise AssertionError(f"phase 20a: the resume launched {l_res} times, the plan "
                             f"{cap['launches_total']} of which {l_halt} before the halt")
    print(f"phase 20a (--deadline/--inject, --journal, --resume): the halted plan exited 3 "
          f"after {s_halt:.3f} s with a PARTIAL JSON ({len(done)} probe(s) {done} journaled, "
          f"{l_halt} launch(es)); --resume answered +{count} in {s_res:.3f} s with {l_res} "
          f"launch(es), the plan's {cap['launches_total']} less the journaled [{gpu}]",
          flush=True)

    script = f"\n1\n{count}\n\n"
    rc, shell_out, err, l_i, s_i = cli(["apply", "-f", cfg, "-i"], stdin=script)
    if rc != 0 or not shell_out.endswith(table) or l_i != 2:
        raise AssertionError(f"phase 20b: -i exited {rc}, report == the table "
                             f"{shell_out.endswith(table)}, launches {l_i}")
    print(f"phase 20b (-i): the scripted shell (all apps; add {count} nodes; all nodes) "
          f"printed the --resume run's table report ({len(table)} bytes) after its prompts, "
          f"in {s_i:.3f} s; one launch a guess: {l_i} [{gpu}]", flush=True)

    pod = next(p for n in want["nodes"] for p in n["pods"] if p["app"] == "bench")
    node_of = {p["name"]: n["name"] for n in want["nodes"] for p in n["pods"]}
    target = f"{pod['namespace']}/{pod['name']}"
    rc, out, err, l_oom, s_oom = cli(
        ["apply", "-f", cfg, "--format", "json", "--trace", "--inject", "jit.sweep_many=oom@1",
         "--explain", target], allow=("sweep-chunk-halving", "sweep-degraded"))
    doc = json.loads(out)
    explain = doc.pop("explain")
    notes = trace_json(err)["notes"]
    if rc != 0 or doc != want or "sweep-chunk-halving" not in notes:
        raise AssertionError(f"phase 20c: exit {rc}, same JSON {doc == want}, notes {notes}")
    rec = next(r for r in explain if r["name"] == pod["name"])
    seen = len(rec["verdicts"]) + rec["truncatedNodes"]
    if rec["chosenNode"] != node_of[pod["name"]] or seen != rec["totalNodes"] or (
            rec["totalNodes"] != len(want["nodes"])):
        raise AssertionError(f"phase 20c: explain of {target}: chosen {rec['chosenNode']} "
                             f"(report {node_of[pod['name']]}), {seen} verdicts of "
                             f"{rec['totalNodes']} nodes")
    print(f"phase 20c (--inject jit.sweep_many=oom@1, --explain {target}): the first batch "
          f"launch raised a device OOM and was halved (note "
          f"{notes['sweep-chunk-halving']!r}); the JSON == phase 6's (+{count}) in "
          f"{s_oom:.3f} s, launches {l_oom}; the pod's chosen node {rec['chosenNode']} is its "
          f"node in the report, {rec['feasibleNodes']} of {rec['totalNodes']} nodes feasible, "
          f"{len(rec['verdicts'])} verdict rows + {rec['truncatedNodes']} counted [{gpu}]",
          flush=True)
    return {"resume": l_res, "shell": l_i, "oom": l_oom}


@contextlib.contextmanager
def _stdin(text):
    """sys.stdin reads `text` (a scripted shell)."""
    import io

    real = sys.stdin
    sys.stdin = io.StringIO(text)
    try:
        yield
    finally:
        sys.stdin = real


def phase21(gpu, root, device=None) -> dict:
    """The quickstart with `--explain POD --profile-dir D` on the card:
    stdout == the JAX package's (tools/jax_explain_answer.py), and the
    captures of the device phases name the fused-scan kernel."""
    import hashlib
    import os

    extra = [] if device is None else ["--device", device]
    prof = Path(root) / "profile"
    rc, out, err = run_cli(["apply", "-f", QUICKSTART, "--format", "json", "--explain",
                            EXPLAIN_POD, "--profile-dir", str(prof), *extra], cwd=ROOT)
    digest = hashlib.sha256(out.encode()).hexdigest()
    if rc != 0 or digest != JAX_EXPLAIN_ANSWER:
        raise AssertionError(f"phase 21: exit {rc}, stdout sha256 {digest}, the JAX package's "
                             f"{JAX_EXPLAIN_ANSWER}: {err[-1000:]}")
    kernels, files = {}, sorted(os.listdir(prof))
    for name in files:
        with open(prof / name) as f:
            events = json.load(f)["traceEvents"]
        for e in events:
            if e.get("cat") == "kernel":
                kernels[e["name"][:60]] = kernels.get(e["name"][:60], 0) + 1
    if device is None and not any("fused_scan" in k for k in kernels):
        raise AssertionError(f"phase 21: the captures {files} name no fused-scan kernel: "
                             f"{sorted(kernels)}")
    print(f"phase 21 (--explain {EXPLAIN_POD}, --profile-dir): stdout == the JAX package's "
          f"(sha256 {digest[:16]}); torch.profiler captures {files}, kernels by name "
          f"{kernels} [{gpu}]", flush=True)
    return {"captures": files, "kernels": kernels}


# ---- phases 22-23: the timeline and the shadow auditor


def write_timeline_config(root, n_nodes=TL_NODES) -> str:
    """Phase 22's cluster as a simon config under `root`: the default
    scenario's `n_nodes` nodes, one day-0 pod bound to each untainted
    node requesting all but TL_FREE_CPU cores and 4 GiB of it, and the
    capacity scenario's 96 cpu / 384 GiB new node."""
    import yaml

    dumper = getattr(yaml, "CSafeDumper", yaml.SafeDumper)
    root = Path(root)
    nodes, _ = build_scenario(n_nodes, 0)
    day0 = []
    for i, node in enumerate(nodes):
        if node.get("spec", {}).get("taints"):
            continue
        cpu = int(node["status"]["allocatable"]["cpu"])
        name = node["metadata"]["name"]
        day0.append({"kind": "Pod", "metadata": {"name": f"day0-{i:05d}", "namespace": "day0"},
                     "spec": {"nodeName": name, "containers": [{
                         "name": "c", "image": "img-day0", "resources": {"requests": {
                             "cpu": str(cpu - TL_FREE_CPU),
                             "memory": f"{4 * cpu - 4}Gi"}}}]}})
    for sub, docs in (("cluster", nodes + day0), ("newnode", [cap_node("template", 96, 384)])):
        (root / sub).mkdir(parents=True)
        with open(root / sub / "objects.yaml", "w") as f:
            yaml.dump_all(docs, f, Dumper=dumper)
    cfg = root / "simon-config.yaml"
    cfg.write_text(yaml.safe_dump({
        "apiVersion": "simon/v1alpha1", "kind": "Config", "metadata": {"name": "timeline"},
        "spec": {"cluster": {"customConfig": str(root / "cluster")},
                 "newNode": str(root / "newnode")}}))
    return str(cfg)


def timeline_argv(cfg, arrivals=TL_ARRIVALS, max_nodes=TL_MAX_NODES):
    return ["timeline", "-f", cfg, "--synthetic", str(arrivals), *TL_FLAGS,
            "--max-nodes", str(max_nodes), "--format", "json"]


def timeline_digest(stdout) -> str:
    """sha256 of a timeline JSON report with its `engine` set aside (the
    JAX package names its engine `tpu`, the port `cuda` or `oracle`)."""
    import hashlib

    doc = json.loads(stdout)
    doc.pop("engine")
    return hashlib.sha256(json.dumps(doc, sort_keys=True).encode()).hexdigest()


def write_shadow_config(root, n_nodes=SHADOW_NODES, n_pods=SHADOW_DECISIONS) -> str:
    """Phase 23's inputs as a simon config under `root`: the default
    scenario's `n_nodes` nodes and its first `n_pods` pods as one app."""
    import yaml

    dumper = getattr(yaml, "CSafeDumper", yaml.SafeDumper)
    root = Path(root)
    nodes, pods = build_scenario(n_nodes, n_pods)
    for pod in pods:
        pod["kind"] = "Pod"
    for sub, docs in (("cluster", nodes), ("app", pods)):
        (root / sub).mkdir(parents=True)
        with open(root / sub / "objects.yaml", "w") as f:
            yaml.dump_all(docs, f, Dumper=dumper)
    cfg = root / "simon-config.yaml"
    cfg.write_text(yaml.safe_dump({
        "apiVersion": "simon/v1alpha1", "kind": "Config", "metadata": {"name": "shadow"},
        "spec": {"cluster": {"customConfig": str(root / "cluster")},
                 "appList": [{"name": "bench", "path": str(root / "app")}]}}))
    return str(cfg)


def shadow_digest(stdout) -> str:
    """sha256 of a shadow JSON report with SHADOW_ASIDE set aside."""
    import hashlib

    doc = {k: v for k, v in json.loads(stdout).items() if k not in SHADOW_ASIDE}
    return hashlib.sha256(json.dumps(doc, sort_keys=True).encode()).hexdigest()


def phase22(gpu, root) -> dict:
    """The timeline through the CLI on the card at full width with the
    counters at 0: a window and a probe decision each one pins-first
    launch (launches == the report's dispatches), threshold and probe
    scale up, static:0 ends with pods pending, no degradation note; the
    first window's launch == run_fused_scan_batch on the CPU plain
    version; at the cut, the digest == the JAX package's and the port's
    serial oracle's."""
    import numpy as np
    import torch

    from open_simulator_tpu_torch.ops import fused_scan
    from open_simulator_tpu_torch.utils.trace import COUNTERS

    t0 = time.perf_counter()
    cfg = write_timeline_config(Path(root) / "timeline-full")
    write_s = time.perf_counter() - t0
    calls, restore = record_rows(pins_first_only=True)
    try:
        fused_scan.reset_launch_counts()
        before = COUNTERS.get("launches_timeline_sweep")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc, out, err = run_cli([*timeline_argv(cfg), "--trace-phases"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(fused_scan.LAUNCHES)
        site = COUNTERS.get("launches_timeline_sweep") - before
    finally:
        restore()
    if rc != 0:
        raise AssertionError(f"phase 22: timeline exited {rc}: {err[-2000:]}")
    doc = json.loads(out)
    trace = trace_json(err)
    pols = {p["policy"]: p for p in doc["policies"]}
    ups = {name: sum(1 for d in p["decisions"] if d["delta"] > 0) for name, p in pols.items()}
    pf = launches[fused_scan.PINS_FIRST_KERNEL_NAME]
    others = {k: v for k, v in launches.items() if v and k != fused_scan.PINS_FIRST_KERNEL_NAME}
    if not (pf == site == doc["dispatches"] == len(calls) > 0) or others:
        raise AssertionError(f"phase 22: pins-first launches {pf}, timeline_sweep {site}, "
                             f"dispatches {doc['dispatches']}, calls {len(calls)}, other "
                             f"launches {others}")
    if not (ups["threshold"] and ups["probe"] and pols["static:0"]["finalPending"] > 0):
        raise AssertionError(f"phase 22: scale-ups {ups}, static:0 ends with "
                             f"{pols['static:0']['finalPending']} pending")
    dev_ms = [c[5].elapsed_time(c[6]) for c in calls]
    rows = [len(c[2]) for c in calls]
    window = next(c for c in calls if len(c[2]) <= 3)
    probe = [ms for ms, r in zip(dev_ms, rows) if r > 3]
    plan, cls, scenarios, pins_first, outs, start, end = window
    t0 = time.perf_counter()
    want = fused_scan.run_fused_scan_batch(plan.to("cpu"), cls, scenarios, pins_first=True)
    plain_s = time.perf_counter() - t0
    got = [(g[0].cpu(), {k: v.cpu() for k, v in g[1].items()}) for g in outs]
    err_w = max(max_abs_err(g, w) for g, w in zip(got, want))
    if err_w:
        raise AssertionError(f"phase 22: the first window's launch != the CPU plain version "
                             f"({err_w})")
    active = [int(np.asarray(a).sum()) for a, _v, _q in scenarios]
    free = [int((np.asarray(a) & (np.asarray(q) < 0)).sum()) for a, _v, q in scenarios]
    phases = {ph["name"]: ph["seconds"] for ph in trace["phases"]}
    print(f"phase 22 (timeline, {TL_NODES} nodes + {TL_MAX_NODES} candidates, "
          f"{doc['arrivals']} arrivals, {doc['events']} events, policies "
          f"{list(pols)}): exit 0, {secs:.3f} s through the CLI (config written in "
          f"{write_s:.1f} s); {doc['windows']} windows, {doc['dispatches']} dispatches == "
          f"{pf} pins-first launches == launches_timeline_sweep; scale-ups {ups}; final "
          f"pending { {k: p['finalPending'] for k, p in pols.items()} }, peak nodes "
          f"{ {k: p['peakNodes'] for k, p in pols.items()} }; report {len(out)} bytes "
          f"[{gpu}]", flush=True)
    print(f"phase 22: card time of the launches by CUDA events: {sum(dev_ms):.1f} ms in all; "
          f"windows (<= 3 rows) {len(dev_ms) - len(probe)} launches, "
          f"{sum(dev_ms) - sum(probe):.1f} ms; probe decisions {len(probe)} launches of "
          f"{max(rows)} rows, {sum(probe):.1f} ms (clusters of "
          f"{fused_scan.CLUSTERS[fused_scan.PINS_FIRST_KERNEL_NAME]} at the last); host "
          f"clock: " + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in phases.items())
          + f" [{gpu}]", flush=True)
    print(f"phase 22: the first window's launch ({len(scenarios)} rows, {active} active pods, "
          f"{free} free, {start.elapsed_time(end):.3f} ms on the card) == "
          f"run_fused_scan_batch on the CPU plain version ({plain_s:.1f} s), placements and "
          f"every row [{gpu}]", flush=True)
    del calls, window, outs, got, want

    cut = {}
    for name, n, arrivals, cand, engines, want in (
            ("jax", TL_JAX_NODES, TL_JAX_ARRIVALS, TL_JAX_MAX_NODES, ("cuda",),
             JAX_TIMELINE_ANSWER),
            ("oracle", TL_ORACLE_NODES, TL_ORACLE_ARRIVALS, TL_ORACLE_MAX_NODES,
             ("cuda", "oracle"), JAX_TIMELINE_ORACLE_ANSWER)):
        cfg_cut = write_timeline_config(Path(root) / f"timeline-{name}", n)
        for engine in engines:
            fused_scan.reset_launch_counts()
            t0 = time.perf_counter()
            rc, out_c, _err = run_cli([*timeline_argv(cfg_cut, arrivals, cand),
                                       "--engine", engine])
            got = (rc, timeline_digest(out_c) if rc == 0 else None,
                   fused_scan.LAUNCHES[fused_scan.PINS_FIRST_KERNEL_NAME])
            cut[(name, engine)] = got + (time.perf_counter() - t0,)
            if got[:2] != (0, want) or bool(got[2]) != (engine == "cuda"):
                raise AssertionError(f"phase 22: the {n}-node cut on {engine}: exit {got[0]}, "
                                     f"digest {got[1]}, {got[2]} launches; the JAX "
                                     f"package's {want}")
        print(f"phase 22: {n} nodes x {arrivals} arrivals, {cand} candidates: "
              + " and ".join(f"{'the card' if e == 'cuda' else 'the serial oracle'} "
                             f"({cut[(name, e)][2]} launches, {cut[(name, e)][3]:.1f} s)"
                             for e in engines)
              + f" print the JAX package's report (sha256 {want[:16]}, engine aside) [{gpu}]",
              flush=True)
        if name == "jax":
            # an OOM injected at the first launch halves that chunk on the
            # card: one more launch, the same report
            fused_scan.reset_launch_counts()
            rc, out_c, err_c = run_cli([*timeline_argv(cfg_cut, arrivals, cand),
                                        "--inject", "jit.timeline_sweep=oom@1",
                                        "--trace-phases"],
                                       allow=("timeline-chunk-halving", "timeline-degraded"))
            notes = trace_json(err_c).get("notes", {})
            halved = fused_scan.LAUNCHES[fused_scan.PINS_FIRST_KERNEL_NAME]
            if (rc, timeline_digest(out_c) if rc == 0 else None) != (0, want) or \
                    "timeline-chunk-halving" not in notes or halved != cut[(name, "cuda")][2] + 1:
                raise AssertionError(f"phase 22: jit.timeline_sweep=oom@1: exit {rc}, "
                                     f"{halved} launches, notes {notes}")
            print(f"phase 22: --inject jit.timeline_sweep=oom@1 at the {n}-node cut: "
                  f"{notes['timeline-chunk-halving']!r}, {halved} launches, the same report "
                  f"[{gpu}]", flush=True)
    return {"launches": pf, "secs": secs, "windows": doc["windows"],
            "dispatches": doc["dispatches"], "device_ms": sum(dev_ms)}


def phase23(gpu, root) -> dict:
    """The shadow auditor through the CLI at full width: `--record` on
    the serial oracle, then `--decision-log` on the card with the
    counters at 0 (agreement 1.0, one B1 launch a decision, zero nvcc
    builds), then `timeline --from-decision-log` over the log; at the
    cut, the log's bytes and the replay's report == the JAX package's."""
    import hashlib

    import torch

    from open_simulator_tpu_torch.obs import profile
    from open_simulator_tpu_torch.obs.histo import HISTOS, percentile_from_counts
    from open_simulator_tpu_torch.ops import fused_scan
    from open_simulator_tpu_torch.utils.trace import COUNTERS, GLOBAL

    rec = prepared(root, "shadow-full")
    cfg, log, rec_s = rec["cfg"], rec["log"], rec["seconds"]
    if rec["rc"] != 0:
        raise AssertionError(f"phase 23: --record exited {rec['rc']}: {rec['err'][-2000:]}")
    print(f"phase 23 (shadow, {SHADOW_NODES} nodes): {rec['out'].strip()} in {rec_s:.1f} s on "
          f"the serial oracle = {rec_s * 1e3 / SHADOW_DECISIONS:.1f} ms a decision (host, a "
          f"process beside the earlier phases) [{gpu}]", flush=True)

    fused_scan.reset_launch_counts()
    GLOBAL.reset()
    before = {k: COUNTERS.get(k) for k in ("launches_scan", "nvcc_builds_total")}
    hist = HISTOS.get("launch/scan")
    counts0, sum0 = list(hist.counts), hist.sum
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc, out, err = run_cli(["shadow", "-f", cfg, "--decision-log", log, "--format", "json"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(fused_scan.LAUNCHES)
    moved = {k: COUNTERS.get(k) - v for k, v in before.items()}
    doc = json.loads(out) if out.startswith("{") else {}
    n_dec = doc.get("decisions", 0)
    others = {k: v for k, v in launches.items() if v and k != fused_scan.KERNEL_NAME}
    if rc != 0 or doc.get("agreementRate") != 1.0 or n_dec < SHADOW_DECISIONS:
        raise AssertionError(f"phase 23: exit {rc}, {doc.get('taxonomy')}: {err[-2000:]}")
    if not (launches[fused_scan.KERNEL_NAME] == moved["launches_scan"] == n_dec
            == doc["obs"]["deviceLaunches"]) or others:
        raise AssertionError(f"phase 23: {n_dec} decisions, launches {launches}, "
                             f"launches_scan {moved['launches_scan']}, obs {doc['obs']}")
    if doc["warmBuilds"] or moved["nvcc_builds_total"] or doc["buildSteps"]:
        raise AssertionError(f"phase 23: nvcc builds during the replay: {moved}, "
                             f"{doc['buildSteps']}")
    profile.resolve_pending(wait=True)
    counts = [c - c0 for c, c0 in zip(hist.counts, counts0)]
    p50, p95 = (percentile_from_counts(counts, q) for q in (50, 95))
    phases = {ph["name"]: ph["seconds"] for ph in GLOBAL.as_dict()["phases"]}
    print(f"phase 23: --decision-log on the card: exit 0, agreement {doc['agreementRate']} over "
          f"{n_dec} decisions, {launches[fused_scan.KERNEL_NAME]} {fused_scan.KERNEL_NAME} "
          f"launches (one a decision, cluster {fused_scan.CLUSTERS[fused_scan.KERNEL_NAME]}), "
          f"0 nvcc builds; {secs:.3f} s = {secs * 1e3 / n_dec:.2f} ms a decision; launch/scan "
          f"device time {(hist.sum - sum0) * 1e3:.1f} ms in all, p50 {p50 * 1e3:.3f} ms, p95 "
          f"{p95 * 1e3:.3f} ms over {sum(counts)} launches; host clock: "
          + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in phases.items()) + f" [{gpu}]",
          flush=True)

    fused_scan.reset_launch_counts()
    t0 = time.perf_counter()
    rc, out_t, err_t = run_cli(["timeline", "-f", cfg, "--from-decision-log", log,
                                "--compare", "static:0,threshold", "--format", "json"])
    tl_s = time.perf_counter() - t0
    tl = json.loads(out_t) if rc == 0 else {}
    tl_launches = fused_scan.LAUNCHES[fused_scan.PINS_FIRST_KERNEL_NAME]
    if rc != 0 or tl["arrivals"] != n_dec or tl_launches != tl["dispatches"]:
        raise AssertionError(f"phase 23: timeline --from-decision-log exited {rc}, "
                             f"{tl.get('arrivals')} arrivals, {tl_launches} launches: "
                             f"{err_t[-2000:]}")
    print(f"phase 23: timeline --from-decision-log over the log: {tl['arrivals']} arrivals, "
          f"{tl['windows']} windows, {tl_launches} pins-first launches, final pending "
          f"{[p['finalPending'] for p in tl['policies']]}, {tl_s:.1f} s [{gpu}]", flush=True)

    cut_rec = prepared(root, "shadow-cut")
    cfg_cut, log_cut, rc, err = (cut_rec[k] for k in ("cfg", "log", "rc", "err"))
    t0 = time.perf_counter()
    log_digest = hashlib.sha256(Path(log_cut).read_bytes()).hexdigest()
    rc2, out_c, err2 = run_cli(["shadow", "-f", cfg_cut, "--decision-log", log_cut,
                                "--format", "json"])
    cut_s = time.perf_counter() - t0 + cut_rec["seconds"]
    digest = shadow_digest(out_c) if rc2 == 0 else None
    if rc or rc2 or log_digest != JAX_SHADOW_LOG_ANSWER or digest != JAX_SHADOW_ANSWER:
        raise AssertionError(f"phase 23: the cut: exit {rc}/{rc2}, log {log_digest}, report "
                             f"{digest}; the JAX package's {JAX_SHADOW_LOG_ANSWER}, "
                             f"{JAX_SHADOW_ANSWER}: {(err + err2)[-2000:]}")
    print(f"phase 23: {SHADOW_JAX_NODES} nodes x {SHADOW_JAX_DECISIONS} decisions: the log "
          f"(sha256 {log_digest[:16]}) and the card's replay report (sha256 {digest[:16]}, "
          f"the engine and compiler fields aside) == the JAX package's, {cut_s:.1f} s [{gpu}]",
          flush=True)
    return {"launches": n_dec, "secs": secs, "record_s": rec_s, "tl_launches": tl_launches}


def build_serve_cluster(n_nodes=SERVE_NODES, n_pods=SERVE_PODS):
    """Phase 24's cluster: nodes of 64 cores and 256 GiB in SERVE_ZONES
    zones, and bare pods of 500m / 1 GiB (bench.py run_delta_resim)."""
    nodes = [{"kind": "Node",
              "metadata": {"name": f"serve-n-{i:05d}",
                           "labels": {"kubernetes.io/hostname": f"serve-n-{i:05d}",
                                      "zone": f"z{i % SERVE_ZONES}"}},
              "status": {"allocatable": {"cpu": "64", "memory": "256Gi", "pods": "110"}}}
             for i in range(n_nodes)]
    pods = [serve_pod(f"serve-p-{i:05d}") for i in range(n_pods)]
    return nodes, pods


def serve_pod(name, cpu="500m", mem="1Gi"):
    return {"kind": "Pod", "metadata": {"name": name, "namespace": "serve"},
            "spec": {"containers": [{"name": "c", "image": "app", "resources": {
                "requests": {"cpu": cpu, "memory": mem}}}]}}


def serve_envelope(name, replicas=SERVE_REPLICAS, cpu="500m", mem="1Gi", zone=None) -> dict:
    """The POST /v1/simulate body of one Deployment."""
    spec = {"containers": [{"name": "c", "image": f"img-{name}", "resources": {
        "requests": {"cpu": cpu, "memory": mem}}}]}
    if zone:
        spec["nodeSelector"] = {"zone": zone}
    dep = {"kind": "Deployment", "metadata": {"name": name, "namespace": "whatif"},
           "spec": {"replicas": replicas, "template": {"spec": spec}}}
    return {"apps": [{"name": name, "yaml": json.dumps(dep)}]}


def serve_deltas(pods, evict_at, n_arrive, tag="late"):
    """Delta records: evict the pods at positions `evict_at`, then
    `n_arrive` new pods."""
    recs = [{"kind": "pod_evict", "namespace": "serve", "name": pods[i]["metadata"]["name"]}
            for i in evict_at]
    recs += [{"kind": "pod_arrive", "pod": serve_pod(f"serve-{tag}-{k}")}
             for k in range(n_arrive)]
    return recs


def http_json(base, path, doc=None, timeout=600, headers=None):
    """(status, headers, body bytes) of a GET (doc None) or a JSON POST."""
    import urllib.error
    import urllib.request

    data = None if doc is None else json.dumps(doc).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def serve_storm(base, envelopes, threads):
    """POST every envelope, `threads` clients at once, each its share in
    order: [(status, headers, body, seconds)] in envelope order, and the
    wall time."""
    import threading

    out = [None] * len(envelopes)

    def client(k):
        for i in range(k, len(envelopes), threads):
            t0 = time.perf_counter()
            status, headers, body = http_json(base, "/v1/simulate", envelopes[i])
            out[i] = (status, headers, body, time.perf_counter() - t0)

    t0 = time.perf_counter()
    workers = [threading.Thread(target=client, args=(k,)) for k in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    return out, time.perf_counter() - t0


def serve_tick(daemon, base, envelopes):
    """POST the envelopes while the dispatcher is held, release it once
    all are queued: one coalesced tick (up to --max-batch). Returns the
    replies in envelope order."""
    import threading

    daemon.coalescer.hold.clear()
    time.sleep(0.3)  # the dispatcher parks at the hold between ticks
    out = [None] * len(envelopes)

    def client(i):
        out[i] = http_json(base, "/v1/simulate", envelopes[i])

    workers = [threading.Thread(target=client, args=(i,)) for i in range(len(envelopes))]
    for w in workers:
        w.start()
    t0 = time.perf_counter()
    while daemon.coalescer.depth < len(envelopes) and time.perf_counter() - t0 < 120:
        time.sleep(0.01)
    daemon.coalescer.hold.set()
    for w in workers:
        w.join()
    return out


def serve_cut_digest(Session, ServeDaemon, ResourceTypes, reset_name_counter, **session_kw):
    """Phase 24c's cut through the Session and ServeDaemon classes given
    (with that package's ResourceTypes and name counter) in this
    process: SERVE_JAX_NODES x SERVE_JAX_PODS committed, one tick of the
    SERVE_CUT_REQUESTS, two evictions near the tail and two arrivals over
    POST /v1/cluster-delta, GET /v1/state-digest, the requests again in
    one tick. Returns the sha256 of the bodies, the digest document and
    the committed scan's state digest, in that order, and the seconds it
    took (tools/jax_serve_answer.py runs it on the JAX package; the
    port's must print the same)."""
    import hashlib
    import threading

    t0 = time.perf_counter()
    nodes, pods = build_serve_cluster(SERVE_JAX_NODES, SERVE_JAX_PODS)
    cluster = ResourceTypes()
    cluster.nodes, cluster.pods = nodes, list(pods)
    reset_name_counter()
    session = Session(cluster, **session_kw)
    daemon = ServeDaemon(session, port=0, max_batch=len(SERVE_CUT_REQUESTS), queue_depth=64)
    daemon.coalescer.hold = threading.Event()
    daemon.start()
    h = hashlib.sha256()
    try:
        base = f"http://{daemon.host}:{daemon.port}"
        envelopes = [serve_envelope(f"cut-{i}", r, cpu, mem, zone)
                     for i, (r, cpu, mem, zone) in enumerate(SERVE_CUT_REQUESTS)]
        first = serve_tick(daemon, base, envelopes)
        status, _h, delta = http_json(base, "/v1/cluster-delta", {"deltas": serve_deltas(
            pods, (len(pods) - 50, len(pods) - 20), 2)})
        d_status, _h, digest = http_json(base, "/v1/state-digest")
        committed = json.dumps(session._committed_scan().state_digest(),
                               sort_keys=True).encode()
        second = serve_tick(daemon, base, envelopes)
    finally:
        daemon.coalescer.hold.set()
        daemon.shutdown()
    replies = first + second
    if status != 200 or d_status != 200 or any(r[0] != 200 for r in replies):
        raise AssertionError(f"the serve cut ({Session.__module__}): statuses {[r[0] for r in replies]}, "
                             f"delta {status} {delta[:200]!r}, digest {d_status}")
    for r in first:
        h.update(r[2])
    h.update(digest)
    h.update(committed)
    for r in second:
        h.update(r[2])
    return h.hexdigest(), time.perf_counter() - t0


def standalone_body(cluster, envelope) -> bytes:
    """A standalone simulate(engine="cuda") of one request on a fresh
    copy of the cluster, name counter reset: the body a one-shot run
    would answer."""
    import copy

    from open_simulator_tpu_torch.models.workloads import reset_name_counter
    from open_simulator_tpu_torch.scheduler.core import simulate
    from open_simulator_tpu_torch.serve.server import parse_request_body
    from open_simulator_tpu_torch.serve.session import result_payload

    req, _d, _t = parse_request_body(json.dumps(envelope).encode(), "application/json")
    reset_name_counter()
    return result_payload(simulate(copy.deepcopy(cluster), req.apps, engine="cuda"))


def phase24(gpu, root=None) -> dict:
    """The what-if daemon at full width on the card, with the counters
    at 0 for each of its two driven parts: (a) the committed scan of
    SERVE_PODS pods on SERVE_NODES nodes and SERVE_EVICTIONS +
    SERVE_ARRIVALS deltas, the re-simulated state == a fresh committed
    scan, the committed scan == B1's plain version over its first
    SERVE_PLAIN_PODS pods, the widest suffix re-simulation's launch ==
    B1's plain version on its inputs; (b) an in-process daemon under two
    storms of SERVE_CLIENTS x SERVE_PER_CLIENT requests: every reply 200
    from the coalesced scan (no request routed serial, no batch error),
    fewer launches than requests, one `scenario_scan` launch a tick, the
    first tick's launch == the CPU plain version, sampled bodies ==
    standalone simulate(), then a delta and the state digest over HTTP
    and a what-if after them; (c) the cut == the JAX package's digest."""
    import copy

    import numpy as np
    import torch

    from open_simulator_tpu_torch.incremental.resim import CommittedScan
    from open_simulator_tpu_torch.models.decode import ResourceTypes
    from open_simulator_tpu_torch.models.workloads import reset_name_counter
    from open_simulator_tpu_torch.obs.histo import HISTOS, percentile_from_counts
    from open_simulator_tpu_torch.ops import fused_scan
    from open_simulator_tpu_torch.serve.server import ServeDaemon
    from open_simulator_tpu_torch.serve.session import Session
    from open_simulator_tpu_torch.twin.deltas import ClusterDelta
    from open_simulator_tpu_torch.utils.trace import COUNTERS, GLOBAL

    def moved(before):
        return {k: COUNTERS.get(k) - v for k, v in before.items()}

    keys = ("launches_scan", "launches_scenario_scan", "serve_device_dispatches_total",
            "serve_batches_total", "serve_admission_serial_total", "serve_batch_errors_total",
            "incremental_suffix_pods_total", "incremental_resims_total",
            "incremental_full_rebuilds_total", "nvcc_builds_total")

    # ---- (a) the committed scan and the deltas
    nodes, pods = build_serve_cluster()
    cluster = ResourceTypes()
    cluster.nodes, cluster.pods = nodes, copy.deepcopy(pods)
    GLOBAL.reset()
    fused_scan.reset_launch_counts()
    before = {k: COUNTERS.get(k) for k in keys}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reset_name_counter()
    session = Session(cluster)
    build_s = time.perf_counter() - t0
    committed = session._committed_scan()
    torch.cuda.synchronize()
    commit_s = time.perf_counter() - t0 - build_s
    journal0 = list(committed.node_names[:SERVE_PLAIN_PODS])
    recs = serve_deltas(pods, [SERVE_EVICT_FROM + 100 * k for k in range(SERVE_EVICTIONS)],
                        SERVE_ARRIVALS)
    d_times, outcomes, suffix_calls = [], [], []
    real_scan = fused_scan.run_fused_scan

    def record_suffix(plan, cls, active, valid, pinned=None, site="scan"):
        outs = real_scan(plan, cls, active, valid, pinned, site=site)
        suffix_calls.append((plan, cls, active, valid, pinned, outs))
        return outs

    fused_scan.run_fused_scan = record_suffix
    try:
        for rec in recs:
            t1 = time.perf_counter()
            outcomes.append(session.apply_delta(ClusterDelta.from_record(copy.deepcopy(rec))))
            d_times.append((time.perf_counter() - t1) * 1e3)
    finally:
        fused_scan.run_fused_scan = real_scan
    torch.cuda.synchronize()
    launches_a = dict(fused_scan.LAUNCHES)
    moved_a = moved(before)
    phases_a = {ph["name"]: ph["seconds"] for ph in GLOBAL.as_dict()["phases"]}
    check_notes("phase 24a", GLOBAL.notes)
    roster = len(session.cluster_pods)
    suffix = moved_a["incremental_suffix_pods_total"] - SERVE_PODS
    if outcomes != ["applied"] * len(recs) or not (suffix * 20 < len(recs) * roster):
        raise AssertionError(f"phase 24a: delta outcomes {outcomes}, {suffix} suffix pods "
                             f"re-simulated for {len(recs)} deltas over {roster}")
    if moved_a["nvcc_builds_total"] or launches_a[fused_scan.BATCH_KERNEL_NAME]:
        raise AssertionError(f"phase 24a: launches {launches_a}, {moved_a}")
    t1 = time.perf_counter()
    fresh = CommittedScan(session.cluster.nodes, session.cluster_pods)
    fresh_s = time.perf_counter() - t1
    if session._committed_scan().state_digest() != fresh.state_digest():
        raise AssertionError("phase 24a: the re-simulated committed state != a fresh "
                             "committed scan of the mutated roster")
    del fresh
    # the widest suffix re-simulation's launch against B1's plain version
    # on the same inputs (the fresh scan above runs the kernel as well)
    s_plan, s_cls, s_active, s_valid, s_pinned, s_outs = max(
        suffix_calls, key=lambda c: int(np.asarray(c[2]).sum()))
    t1 = time.perf_counter()
    s_want = fused_scan.fused_scan_reference(s_plan, s_cls, s_active, s_valid, s_pinned)
    torch.cuda.synchronize()
    suffix_plain_s = time.perf_counter() - t1
    suffix_err = max_abs_err(s_outs, s_want)
    suffix_width = int(np.asarray(s_active).sum())
    if suffix_err:
        raise AssertionError(f"phase 24a: the widest suffix re-simulation ({suffix_width} "
                             f"pods) != B1's plain version ({suffix_err})")
    del suffix_calls, s_plan, s_outs, s_want
    plan, batch, names = encode(nodes, pods[:SERVE_PLAIN_PODS], "cuda")
    p = len(names)
    t1 = time.perf_counter()
    place, _final = fused_scan.fused_scan_reference(plan, batch.class_of_pod, np.ones(p, bool),
                                                   np.ones(plan.n, bool), batch.pinned_node)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t1
    plain_at = dict(zip(names, (nodes[int(i)]["metadata"]["name"] if i >= 0 else None
                                for i in place.cpu().numpy())))
    journal_at = dict(zip((q["metadata"]["name"] for q in pods[:SERVE_PLAIN_PODS]), journal0))
    if plain_at != journal_at:
        bad = sum(1 for k in plain_at if plain_at[k] != journal_at.get(k))
        raise AssertionError(f"phase 24a: the committed scan != B1's plain version over the "
                             f"first {SERVE_PLAIN_PODS} pods ({bad} pods differ)")
    del plan, batch, place
    print(f"phase 24a (serve, {SERVE_NODES} nodes x {SERVE_PODS} committed pods): session "
          f"built in {build_s * 1e3:.1f} ms, the committed scan {commit_s * 1e3:.1f} ms "
          f"({launches_a[fused_scan.KERNEL_NAME]} {fused_scan.KERNEL_NAME} launches in all, "
          f"cluster {fused_scan.CLUSTERS[fused_scan.KERNEL_NAME]}); {len(recs)} deltas "
          f"({SERVE_EVICTIONS} evictions from position {SERVE_EVICT_FROM}, {SERVE_ARRIVALS} "
          f"arrivals) all applied, {moved_a['incremental_resims_total']} re-simulations, "
          f"{moved_a['incremental_full_rebuilds_total']} full rebuilds, {suffix} suffix pods "
          f"(x20 < {len(recs)} x {roster}); ms a delta p50 {statistics.median(d_times):.1f}, "
          f"max {max(d_times):.1f}; re-simulated state == a fresh committed scan "
          f"({fresh_s * 1e3:.1f} ms); the widest suffix launch ({suffix_width} pods of "
          f"{len(s_cls)}) == B1's plain version, max_abs_err {suffix_err} "
          f"({suffix_plain_s:.1f} s); the committed scan == B1's plain version over its first "
          f"{SERVE_PLAIN_PODS} pods ({plain_s:.1f} s); host clock: "
          + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in phases_a.items()) + f" [{gpu}]",
          flush=True)

    # ---- (b) the daemon under load
    daemon = ServeDaemon(session, port=0, max_batch=SERVE_MAX_BATCH, queue_depth=256)
    daemon.start()
    base = f"http://{daemon.host}:{daemon.port}"
    n_req = SERVE_CLIENTS * SERVE_PER_CLIENT
    try:
        warm, warm_s = serve_storm(base, [serve_envelope(f"warm-{i}") for i in range(n_req)],
                                   SERVE_CLIENTS)
        hist = HISTOS.get("launch/scenario_scan")
        counts0, sum0 = list(hist.counts), hist.sum
        GLOBAL.reset()
        fused_scan.reset_launch_counts()
        before = {k: COUNTERS.get(k) for k in keys}
        calls, restore = record_rows(site="scenario_scan")
        try:
            envelopes = [serve_envelope(f"storm-{i}") for i in range(n_req)]
            storm, storm_s = serve_storm(base, envelopes, SERVE_CLIENTS)
            extra_delta = serve_deltas(pods, (), 1, tag="http")
            d_status, _h, d_body = http_json(base, "/v1/cluster-delta",
                                             {"deltas": extra_delta})
            s_status, _h, s_body = http_json(base, "/v1/state-digest")
            after_env = serve_envelope("after-delta")
            a_status, a_headers, a_body = http_json(base, "/v1/simulate", after_env)
        finally:
            restore()
        torch.cuda.synchronize()
        launches_b = dict(fused_scan.LAUNCHES)
        moved_b = moved(before)
        counts = [c - c0 for c, c0 in zip(hist.counts, counts0)]
        card_ms = (hist.sum - sum0) * 1e3
        phases_b = {ph["name"]: ph["seconds"] for ph in GLOBAL.as_dict()["phases"]}
        check_notes("phase 24b", GLOBAL.notes)
    finally:
        code = daemon.shutdown()
    statuses = [r[0] for r in warm + storm] + [d_status, s_status, a_status]
    ticks = moved_b["serve_device_dispatches_total"]
    if any(st != 200 for st in statuses) or code != 0:
        raise AssertionError(f"phase 24b: statuses {statuses}, drain exit {code}: "
                             f"{[r[2][:300] for r in warm + storm if r[0] != 200][:2]}")
    engines = {r[1].get("X-Simon-Engine") for r in storm} | {a_headers.get("X-Simon-Engine")}
    if (moved_b["serve_admission_serial_total"] or moved_b["serve_batch_errors_total"]
            or engines != {"coalesced-scan"}):
        raise AssertionError(f"phase 24b: not every request went through the coalesced scan: "
                             f"engines {engines}, {moved_b}")
    if not (ticks < n_req + 1 and moved_b["launches_scenario_scan"] == ticks == len(calls)
            == launches_b[fused_scan.BATCH_KERNEL_NAME]):
        raise AssertionError(f"phase 24b: {ticks} dispatches for {n_req + 1} requests, "
                             f"launches_scenario_scan {moved_b['launches_scenario_scan']}, "
                             f"recorded {len(calls)}, kernel launches {launches_b}")
    if moved_b["nvcc_builds_total"]:
        raise AssertionError(f"phase 24b: nvcc builds during the storm: {moved_b}")
    # the first tick's launch, and the widest one, against the plain version
    widest = max(range(len(calls)), key=lambda i: len(calls[i][2]))
    t1 = time.perf_counter()
    for i in sorted({0, widest}):
        plan, cls, scenarios, _pf, outs, _start, _end = calls[i]
        want = fused_scan.run_fused_scan_batch(plan.to("cpu"), cls, scenarios)
        got = [(g[0].cpu(), {k: v.cpu() for k, v in g[1].items()}) for g in outs]
        err_t = max(max_abs_err(g, w) for g, w in zip(got, want))
        if err_t:
            raise AssertionError(f"phase 24b: tick {i}'s launch != the CPU plain version "
                                 f"({err_t})")
    tick_plain_s = time.perf_counter() - t1
    first_rows, wide_rows = len(calls[0][2]), len(calls[widest][2])
    wide_pods = len(calls[widest][1])
    picks = np.linspace(0, n_req - 1, SERVE_SAMPLES).astype(int)
    pre_delta = copy.deepcopy(session.cluster)
    pre_delta.pods = [q for q in pre_delta.pods
                      if q["metadata"]["name"] != extra_delta[0]["pod"]["metadata"]["name"]]
    t1 = time.perf_counter()
    for i in picks:
        if storm[i][2] != standalone_body(pre_delta, envelopes[i]):
            raise AssertionError(f"phase 24b: request {i}'s body != a standalone simulate()")
    if a_body != standalone_body(session.cluster, after_env):
        raise AssertionError("phase 24b: the what-if after the delta != a standalone "
                             "simulate() of the mutated cluster")
    sample_s = time.perf_counter() - t1
    lat = sorted(r[3] for r in storm)
    p50, p95 = (percentile_from_counts(counts, q) for q in (50, 95))
    digest = json.loads(s_body)
    print(f"phase 24b (the daemon, --max-batch {SERVE_MAX_BATCH}, {SERVE_CLIENTS} clients x "
          f"{SERVE_PER_CLIENT} POSTs of a {SERVE_REPLICAS}-replica Deployment): every reply "
          f"200; the measured storm {n_req / storm_s:.2f} qps ({storm_s:.3f} s; the warm one "
          f"{warm_s:.3f} s), latency p50 {statistics.median(lat) * 1e3:.1f} ms, p95 "
          f"{lat[int(0.95 * (len(lat) - 1))] * 1e3:.1f} ms; {ticks} ticks for {n_req + 1} "
          f"requests (mean fill {(n_req + 1) / max(moved_b['serve_batches_total'], 1):.2f}), "
          f"{ticks / (n_req + 1):.3f} launches a request, every reply from the coalesced "
          f"scan, each tick one "
          f"{fused_scan.BATCH_KERNEL_NAME} launch (cluster "
          f"{fused_scan.CLUSTERS[fused_scan.BATCH_KERNEL_NAME]}); scenario_scan card time by "
          f"CUDA events {card_ms:.2f} ms in all, p50 {p50 * 1e3:.3f} ms, p95 {p95 * 1e3:.3f} "
          f"ms over {sum(counts)} launches; host clock: "
          + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in phases_b.items()) + f" [{gpu}]",
          flush=True)
    print(f"phase 24b: the first tick's launch ({first_rows} rows) and the widest "
          f"({wide_rows} rows, {wide_pods} pods) == run_fused_scan_batch on the CPU plain "
          f"version ({tick_plain_s:.1f} s), placements and every row; {SERVE_SAMPLES} sampled bodies and the what-if after POST "
          f"/v1/cluster-delta (deltaSeq {digest['deltaSeq']}, stateDigest "
          f"{digest['stateDigest'][:12]}) == standalone simulate(engine=\"cuda\") "
          f"({sample_s:.1f} s); the what-if's header {a_headers.get('X-Simon-Incremental')} "
          f"[{gpu}]", flush=True)

    # ---- (c) the cut against the JAX package
    fused_scan.reset_launch_counts()
    GLOBAL.reset()
    cut, cut_s = serve_cut_digest(Session, ServeDaemon, ResourceTypes, reset_name_counter)
    check_notes("phase 24c", GLOBAL.notes)
    if cut != JAX_SERVE_ANSWER:
        raise AssertionError(f"phase 24c: digest {cut}; the JAX package's {JAX_SERVE_ANSWER}")
    print(f"phase 24c: {SERVE_JAX_NODES} nodes x {SERVE_JAX_PODS} pods, two ticks of "
          f"{len(SERVE_CUT_REQUESTS)} requests around four deltas over HTTP: the bodies and "
          f"state digests == the JAX package's (sha256 {cut[:16]}), "
          f"{fused_scan.LAUNCHES[fused_scan.BATCH_KERNEL_NAME]} batch launches, {cut_s:.1f} s "
          f"[{gpu}]", flush=True)
    return {"batch_launches": launches_a[fused_scan.BATCH_KERNEL_NAME]
            + launches_b[fused_scan.BATCH_KERNEL_NAME],
            "base_launches": launches_a[fused_scan.KERNEL_NAME]
            + launches_b[fused_scan.KERNEL_NAME],
            "other_launches": {k: launches_a[k] + launches_b[k] for k in launches_a
                               if k not in (fused_scan.BATCH_KERNEL_NAME,
                                            fused_scan.KERNEL_NAME)
                               and launches_a[k] + launches_b[k]},
            "qps": n_req / storm_s, "card_ms": card_ms}


def store_child(build_dir, n_nodes=STORE_NODES, n_pods=STORE_PODS) -> int:
    """Phase 25's subprocess (the store armed by SIMON_AOT_STORE): with its
    own, empty, kernel build directory, encode the default scenario at
    `n_nodes` x `n_pods`, launch B1 once (its library built by nvcc or
    loaded from the store) and hold it against the plain version. Prints
    one JSON line: the counters, the launches, the seconds from this
    function's start to the end of the launch, max_abs_err."""
    t0 = time.perf_counter()
    import numpy as np
    import torch

    from open_simulator_tpu_torch.incremental.store import current_store
    from open_simulator_tpu_torch.ops import fused_scan
    from open_simulator_tpu_torch.utils import nvcc
    from open_simulator_tpu_torch.utils.trace import COUNTERS

    nvcc.BUILD_DIR = Path(build_dir)
    nodes, pods = build_scenario(int(n_nodes), int(n_pods))
    plan, batch, names = encode(nodes, pods, "cuda")
    args = (plan, batch.class_of_pod, np.ones(len(names), bool), np.ones(plan.n, bool))
    fused_scan.reset_launch_counts()
    got = fused_scan.run_fused_scan(*args, pinned=batch.pinned_node)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = fused_scan.LAUNCHES[fused_scan.KERNEL_NAME]
    want = fused_scan.fused_scan_reference(*args, pinned=batch.pinned_node)
    print(json.dumps({
        "first_launch_s": first_s, "launches": launches, "max_abs_err": max_abs_err(got, want),
        "store": str(current_store().root) if current_store() else None,
        "library": nvcc.library_path(fused_scan.SOURCE).name,
        **{k: COUNTERS.get(k) for k in ("nvcc_builds_total", "nvcc_cache_hits_total",
                                        "aot_store_hit_total", "aot_store_miss_total",
                                        "aot_store_reject_total", "aot_store_save_total")}}),
        flush=True)
    return 0


def store_chain(root) -> dict:
    """Phase 25's three subprocesses, one after the other, sharing the
    store `root`/aot-store, each with its own empty build directory:
    cold (nvcc builds, the store fills), warm (the store serves), corrupt
    (a byte of the stored library flipped first). Returns each one's
    JSON line with its stderr and its wall seconds."""
    store = Path(root) / "aot-store"
    runs = {}
    for tag in ("cold", "warm", "corrupt"):
        if tag == "corrupt":
            payload = store / runs["cold"]["library"]
            data = bytearray(payload.read_bytes())
            data[len(data) // 2] ^= 0xFF
            payload.write_bytes(bytes(data))
        t0 = time.perf_counter()
        proc = start_child(root, f"store-{tag}", "store_child", Path(root) / f"build-{tag}",
                           env={"SIMON_AOT_STORE": str(store)})
        doc, err = wait_child(proc, timeout=900)
        runs[tag] = dict(doc, wall=time.perf_counter() - t0, stderr=err)
    return runs


def phase25(gpu, root, chain=None) -> dict:
    """The kernel-library store and C3 on the card, in three subprocesses
    that share one store and have each an empty build directory (the
    store is the library directory): the first builds fused_scan.cu and
    fills the store; the second loads it (no nvcc build) and its B1
    launch == the plain version; after a byte of the stored library is
    flipped, the third refuses the entry (one reject), builds once,
    commits it again, and its launch == plain too. The manifest's key is
    the one this process keys the library by (the source, the nvcc
    version, FLAGS, the arch). `chain` is store_chain already running
    beside the earlier phases (main), else it runs now."""
    import hashlib

    from open_simulator_tpu_torch.ops import fused_scan
    from open_simulator_tpu_torch.utils import nvcc

    runs = (chain or Background(store_chain, root)).result()
    store = Path(root) / "aot-store"
    want = {  # counters each run must show
        "cold": {"nvcc_builds_total": 1, "aot_store_miss_total": 1, "aot_store_save_total": 1,
                 "aot_store_hit_total": 0, "aot_store_reject_total": 0},
        "warm": {"nvcc_builds_total": 0, "aot_store_hit_total": 1, "aot_store_save_total": 0,
                 "aot_store_reject_total": 0},
        "corrupt": {"nvcc_builds_total": 1, "aot_store_reject_total": 1,
                    "aot_store_save_total": 1, "aot_store_hit_total": 0},
    }
    for tag, doc in runs.items():
        bad = {k: doc[k] for k, v in want[tag].items() if doc[k] != v}
        if bad or doc["launches"] != 1 or doc["max_abs_err"] or doc["store"] != str(store):
            shown = {k: v for k, v in doc.items() if k != "stderr"}
            raise AssertionError(f"phase 25 ({tag}): {shown}; wanted {want[tag]}, one launch "
                                 f"== plain: {doc['stderr'][-2000:]}")
    if "payload sha256 mismatch" not in runs["corrupt"]["stderr"]:
        raise AssertionError(f"phase 25: the corrupt entry was not refused loudly: "
                             f"{runs['corrupt']['stderr'][-2000:]}")
    lib = nvcc.library_path(fused_scan.SOURCE).name
    manifest = json.loads((store / lib).with_suffix(".json").read_text())
    payload_sha = hashlib.sha256((store / lib).read_bytes()).hexdigest()
    if (manifest["digest"] != nvcc.library_key(fused_scan.SOURCE)
            or manifest["payload_sha256"] != payload_sha
            or {r["library"] for r in runs.values()} != {lib}):
        raise AssertionError(f"phase 25: the store's entry {manifest['digest'][:16]} "
                             f"(payload verifies: {manifest['payload_sha256'] == payload_sha}) "
                             f"or the children's libraries "
                             f"{[r['library'] for r in runs.values()]} != this process's "
                             f"{nvcc.library_key(fused_scan.SOURCE)[:16]}, {lib}")
    print(f"phase 25 (the kernel-library store, B1 at {STORE_NODES} nodes x {STORE_PODS} pods "
          f"in each of three processes, each with an empty build directory, run beside the "
          f"earlier phases): time to the first launch cold (nvcc) "
          f"{runs['cold']['first_launch_s']:.2f} s ({runs['cold']['wall']:.1f} s the process), "
          f"from the store {runs['warm']['first_launch_s']:.2f} s "
          f"({runs['warm']['wall']:.1f} s), after a corrupted payload "
          f"{runs['corrupt']['first_launch_s']:.2f} s ({runs['corrupt']['wall']:.1f} s: 1 "
          f"reject, 1 build, committed again); every launch == B1's plain version, "
          f"max_abs_err 0; the library {lib} keyed by the source and the toolchain (nvcc "
          f"{manifest['nvcc_version'].strip().splitlines()[-1]}, FLAGS, {nvcc.ARCH}); driver "
          f"{manifest['driver']}, torch {manifest['torch']} recorded [{gpu}]", flush=True)
    return {"launches": sum(r["launches"] for r in runs.values()), "runs": runs}


def serve_child(snapshot, store, n_nodes=SERVE_NODES, n_pods=SERVE_PODS) -> int:
    """Phase 26's first daemon, in a subprocess that phase 26 kills with
    SIGKILL: phase 24's cluster built here (no YAML), the kernel-library
    store at `store`, a Session and a ServeDaemon journaling to
    `snapshot` with a checkpoint every FAILOVER_INTERVAL deltas, as
    `simon serve` builds them; prints the readiness line and serves."""
    from open_simulator_tpu_torch.incremental.store import configure_store
    from open_simulator_tpu_torch.models.decode import ResourceTypes
    from open_simulator_tpu_torch.obs.telemetry import arm_flight_recorder
    from open_simulator_tpu_torch.serve.server import ServeDaemon
    from open_simulator_tpu_torch.serve.session import Session

    nodes, pods = build_serve_cluster(int(n_nodes), int(n_pods))
    cluster = ResourceTypes()
    cluster.nodes, cluster.pods = nodes, pods
    configure_store(store)
    session = Session(cluster)
    daemon = ServeDaemon(session, port=0, snapshot_path=snapshot,
                         checkpoint_interval=FAILOVER_INTERVAL, keep_checkpoints=2)
    arm_flight_recorder()
    session.warm()
    daemon.start()
    print(f"simon serve listening on http://{daemon.host}:{daemon.port} "
          f"(cluster {session.fingerprint})", flush=True)
    return daemon.run_until_signaled()


def write_serve_config(root, n_nodes=SERVE_NODES, n_pods=SERVE_PODS) -> str:
    """Phase 24's cluster as a simon config (customConfig) under `root`."""
    import yaml

    dumper = getattr(yaml, "CSafeDumper", yaml.SafeDumper)
    root = Path(root)
    nodes, pods = build_serve_cluster(n_nodes, n_pods)
    (root / "cluster").mkdir(parents=True)
    with open(root / "cluster" / "objects.yaml", "w") as f:
        yaml.dump_all(nodes + pods, f, Dumper=dumper)
    cfg = root / "simon-config.yaml"
    cfg.write_text(yaml.safe_dump({
        "apiVersion": "simon/v1alpha1", "kind": "Config", "metadata": {"name": "failover"},
        "spec": {"cluster": {"customConfig": str(root / "cluster")}}}))
    return str(cfg)


def _ready_line(proc, label):
    line = proc.stdout.readline()
    if "listening on http://" not in line:
        raise AssertionError(f"{label}: no readiness line ({line!r})")
    return line.split("listening on ", 1)[1].split()[0].rstrip("/")


def metric(text, name) -> float:
    """One sample of a Prometheus exposition, by its full name."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    raise AssertionError(f"{name} not in the exposition")


def phase26(gpu, root) -> dict:
    """Serve failover and `simon top` on phase 24's cluster: a daemon (a
    subprocess, the store armed) commits SERVE_PODS pods on SERVE_NODES
    nodes, takes FAILOVER_DELTAS deltas with a checkpoint every
    FAILOVER_INTERVAL, answers a what-if, and is killed with SIGKILL;
    `simon serve -f cfg --snapshot S --replay-snapshot --aot-store D`
    with an empty kernel build directory then restores the checkpoint and
    replays the journal's suffix. Its state digest and its first answer
    == the dead daemon's, it built nothing (the store), one checkpoint
    restore, replayed deltas == the journal's suffix, and `simon top
    --once` and `--format json` against it exit 0."""
    import os
    import signal

    from open_simulator_tpu_torch.runtime.checkpoint import (
        checkpoint_dir,
        list_checkpoints,
        load_checkpoint,
    )

    root = Path(root)
    snapshot, store = str(root / "failover.jsonl"), str(root / "aot-store")
    prep = prepared(root, "failover-config")
    cfg, write_s = prep["cfg"], prep["seconds"]
    nodes, pods = build_serve_cluster()
    recs = serve_deltas(pods, [SERVE_EVICT_FROM + 50 * k for k in range(FAILOVER_DELTAS // 2)],
                        FAILOVER_DELTAS - FAILOVER_DELTAS // 2, tag="failover")
    envelope = serve_envelope("failover-whatif")
    code = "import sys, chip_smoke; sys.exit(chip_smoke.serve_child(*sys.argv[1:]))"
    t0 = time.perf_counter()
    dead = subprocess.Popen([sys.executable, "-c", code, snapshot, store], cwd=str(ROOT),
                            stdout=subprocess.PIPE, stderr=open(root / "dead.err", "w"),
                            text=True)
    try:
        base = _ready_line(dead, "phase 26 (the first daemon)")
        start_s = time.perf_counter() - t0
        d_times = []
        for i, rec in enumerate(recs):
            t1 = time.perf_counter()
            status, _h, body = http_json(base, "/v1/cluster-delta", {"deltas": [rec]})
            d_times.append((time.perf_counter() - t1) * 1e3)
            if status != 200:
                raise AssertionError(f"phase 26: delta {i}: {status} {body[:300]!r}")
            if i + 1 == FAILOVER_INTERVAL:
                # the checkpoint of the first FAILOVER_INTERVAL deltas is
                # written off the request path: wait for it
                for _ in range(600):
                    _s, _h, m = http_json(base, "/metrics")
                    if metric(m.decode(), "simon_ckpt_writes_total") >= 1:
                        break
                    time.sleep(0.1)
        _s, _h, digest = http_json(base, "/v1/state-digest")
        a_status, _h, answer = http_json(base, "/v1/simulate", envelope)
        _s, _h, m_dead = http_json(base, "/metrics")
    finally:
        dead.send_signal(signal.SIGKILL)
        dead.wait(timeout=60)
        dead.stdout.close()
    m_dead = m_dead.decode()
    if a_status != 200 or metric(m_dead, "simon_ckpt_writes_total") < 1:
        raise AssertionError(f"phase 26: the dead daemon's what-if {a_status}, checkpoints "
                             f"{metric(m_dead, 'simon_ckpt_writes_total')}")
    gen_seq, gen_path = list_checkpoints(checkpoint_dir(snapshot))[0]
    header, _payload = load_checkpoint(gen_path)
    suffix = 0
    for line in Path(snapshot).read_text().splitlines()[1:]:
        rec = json.loads(line) if line.strip() else {}
        if rec.get("event") == "delta" and rec.get("seq", 0) > header["deltaSeq"]:
            suffix += 1
    new_code = ("import sys; from pathlib import Path; "
                "from open_simulator_tpu_torch.utils import nvcc; "
                "nvcc.BUILD_DIR = Path(sys.argv[1]); "
                "from open_simulator_tpu_torch.cli import main; sys.exit(main(sys.argv[2:]))")
    t0 = time.perf_counter()
    new = subprocess.Popen(
        [sys.executable, "-c", new_code, str(root / "build-failover"), "serve", "-f", cfg,
         "--port", "0", "--snapshot", snapshot, "--replay-snapshot", "--aot-store", store,
         "--checkpoint-interval", str(FAILOVER_INTERVAL)],
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=open(root / "new.err", "w"), text=True,
        env=dict(os.environ))
    try:
        base = _ready_line(new, "phase 26 (the replacement)")
        ready_s = time.perf_counter() - t0
        _s, _h, digest2 = http_json(base, "/v1/state-digest")
        t1 = time.perf_counter()
        a2_status, _h, answer2 = http_json(base, "/v1/simulate", envelope)
        first_ms = (time.perf_counter() - t1) * 1e3
        _s, _h, m_new = http_json(base, "/metrics")
        top = [run_cli(["top", "--url", base, *flags])
               for flags in (["--once"], ["--format", "json"])]
    finally:
        new.send_signal(signal.SIGTERM)
        drain_rc = new.wait(timeout=120)
        new.stdout.close()
    m_new = m_new.decode()
    err_new = (root / "new.err").read_text()
    got = {k: metric(m_new, f"simon_{k}") for k in (
        "nvcc_builds_total", "aot_store_hit_total", "aot_store_reject_total",
        "ckpt_restore_total", "fleet_replay_deltas_total", "ckpt_restore_seconds")}
    launches = {site: metric(m_new, f'simon_launches_site_total{{site="{site}"}}')
                for site in ("scan", "scenario_scan")}
    dead_launches = {site: metric(m_dead, f'simon_launches_site_total{{site="{site}"}}')
                     for site in ("scan", "scenario_scan")}
    if json.loads(digest2) != json.loads(digest) or a2_status != 200 or answer2 != answer:
        raise AssertionError(f"phase 26: the replacement's state {digest2[:200]!r} / answer "
                             f"({a2_status}, equal {answer2 == answer}) != the dead "
                             f"daemon's {digest[:200]!r}: {err_new[-2000:]}")
    if (got["nvcc_builds_total"] or got["aot_store_hit_total"] < 1
            or got["aot_store_reject_total"] or got["ckpt_restore_total"] != 1
            or got["fleet_replay_deltas_total"] != suffix or drain_rc != 0
            or any(rc != 0 for rc, _o, _e in top) or not json.loads(top[1][1])["snapshot"]):
        raise AssertionError(f"phase 26: {got}, journal suffix {suffix}, drain exit {drain_rc}, "
                             f"top exits {[t[0] for t in top]}: {err_new[-2000:]}")
    if not (launches["scan"] >= 1 and launches["scenario_scan"] >= 1):
        raise AssertionError(f"phase 26: the replacement's launches {launches}")
    print(f"phase 26 (serve failover, {SERVE_NODES} nodes x {SERVE_PODS} committed pods): the "
          f"config written in {write_s:.1f} s (beside the earlier phases); the first daemon ready in {start_s:.1f} s "
          f"(process start, session, committed scan, warm-up), {len(recs)} deltas at p50 "
          f"{statistics.median(d_times):.1f} ms, a checkpoint at deltaSeq "
          f"{header['deltaSeq']}, then SIGKILL; the replacement (`serve --replay-snapshot "
          f"--aot-store`, an empty build directory) ready in {ready_s:.1f} s: "
          f"{int(got['aot_store_hit_total'])} store hit, 0 nvcc builds, 1 checkpoint restore in "
          f"{got['ckpt_restore_seconds']:.3f} s, {int(got['fleet_replay_deltas_total'])} "
          f"journal deltas replayed (the suffix past {header['deltaSeq']}); its state digest "
          f"and its first answer ({first_ms:.1f} ms) == the dead daemon's; launches: the dead "
          f"daemon's scan {int(dead_launches['scan'])}, scenario_scan "
          f"{int(dead_launches['scenario_scan'])}; the replacement's scan "
          f"{int(launches['scan'])}, scenario_scan {int(launches['scenario_scan'])}; `simon "
          f"top --once` and `--format json` exit 0 [{gpu}]", flush=True)
    print("phase 26: simon top --once:\n" + top[0][1].rstrip(), flush=True)
    return {"base_launches": int(launches["scan"] + dead_launches["scan"]),
            "batch_launches": int(launches["scenario_scan"] + dead_launches["scenario_scan"]),
            "restore_s": got["ckpt_restore_seconds"], "first_ms": first_ms}


def twin_cluster(n_nodes, n_bound, n_decisions):
    """Phase 27's inputs: the default scenario's nodes, `n_bound` pods of
    250m / 512 MiB bound round-robin to them, and the default pods'
    first `n_decisions` as the feed's app."""
    nodes, feed = build_scenario(n_nodes, n_decisions)
    bound = [{"kind": "Pod", "metadata": {"name": f"twin-b-{i:06d}", "namespace": "twin"},
              "spec": {"nodeName": nodes[i % n_nodes]["metadata"]["name"], "containers": [{
                  "name": "c", "image": "img-bound", "resources": {"requests": {
                      "cpu": "250m", "memory": "512Mi"}}}]}}
             for i in range(n_bound)]
    for pod in feed:
        pod["kind"] = "Pod"
    return nodes, bound, feed


def twin_queries(forecast_engine):
    """(path, body) of phase 27's queries, in order."""
    return (("/v1/whatif", serve_envelope("twin-whatif", TWIN_WHATIF_REPLICAS)),
            ("/v1/drain", {"selector": {"zone": TWIN_DRAIN_ZONE}}),
            ("/v1/nplusk", {"k": 1, "trials": TWIN_NPLUSK_TRIALS, "seed": 1}),
            ("/v1/forecast", {"horizonSeconds": TWIN_FORECAST_S, "arrivalRate": 1.0,
                              "cadenceSeconds": 60, "policy": "static:0",
                              "engine": forecast_engine}))


def twin_norm(body: dict) -> dict:
    """A twin answer with what names the engine or counts its compiler
    set aside: the forecast's `engine`, the mirror stats' warm-build
    count (`warmRecompiles` in the JAX package, `warmBuilds` here)."""
    body = {k: v for k, v in body.items() if k != "engine"}
    if "mirror" in body:
        body["mirror"] = {k: v for k, v in body["mirror"].items()
                          if k not in ("warmRecompiles", "warmBuilds")}
    return body


def twin_fed(base, timeout=900):
    """Wait until the twin at `base` has applied its whole feed; returns
    its /healthz document."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        _s, _h, body = http_json(base, "/healthz")
        h = json.loads(body)
        if h["mirror"]["feedExhausted"] and h["mirror"]["backlog"] == 0:
            return h
        time.sleep(0.02)
    raise AssertionError(f"the twin at {base} did not drain its feed in {timeout} s")


def twin_cut_digest(ClusterMirror, FeedSource, TwinDaemon, ResourceTypes, AppResource,
                    record_simulation, reset_name_counter, engine, forecast_engine,
                    **mirror_kw):
    """Phase 27's cut through the classes given (one package's) in this
    process: TWIN_JAX_NODES nodes with TWIN_JAX_BOUND bound pods, the
    feed of TWIN_JAX_DECISIONS decisions recorded and tailed by a TwinDaemon
    at TWIN_FEED_BATCH, then the four queries over HTTP and the state
    digest. Returns the sha256 of the feed's steps, the answers
    (twin_norm) and the digest, the seconds it took, and the answers
    (tools/jax_twin_answer.py runs it on the JAX package; the port's
    must print the same)."""
    import hashlib

    t0 = time.perf_counter()
    nodes, bound, feed = twin_cluster(TWIN_JAX_NODES, TWIN_JAX_BOUND, TWIN_JAX_DECISIONS)
    cluster = ResourceTypes()
    cluster.nodes, cluster.pods = nodes, bound
    app = ResourceTypes()
    app.pods = feed
    reset_name_counter()
    steps = record_simulation(cluster, [AppResource("feed", app)])
    mirror = ClusterMirror(cluster, FeedSource(steps, batch=TWIN_FEED_BATCH), engine=engine,
                           **mirror_kw)
    mirror.bootstrap()
    daemon = TwinDaemon(mirror, port=0, poll_interval_s=0.001)
    daemon.start()
    try:
        base = f"http://{daemon.host}:{daemon.port}"
        twin_fed(base)
        answers = []
        for path, body in twin_queries(forecast_engine):
            status, _h, raw = http_json(base, path, body)
            answers.append((status, json.loads(raw)))
        _s, _h, digest = http_json(base, "/v1/state-digest")
    finally:
        daemon.shutdown()
    if any(st != 200 for st, _b in answers):
        raise AssertionError(f"the twin cut ({ClusterMirror.__module__}): statuses "
                             f"{[a[0] for a in answers]}: {[a[1] for a in answers]}")
    h = hashlib.sha256()
    for st in steps:
        h.update(json.dumps(st.as_record(), sort_keys=True).encode())
    for _status, body in answers:
        h.update(json.dumps(twin_norm(body), sort_keys=True).encode())
    h.update(json.dumps(json.loads(digest), sort_keys=True).encode())
    return h.hexdigest(), time.perf_counter() - t0, answers


def phase27(gpu, root=None) -> dict:
    """The digital twin at full width on the card, in this process: the
    default scenario's TWIN_NODES nodes with TWIN_BOUND bound pods, a
    feed of the bound pods' placements and TWIN_DECISIONS decisions
    recorded on the serial oracle, tailed at TWIN_FEED_BATCH by a
    TwinDaemon with the counters at 0: agreement 1.0, one B1 launch a
    decision; then over HTTP a what-if (one B1 launch, held against B1's
    plain version on its inputs), a drain of a zone by selector (one B1
    launch), N+K at k=1 over TWIN_NPLUSK_TRIALS trials (one B1 launch a
    trial) and a forecast (one pins-first launch a window that places
    pods, == the report's dispatches), no nvcc build; at the cut, the
    what-if and drain answers == the same twin's on the oracle engine,
    and the whole cut == the JAX package's (JAX_TWIN_ANSWER)."""
    import numpy as np
    import torch

    from open_simulator_tpu_torch.models.decode import ResourceTypes
    from open_simulator_tpu_torch.models.workloads import reset_name_counter
    from open_simulator_tpu_torch.obs.histo import HISTOS
    from open_simulator_tpu_torch.ops import fused_scan
    from open_simulator_tpu_torch.scheduler.core import AppResource
    from open_simulator_tpu_torch.serve.server import parse_request_body
    from open_simulator_tpu_torch.shadow.log import read_decision_log
    from open_simulator_tpu_torch.shadow.record import record_simulation
    from open_simulator_tpu_torch.twin import queries
    from open_simulator_tpu_torch.twin.mirror import ClusterMirror, FeedSource
    from open_simulator_tpu_torch.twin.server import TwinDaemon
    from open_simulator_tpu_torch.utils.trace import COUNTERS, GLOBAL

    nodes, bound, _feed = twin_cluster(TWIN_NODES, TWIN_BOUND, 0)
    cluster = ResourceTypes()
    cluster.nodes, cluster.pods = nodes, bound
    rec = prepared(root, "twin-feed")
    steps, _meta = read_decision_log(rec["log"])
    n_dec = sum(1 for st in steps if st.kind == "decision")
    print(f"phase 27 (the twin, {TWIN_NODES} nodes x {TWIN_BOUND} bound pods): the feed "
          f"recorded on the serial oracle: {len(steps) - n_dec} bound-pod steps and {n_dec} "
          f"decisions (cut from 200 for the script's time) in {rec['seconds']:.1f} s (host, a "
          f"process beside the earlier phases) [{gpu}]", flush=True)

    mirror = ClusterMirror(cluster, FeedSource(steps, batch=TWIN_FEED_BATCH))
    mirror.bootstrap()
    daemon = TwinDaemon(mirror, port=0, poll_interval_s=0.001)
    builds0 = COUNTERS.get("nvcc_builds_total")
    GLOBAL.reset()
    fused_scan.reset_launch_counts()
    t0 = time.perf_counter()
    daemon.start()
    base = f"http://{daemon.host}:{daemon.port}"
    try:
        health = twin_fed(base)
        tail_s = time.perf_counter() - t0
        tail_launches = dict(fused_scan.LAUNCHES)
        phases = {ph["name"]: ph["seconds"] for ph in GLOBAL.as_dict()["phases"]}
        check_notes("phase 27 (tail)", GLOBAL.notes)
        stats = health["mirror"]
        if (stats["agreementRate"] != 1.0 or stats["decisions"] != n_dec
                or tail_launches[fused_scan.KERNEL_NAME] != n_dec
                or sum(tail_launches.values()) != n_dec):
            raise AssertionError(f"phase 27: the tail: {stats}, launches {tail_launches}")
        per_dec = (phases.get("shadow/probe", 0) + phases.get("shadow/commit", 0)) / n_dec
        print(f"phase 27: the feed tailed at --feed-batch {TWIN_FEED_BATCH} in {tail_s:.1f} s "
              f"({len(steps)} steps, {stats['polls']} polls): agreement "
              f"{stats['agreementRate']} over {n_dec} decisions, one "
              f"{fused_scan.KERNEL_NAME} launch a decision (cluster "
              f"{fused_scan.CLUSTERS[fused_scan.KERNEL_NAME]}), "
              f"{per_dec * 1e3:.2f} ms a decision (shadow/probe + shadow/commit); host clock: "
              + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in phases.items()) + f" [{gpu}]",
              flush=True)

        real_scan = fused_scan.run_fused_scan
        calls = []

        def record_scan(plan, cls, active, valid, pinned=None, site="scan"):
            outs = real_scan(plan, cls, active, valid, pinned, site=site)
            calls.append((plan, cls, active, valid, pinned, outs))
            return outs

        results = {}
        for (path, body), kernel in zip(twin_queries("cuda"),
                                        (fused_scan.KERNEL_NAME,) * 3
                                        + (fused_scan.PINS_FIRST_KERNEL_NAME,)):
            site = "timeline_sweep" if path == "/v1/forecast" else "scan"
            hist = HISTOS.get(f"launch/{site}")
            sum0 = hist.sum if hist is not None else 0.0
            fused_scan.reset_launch_counts()
            GLOBAL.reset()
            if path == "/v1/whatif":
                fused_scan.run_fused_scan = record_scan
            t1 = time.perf_counter()
            try:
                status, _h, raw = http_json(base, path, body)
            finally:
                fused_scan.run_fused_scan = real_scan
            secs = time.perf_counter() - t1
            launched = dict(fused_scan.LAUNCHES)
            hist = HISTOS.get(f"launch/{site}")
            card = ((hist.sum if hist is not None else 0.0) - sum0) * 1e3
            check_notes(f"phase 27 ({path})", GLOBAL.notes)
            doc = json.loads(raw)
            if status != 200:
                raise AssertionError(f"phase 27: {path}: {status} {doc}")
            want = {"/v1/whatif": 1, "/v1/drain": 1, "/v1/nplusk": TWIN_NPLUSK_TRIALS,
                    "/v1/forecast": doc.get("dispatches")}[path]
            if launched[kernel] != want or sum(launched.values()) != want or not want:
                raise AssertionError(f"phase 27: {path}: launches {launched}, wanted {want} of "
                                     f"{kernel}")
            results[path] = {"doc": doc, "s": secs, "card_ms": card, "launches": want}
        if len(calls) != 1:
            raise AssertionError(f"phase 27: the what-if ran {len(calls)} scans")
        plan, cls, active, valid, pinned, outs = calls[0]
        t1 = time.perf_counter()
        want = fused_scan.fused_scan_reference(plan, cls, active, valid, pinned)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t1
        whatif_err = max_abs_err(outs, want)
        if whatif_err:
            raise AssertionError(f"phase 27: the what-if's launch != B1's plain version "
                                 f"({whatif_err})")
        whatif_pods = int(np.asarray(active).sum())
        del calls, plan, outs, want
        _s, _h, m = http_json(base, "/metrics")
    finally:
        assert daemon.shutdown() == 0
    if COUNTERS.get("nvcc_builds_total") != builds0:
        raise AssertionError("phase 27: nvcc builds during the twin's tail and queries")
    w, d, nk, fc = (results[p]["doc"] for p in ("/v1/whatif", "/v1/drain", "/v1/nplusk",
                                                "/v1/forecast"))
    print(f"phase 27: over HTTP: a what-if of {TWIN_WHATIF_REPLICAS} replicas "
          f"({w['placed']} placed) {results['/v1/whatif']['s'] * 1e3:.1f} ms, card "
          f"{results['/v1/whatif']['card_ms']:.3f} ms (one launch over {whatif_pods} pods == "
          f"B1's plain version, max_abs_err {whatif_err}, {plain_s:.1f} s); a drain of zone "
          f"{TWIN_DRAIN_ZONE} ({len(d['drainedNodes'])} nodes, {d['displaced']} displaced, safe "
          f"{d['safe']}) {results['/v1/drain']['s'] * 1e3:.1f} ms, card "
          f"{results['/v1/drain']['card_ms']:.3f} ms; N+K k=1 over {nk['scenarios']} trials "
          f"(survivable {nk['survivable']}) {results['/v1/nplusk']['s'] * 1e3:.1f} ms, "
          f"{TWIN_NPLUSK_TRIALS} launches, card {results['/v1/nplusk']['card_ms']:.3f} ms; a "
          f"forecast of {TWIN_FORECAST_S} s ({fc['arrivals']} arrivals, {fc['windows']} "
          f"windows, {fc['dispatches']} pins-first launches) "
          f"{results['/v1/forecast']['s'] * 1e3:.1f} ms, card "
          f"{results['/v1/forecast']['card_ms']:.3f} ms; 0 nvcc builds; /metrics "
          f"simon_twin_agreement_rate {metric(m.decode(), 'simon_twin_agreement_rate')} "
          f"[{gpu}]", flush=True)

    # ---- the cut: the oracle engine, and the JAX package's digest
    fused_scan.reset_launch_counts()
    GLOBAL.reset()
    cut, cut_s, answers = twin_cut_digest(ClusterMirror, FeedSource, TwinDaemon,
                                          ResourceTypes, AppResource, record_simulation,
                                          reset_name_counter, "cuda", "cuda")
    check_notes("phase 27 (cut)", GLOBAL.notes)
    cut_launches = dict(fused_scan.LAUNCHES)
    c_nodes, c_bound, c_feed = twin_cluster(TWIN_JAX_NODES, TWIN_JAX_BOUND, TWIN_JAX_DECISIONS)
    c_cluster = ResourceTypes()
    c_cluster.nodes, c_cluster.pods = c_nodes, c_bound
    c_app = ResourceTypes()
    c_app.pods = c_feed
    reset_name_counter()
    c_steps = record_simulation(c_cluster, [AppResource("feed", c_app)])
    oracle = ClusterMirror(c_cluster, FeedSource(c_steps, batch=TWIN_FEED_BATCH),
                           engine="oracle")
    oracle.bootstrap()
    while not oracle.source.exhausted:
        oracle.poll_once()
    oracle.drain_backlog()
    req_apps = parse_request_body(json.dumps(twin_queries("cuda")[0][1]).encode(),
                                  "application/json")[0].apps
    o_whatif = queries.whatif(oracle, req_apps)
    o_drain = queries.drain(oracle, selector={"zone": TWIN_DRAIN_ZONE})
    for got, want_doc in ((answers[0][1], o_whatif), (answers[1][1], o_drain)):
        a = {k: v for k, v in got.items() if k != "mirror"}
        b = {k: v for k, v in json.loads(json.dumps(want_doc)).items() if k != "mirror"}
        if a != b:
            raise AssertionError(f"phase 27: at the cut the {got['kind']} answer != the "
                                 f"oracle engine's")
    if cut != JAX_TWIN_ANSWER:
        raise AssertionError(f"phase 27: the cut's digest {cut}; the JAX package's "
                             f"{JAX_TWIN_ANSWER}")
    print(f"phase 27: {TWIN_JAX_NODES} nodes x {TWIN_JAX_BOUND} bound pods, the feed and the "
          f"four queries through the daemon: == the JAX package's (sha256 {cut[:16]}), the "
          f"what-if and drain answers == the oracle engine's; launches {cut_launches}, "
          f"{cut_s:.1f} s [{gpu}]", flush=True)
    return {"base_launches": n_dec + 2 + TWIN_NPLUSK_TRIALS,
            "pins_launches": fc["dispatches"], "whatif_ms": results["/v1/whatif"]["s"] * 1e3}


def balanced_tenants(ring, slots, count, prefix="p28-tenant") -> list:
    """One tenant a client, their ring owners dealt round-robin over the
    slots (bench.py balanced_tenants)."""
    out, j = [], 0
    for i in range(count):
        while True:
            t = f"{prefix}-{j}"
            j += 1
            if ring.route_order(t)[0] == slots[i % len(slots)]:
                out.append(t)
                break
    return out


class FleetStorm:
    """One thread a tenant, each POSTing the envelope `per_client` times
    through the router with its own request ids; `done` counts the
    replies back. `join()` returns the replies [(tenant, rid, status,
    headers, body, seconds)] and the wall time."""

    def __init__(self, base, tenants, tag, per_client=FLEET_PER_CLIENT):
        import threading

        self.replies, self.errors, self.done = [], [], 0
        self.per_client = per_client
        self._lock = threading.Lock()
        self.t0 = time.perf_counter()
        self._threads = [threading.Thread(target=self._client, args=(base, t, f"{tag}-{k}"))
                         for k, t in enumerate(tenants)]
        for t in self._threads:
            t.start()

    def _client(self, base, tenant, tag):
        envelope = serve_envelope("fq")
        for j in range(self.per_client):
            rid = f"{tag}-{j}"
            t0 = time.perf_counter()
            try:
                status, headers, body = http_json(base, "/v1/simulate", envelope, headers={
                    "X-Simon-Tenant": tenant, "X-Simon-Request-Id": rid})
            except Exception as e:  # a lost request: reported by join()
                with self._lock:
                    self.errors.append((rid, repr(e)))
                continue
            with self._lock:
                self.replies.append((tenant, rid, status, headers, body,
                                     time.perf_counter() - t0))
                self.done += 1

    def join(self, label):
        for t in self._threads:
            t.join()
        wall = time.perf_counter() - self.t0
        want = len(self._threads) * self.per_client
        bad = [(rid, status, headers.get("X-Simon-Request-Id"), body[:200])
               for _t, rid, status, headers, body, _s in self.replies
               if headers.get("X-Simon-Request-Id") != rid
               or not (status == 200 or (status in (429, 503) and headers.get("Retry-After")))]
        if self.errors or len(self.replies) != want or bad:
            raise AssertionError(f"{label}: {len(self.replies)} of {want} replies, lost "
                                 f"{self.errors[:4]}, wrong {bad[:4]}")
        return self.replies, wall


def replica_counts(url) -> dict:
    """A replica's launches by site, ticks, nvcc builds, store hits and
    the counters of a degraded path, from its /metrics."""
    text = http_json(url, "/metrics")[2].decode()
    out = {"b1": metric(text, 'simon_launches_site_total{site="scan"}'),
           "b6": metric(text, 'simon_launches_site_total{site="scenario_scan"}')}
    for name in ("serve_batches_total", "nvcc_builds_total", "aot_store_hit_total",
                 "serve_batch_errors_total", "serve_admission_serial_total",
                 "incremental_fallbacks_total", "guard_oom_predicted_total",
                 "guard_oom_reactive_total"):
        out[name] = metric(text, f"simon_{name}")
    return out


def check_replica(label, counts) -> None:
    """A tick is one B6 launch (and the warm-up one more); no tick
    failed, went serial or degraded."""
    degraded = {k: v for k, v in counts.items() if v and k in (
        "serve_batch_errors_total", "serve_admission_serial_total",
        "incremental_fallbacks_total", "guard_oom_predicted_total", "guard_oom_reactive_total")}
    if counts["b6"] != counts["serve_batches_total"] + 1 or degraded:
        raise AssertionError(f"{label}: B6 launches {counts['b6']} for "
                             f"{counts['serve_batches_total']} ticks and the warm-up; {degraded}")


class FleetProcess:
    """`simon fleet -f cfg --replicas n` started now in a fresh fleet
    directory under `root`; a thread reads its readiness line and the
    time it came."""

    def __init__(self, cfg, root, n):
        import threading

        self.n, self.dir, self.err = n, Path(root) / f"fleet-{n}", Path(root) / f"fleet-{n}.err"
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "open_simulator_tpu_torch.cli", "fleet", "-f", cfg,
             "--replicas", str(n), "--port", "0", "--fleet-dir", str(self.dir),
             "--probe-interval", str(FLEET_PROBE_S), "--drain-timeout", "60"],
            cwd=str(ROOT), stdout=subprocess.PIPE, stderr=open(self.err, "w"), text=True)
        _CHILDREN.append(self.proc)
        self.line, self.ready_s, self.rc = "", None, None
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        self.line = self.proc.stdout.readline()
        self.ready_s = time.perf_counter() - self.t0

    def ready(self):
        """The router's base URL, once the fleet printed its readiness line."""
        self._reader.join(timeout=900)
        if "listening on http://" not in self.line:
            raise AssertionError(f"phase 28 (the fleet of {self.n}): no readiness line "
                                 f"({self.line!r}): {self.err.read_text()[-2000:]}")
        return self.line.split("listening on ", 1)[1].split()[0].rstrip("/")

    def drain(self) -> int:
        """SIGTERM, then the fleet's exit code (once; later calls return it)."""
        import signal

        if self.rc is None:
            self.proc.send_signal(signal.SIGTERM)
            self.rc = self.proc.wait(timeout=180)
            self.proc.stdout.close()
        return self.rc


def fleet_health(base, slot) -> dict:
    doc = json.loads(http_json(base, "/healthz")[2])
    return next(r for r in doc["replicas"] if r["id"] == slot)


def phase28(gpu, root) -> dict:
    """The serve fleet on the card: `simon fleet` (a subprocess, its
    replicas port `simon serve` subprocesses on the card) in front of
    phase 24's cluster, measured first with 1 replica, then with 2, each
    in a fresh fleet directory whose kernel-library store r0 fills (the
    others load it); both fleets start together, the second idles while
    the first is measured. A warm storm (FLEET_WARM_PER_CLIENT POSTs a
    client), then a measured one (qps, p50/p95).
    On 2 replicas: a delta journaled for a tenant of r0, r0 killed with
    SIGKILL in the middle of a storm; the rerouted first 200 (== the
    survivor's answer to the same request), the probe loop's respawn and
    the replacement's first direct answer timed. Gates: every reply 200
    or 429/503 with Retry-After and its own request id, none lost; r1
    and the replacement 0 nvcc builds; the replacement's state digest ==
    the dead replica's, deltaSeq 1; the audit log validates; `simon top
    --fleet --once` and `--format json` exit 0; each replica's B6
    launches == its ticks + the warm-up, no degraded tick; SIGTERM
    drains with exit 0."""
    root = Path(root)
    cfg = root / "failover" / "simon-config.yaml"  # phase 26's, when it ran
    cfg = str(cfg) if cfg.exists() else prepared(root, "failover-config")["cfg"]
    results, counts = {}, {}
    fleets = {n: FleetProcess(cfg, root, n) for n in (1, 2)}
    try:
        for n in (1, 2):
            measure_fleet(fleets[n], results.setdefault(n, {}), counts)
    finally:
        for fleet in fleets.values():
            fleet.drain()
    for n, fleet in fleets.items():
        if fleet.rc != 0 or list(fleet.dir.glob("*.lock")):
            raise AssertionError(f"phase 28: the fleet of {n} drained with exit {fleet.rc}, "
                                 f"locks {list(fleet.dir.glob('*.lock'))}: "
                                 f"{fleet.err.read_text()[-2000:]}")
        results[n]["ready_s"] = fleet.ready_s
    for label, c in counts.items():
        check_replica(f"phase 28 ({label})", c)
    builds = {k: int(c["nvcc_builds_total"]) for k, c in counts.items()}
    if any(v for k, v in builds.items() if not k.endswith("/r0")) or \
            any(v != 1 for k, v in builds.items() if k.endswith("/r0")):
        raise AssertionError(f"phase 28: nvcc builds {builds} (r0 of each fresh fleet "
                             f"builds once; r1 and the replacement load the store)")
    one, two = results[1], results[2]
    print(f"phase 28 (the serve fleet, {SERVE_NODES} nodes x {SERVE_PODS} committed pods, "
          f"{FLEET_CLIENTS} clients x {FLEET_PER_CLIENT} POSTs of a 50-replica Deployment, "
          f"tenants balanced over the slots; both fleets started together): 1 replica ready "
          f"in {one['ready_s']:.1f} s (r0 builds into its store), {one['qps']:.2f} qps, p50 "
          f"{one['p50']:.1f} ms, p95 {one['p95']:.1f} ms; 2 replicas ready in "
          f"{two['ready_s']:.1f} s (r0 builds, then r1 loads), {two['qps']:.2f} qps, p50 {two['p50']:.1f} ms, p95 {two['p95']:.1f} ms, "
          f"answers by slot {two['by_slot']} [{gpu}]", flush=True)
    fo = two
    hits = int(counts["2/r0'"]["aot_store_hit_total"])
    print(f"phase 28: failover: a delta for r0's tenant (deltaSeq 1), r0 SIGKILLed after "
          f"{FLEET_KILL_AFTER} replies of a storm; failover_first_200_s "
          f"{fo['first_200_s']:.3f} (rerouted to r1, == r1's own answer); failover_seconds "
          f"{fo['failover_s']:.3f} (the probe loop's respawn, then the replacement's first "
          f"direct answer); the storm's {fo['storm_replies']} replies {fo['storm_statuses']}; "
          f"audit {fo['audit']['complete']} complete episode, totalSeconds "
          f"{fo['audit_total']:.3f}, phases {fo['audit_phases']}; the replacement's state "
          f"digest == the dead r0's, deltaSeq {fo['delta_seq']}, "
          f"{hits} store hit [{gpu}]", flush=True)
    print("phase 28: launches per replica (B1 at scan, B6 at scenario_scan, ticks, nvcc "
          "builds): " + "; ".join(
              f"{k} {int(c['b1'])}/{int(c['b6'])}/{int(c['serve_batches_total'])}/"
              f"{int(c['nvcc_builds_total'])}" for k, c in counts.items())
          + f"; each replica's B6 launches == its ticks + the warm-up [{gpu}]", flush=True)
    print("phase 28: simon top --fleet --once:\n" + two["top"].rstrip(), flush=True)
    return {"base_launches": int(sum(c["b1"] for c in counts.values())),
            "batch_launches": int(sum(c["b6"] for c in counts.values())),
            "qps": {1: one["qps"], 2: two["qps"]}, "first_200_s": fo["first_200_s"],
            "failover_s": fo["failover_s"]}


def measure_fleet(fleet, res, counts) -> None:
    """Phase 28 on one fleet: a warm storm, the measured storm, on 2
    replicas the failover, each replica's counts, `top --fleet`; then
    the drain."""
    import numpy as np

    from open_simulator_tpu_torch.fleet.hashing import HashRing

    n = fleet.n
    base = fleet.ready()
    slots = [f"r{i}" for i in range(n)]
    ring = HashRing(slots)
    tenants = balanced_tenants(ring, slots, FLEET_CLIENTS)
    FleetStorm(base, tenants, f"warm{n}", FLEET_WARM_PER_CLIENT).join(
        f"phase 28 ({n}, warm storm)")
    replies, wall = FleetStorm(base, tenants, f"storm{n}").join(f"phase 28 ({n}, storm)")
    lat = [r[5] * 1e3 for r in replies]
    res.update(qps=len(replies) / wall, p50=float(np.percentile(lat, 50)),
               p95=float(np.percentile(lat, 95)), wall=wall,
               by_slot={s: sum(r[3].get("X-Simon-Fleet-Replica") == s for r in replies)
                        for s in slots})
    if n == 2:
        res.update(fleet_failover(base, ring, tenants, fleet.dir, counts))
    for slot in slots:
        h = fleet_health(base, slot)
        counts[f"{n}/{slot}" + ("'" if h["restarts"] else "")] = replica_counts(h["url"])
    top = [run_cli(["top", "--fleet", "--url", base, *flags])
           for flags in (["--once"], ["--format", "json"])]
    if any(rc != 0 for rc, _o, _e in top) or \
            json.loads(top[1][1])["snapshot"]["daemon"] != "fleet":
        raise AssertionError(f"phase 28: top --fleet exits {[t[0] for t in top]}")
    res["top"] = top[0][1]
    fleet.drain()


def fleet_failover(base, ring, tenants, fleet_dir, counts) -> dict:
    """Phase 28's failover on the 2-replica fleet: one delta journaled
    for a tenant of r0 and its what-if answered, r0's counts read, then
    a storm, SIGKILL of r0 after FLEET_KILL_AFTER of its replies, the
    tenant's request rerouted, the respawn awaited, the replacement
    asked directly and through the router."""
    import os
    import signal

    from open_simulator_tpu_torch.fleet.audit import read_audit_log, validate_audit_log

    tenant = next(t for t in (f"p28-victim-{i}" for i in range(256))
                  if ring.route_order(t)[0] == "r0")
    hdr = {"X-Simon-Tenant": tenant}
    envelope = serve_envelope("fq")
    status, headers, body = http_json(base, "/v1/cluster-delta", {"deltas": [
        {"kind": "pod_arrive", "pod": serve_pod("p28-late")}]}, headers=hdr)
    if status != 200 or headers.get("X-Simon-Fleet-Replica") != "r0":
        raise AssertionError(f"phase 28: the delta {status} {body[:300]!r} "
                             f"from {headers.get('X-Simon-Fleet-Replica')}")
    if http_json(base, "/v1/simulate", envelope, headers=hdr)[0] != 200:
        raise AssertionError("phase 28: the tenant's what-if after its delta")
    dead = fleet_health(base, "r0")
    digest = json.loads(http_json(dead["url"], "/v1/state-digest")[2])
    counts["2/r0"] = replica_counts(dead["url"])
    storm = FleetStorm(base, tenants, "failover")
    t0 = time.perf_counter()
    while storm.done < FLEET_KILL_AFTER and time.perf_counter() - t0 < 300:
        time.sleep(0.01)
    t_kill = time.perf_counter()
    os.kill(dead["pid"], signal.SIGKILL)
    status, headers, rerouted = http_json(base, "/v1/simulate", envelope,
                                          headers={**hdr, "X-Simon-Request-Id": "p28-first"})
    first_200_s = time.perf_counter() - t_kill
    if status != 200 or headers.get("X-Simon-Request-Id") != "p28-first" or \
            headers.get("X-Simon-Fleet-Replica") != "r1":
        raise AssertionError(f"phase 28: the rerouted request {status} from "
                             f"{headers.get('X-Simon-Fleet-Replica')}: {rerouted[:300]!r}")
    while True:
        new = fleet_health(base, "r0")
        if new["restarts"] == 1 and new["status"] == "up":
            break
        if time.perf_counter() - t_kill > 300:
            raise AssertionError(f"phase 28: r0 not respawned: {new}")
        time.sleep(0.05)
    status, _h, _b = http_json(new["url"], "/v1/simulate", envelope)
    failover_s = time.perf_counter() - t_kill
    if status != 200:
        raise AssertionError(f"phase 28: the replacement's first answer {status}")
    replies, _wall = storm.join("phase 28 (the failover storm)")
    survivor = fleet_health(base, "r1")["url"]
    if http_json(survivor, "/v1/simulate", envelope)[2] != rerouted:
        raise AssertionError("phase 28: the rerouted body != r1's own answer to the request")
    digest2 = json.loads(http_json(new["url"], "/v1/state-digest")[2])
    if digest2 != digest or digest["deltaSeq"] != 1:
        raise AssertionError(f"phase 28: the replacement's digest {digest2} != the dead "
                             f"replica's {digest}")
    # the first 200 through the respawned slot closes the audit episode
    status, headers, _b = http_json(base, "/v1/simulate", envelope, headers=hdr)
    if status != 200 or headers.get("X-Simon-Fleet-Replica") != "r0":
        raise AssertionError(f"phase 28: the tenant's answer after the respawn {status} "
                             f"from {headers.get('X-Simon-Fleet-Replica')}")
    audit_path = str(fleet_dir / "failover-audit.jsonl")
    audit = validate_audit_log(audit_path)
    done = [e for e in read_audit_log(audit_path)[0] if e["phase"] == "failover_complete"]
    if audit["complete"] != 1 or audit["slots"] != ["r0"]:
        raise AssertionError(f"phase 28: the audit log {audit}")
    statuses = {}
    for r in replies:
        statuses[r[2]] = statuses.get(r[2], 0) + 1
    return {"first_200_s": first_200_s, "failover_s": failover_s, "audit": audit,
            "audit_total": done[0]["totalSeconds"], "audit_phases": done[0]["phases"],
            "delta_seq": digest2["deltaSeq"], "storm_replies": len(replies),
            "storm_statuses": statuses}


def mesh_cli(gpu) -> None:
    """Phase 29a: `apply` on the quickstart with --mesh auto, --mesh 1
    and SIMON_MESH=auto == its bytes without a mesh on this machine's
    cards (one card: every spec resolves to no mesh); --mesh past the
    cards exits 2 with the JAX package's message."""
    import os

    import torch

    from open_simulator_tpu_torch.parallel import mesh as mesh_mod

    base = ["apply", "-f", QUICKSTART, "--format", "json"]
    rc, want, err = run_cli(base)
    if rc != 0:
        raise AssertionError(f"phase 29a: apply exited {rc}: {err[-2000:]}")
    cards = torch.cuda.device_count()
    runs = [("--mesh auto", base + ["--mesh", "auto"], None),
            ("--mesh 1", base + ["--mesh", "1"], None),
            ("SIMON_MESH=auto", base, "auto")]
    for label, argv, env in runs:
        if env is not None:
            os.environ["SIMON_MESH"] = env
        try:
            mesh_mod.configure(None)
            got = run_cli(argv)
        finally:
            os.environ.pop("SIMON_MESH", None)
            mesh_mod.configure(None)
        if got[:2] != (0, want):
            raise AssertionError(f"phase 29a: apply with {label} exited {got[0]} or its "
                                 f"bytes differ from the run without a mesh")
    over = cards + 1
    rc, out, err = run_cli(base + ["--mesh", str(over)])
    mesh_mod.configure(None)
    msg = f"error: --mesh {over}: only {cards} local device(s) available\n"
    if (rc, out, err) != (2, "", msg):
        raise AssertionError(f"phase 29a: --mesh {over} exited {rc}, stderr {err[-500:]!r}")
    print(f"phase 29a: apply on {QUICKSTART} with --mesh auto, --mesh 1 and SIMON_MESH=auto "
          f"== no mesh ({cards} card(s), each resolves to no mesh); --mesh {over} exits 2: "
          f"{msg.strip()!r} [{gpu}]", flush=True)


def mesh_rows(label, gpu, mesh, call, kernel) -> int:
    """One sharded dispatch `call(mesh)` against `unsharded` (the same
    call without a mesh): equal answers, one `kernel` launch a shard,
    one scenario-axis decision. Returns the launches."""
    import numpy as np
    import torch

    from open_simulator_tpu_torch.ops import fused_scan
    from open_simulator_tpu_torch.utils.trace import COUNTERS

    decided = COUNTERS.get("mesh_layout_scenario_total")
    fused_scan.reset_launch_counts()
    got, (ms,) = timed(lambda: call(mesh), 1)
    launches = fused_scan.LAUNCHES[kernel]
    if COUNTERS.get("mesh_layout_scenario_total") - decided != 1 or launches != mesh.size:
        raise AssertionError(f"{label}: {launches} {kernel} launches for {mesh.size} shards, "
                             f"{COUNTERS.get('mesh_layout_scenario_total') - decided} "
                             f"scenario-axis decisions")
    want, (one_ms,) = timed(lambda: call(None), 1)
    for g, w in zip(got, want):
        if not np.array_equal(np.asarray(g), np.asarray(w)):
            raise AssertionError(f"{label}: the sharded answer != the one-launch answer")
    # again in turns, past the first use of each launch shape
    _, (one_again,) = timed(lambda: call(None), 1)
    _, (again,) = timed(lambda: call(mesh), 1)
    torch.cuda.empty_cache()
    print(f"{label}: {launches} {kernel} launches (one a shard) == the one-launch answer; "
          f"{ms:.1f} then {again:.1f} ms sharded, {one_ms:.1f} then {one_again:.1f} ms in one "
          f"launch (host wall around the call, synchronised) [{gpu}]", flush=True)
    return launches


def mesh_scenarios(gpu, mesh, tag, sweeps) -> dict:
    """Phase 29b (or d): the scenario axis on `mesh`."""
    from open_simulator_tpu_torch.ops import fused_scan

    cap, (outage, masks), (engine, actives) = sweeps

    def many(m):
        cap.mesh = m
        r = cap.probe_many(list(MESH_COUNTS))
        return r.placements, r.unscheduled, r.cpu_util, r.mem_util, r.vg_util

    def rows(m):
        outage.mesh = m
        return outage.probe_scenarios(*masks)

    def requests(m):
        engine.mesh = m
        return (engine.scan_scenarios(actives),)

    out = {"batch_launches": 0, "pins_launches": 0}
    out["batch_launches"] += mesh_rows(
        f"phase 29{tag} (probe_many over {len(MESH_COUNTS)} counts, {CAP_NODES} nodes x "
        f"{CAP_PODS} pods)", gpu, mesh, many, fused_scan.BATCH_KERNEL_NAME)
    out["pins_launches"] += mesh_rows(
        f"phase 29{tag} (probe_scenarios over {len(masks[0])} K=2 outage rows, {CHAOS_NODES} "
        f"nodes x {CHAOS_PODS} pods)", gpu, mesh, rows, fused_scan.PINS_FIRST_KERNEL_NAME)
    out["batch_launches"] += mesh_rows(
        f"phase 29{tag} (scan_scenarios over {len(actives)} request rows, {SERVE_NODES} nodes "
        f"x {SERVE_PODS} pods + {SERVE_REPLICAS} a row)", gpu, mesh, requests,
        fused_scan.BATCH_KERNEL_NAME)
    cap.mesh = outage.mesh = engine.mesh = None
    return out


def mesh_sweeps(gpu):
    """Phase 29b's inputs: the capacity sweep at phase 6's shape, the
    outage rows of phase 17b's cut at its committed count, and an engine
    over phase 24's cluster with MESH_REQUESTS request rows."""
    import numpy as np

    from open_simulator_tpu_torch.apply.applier import _capacity_feasible
    from open_simulator_tpu_torch.models import workloads as wl
    from open_simulator_tpu_torch.models.decode import ResourceTypes
    from open_simulator_tpu_torch.parallel.sweep import CapacitySweep
    from open_simulator_tpu_torch.resilience.chaos import ChaosEngine
    from open_simulator_tpu_torch.scheduler.core import AppResource
    from open_simulator_tpu_torch.scheduler.engine import TorchEngine
    from open_simulator_tpu_torch.scheduler.oracle import Oracle

    def sweep(n_nodes, n_pods, max_count):
        nodes, deployments, template = build_capacity_scenario(n_nodes, n_pods)
        cluster, res = ResourceTypes(), ResourceTypes()
        cluster.nodes, res.deployments = nodes, deployments
        wl.reset_name_counter()
        return CapacitySweep(cluster, [AppResource("bench", res)], template, max_count,
                             device="cuda")

    t0 = time.perf_counter()
    cap = sweep(CAP_NODES, CAP_PODS, max(MESH_COUNTS))
    cut = sweep(CHAOS_NODES, CHAOS_PODS, 64)
    feasible, caps = _capacity_feasible()
    best = cut.find_min_count(feasible, start=cut.lower_bound(*caps))
    chaos = ChaosEngine(cut, best.count, best.placements)
    scens, _mode = chaos.build_scenarios(2, 1, 32)
    picks = np.linspace(0, len(scens) - 1, MESH_ROWS).astype(int)
    masks = [np.stack(m) for m in zip(*(chaos._masks(scens[i])[:3] for i in picks))]
    nodes, pods = build_serve_cluster()
    wl.reset_name_counter()
    requests = [serve_pod(f"mesh-r{r}-{k}") for r in range(MESH_REQUESTS)
                for k in range(SERVE_REPLICAS)]
    engine = TorchEngine(Oracle(nodes), device="cuda")
    engine.begin_batch(pods + requests)
    actives = np.zeros((MESH_REQUESTS, len(pods) + len(requests)), bool)
    actives[:, :len(pods)] = True
    for r in range(MESH_REQUESTS):
        lo = len(pods) + r * SERVE_REPLICAS
        actives[r, lo:lo + SERVE_REPLICAS] = True
    print(f"phase 29b: inputs built in {time.perf_counter() - t0:.1f} s (host): the capacity "
          f"sweep, phase 17b's cut at +{best.count} with {len(scens)} K=2 outages "
          f"({MESH_ROWS} taken), phase 24's cluster with {MESH_REQUESTS} request rows [{gpu}]",
          flush=True)
    return cap, (cut, masks), (engine, actives)


def mesh_nodes(gpu, mesh, tag) -> dict:
    """Phase 29c (or d): phase 18's custom-plugin batch at MESH_NODES
    nodes on the node axis through TorchEngine.scan_active: == the
    unsharded torch scan on the card == the plain path (the torch scan
    on the CPU); ms a pod step."""
    import copy

    import numpy as np

    from open_simulator_tpu_torch.parallel import mesh as mesh_mod
    from open_simulator_tpu_torch.scheduler.engine import TorchEngine
    from open_simulator_tpu_torch.scheduler.oracle import Oracle
    from open_simulator_tpu_torch.scheduler.plugins import SchedulerPlugin, default_registry
    from open_simulator_tpu_torch.utils.trace import COUNTERS

    if MESH_NODES < mesh_mod.node_threshold():
        raise AssertionError("phase 29c: below the node threshold")
    nodes = [cap_node(f"node-{i:05d}", 16, 64, {"zone": f"z{i % 16}"})
             for i in range(MESH_NODES)]
    pods = [{"kind": "Pod", "metadata": {"name": f"mesh-p{i:04d}", "namespace": "mesh",
                                         "labels": {"app": f"app{i % 7}"}},
             "spec": {"containers": [{"name": "c", "image": "app", "resources": {
                 "requests": {"cpu": "2", "memory": "4Gi"}}}]}} for i in range(MESH_PODS)]
    default_registry.clear()
    default_registry.register(a1g_plugin(SchedulerPlugin))
    try:
        out = {}
        for label, dev, m, n_pods in (("sharded", "cuda", mesh, MESH_PODS),
                                      ("unsharded", "cuda", None, MESH_PODS),
                                      ("plain", "cpu", None, MESH_PLAIN_PODS)):
            eng = TorchEngine(Oracle(copy.deepcopy(nodes)), device=dev)
            eng.mesh = m
            eng.begin_batch(copy.deepcopy(pods[:n_pods]))
            decided = COUNTERS.get("mesh_layout_node_total")
            launches = COUNTERS.get("launches_mesh_scan")
            placed, (ms,) = timed(lambda: eng.scan_active(np.ones(n_pods, bool)), 1)
            routed = (COUNTERS.get("mesh_layout_node_total") - decided,
                      COUNTERS.get("launches_mesh_scan") - launches)
            if routed != ((1, 1) if m is not None else (0, 0)):
                raise AssertionError(f"phase 29{tag}: {label}: node decisions and mesh_scan "
                                     f"launches {routed}")
            out[label] = (np.asarray(placed), ms / n_pods)
    finally:
        default_registry.clear()
    if not (np.array_equal(out["sharded"][0], out["unsharded"][0])
            and np.array_equal(out["unsharded"][0][:MESH_PLAIN_PODS], out["plain"][0])):
        raise AssertionError(f"phase 29{tag}: the node-sharded placements != unsharded != "
                             f"the plain path")
    if (out["sharded"][0] < 0).any():
        raise AssertionError(f"phase 29{tag}: a pod found no node")
    print(f"phase 29{tag} (node axis, {MESH_NODES} nodes x {MESH_PODS} pods, phase 18's plugin, "
          f"{mesh.size} shards on {[str(d) for d in mesh.distinct()]}): placements == the "
          f"unsharded torch scan on the card == the plain path (CPU torch scan); "
          f"{out['sharded'][1]:.3f} ms a pod step sharded, {out['unsharded'][1]:.3f} unsharded "
          f"on the card, {out['plain'][1]:.3f} on the CPU (host wall, synchronised) [{gpu}]",
          flush=True)
    return {"sharded_ms": out["sharded"][1], "unsharded_ms": out["unsharded"][1]}


def phase29(gpu, root=None) -> dict:
    """The device mesh (parallel/mesh.py): (a) the CLI's --mesh and
    SIMON_MESH on this machine's cards, (b) the scenario axis and (c)
    the node axis on a MESH_SHARDS-shard mesh of cuda:0, (d) both on a
    mesh of real cards where there are two or more."""
    import torch

    from open_simulator_tpu_torch.parallel import mesh as mesh_mod

    mesh_cli(gpu)
    one_card = mesh_mod.Mesh(["cuda:0"] * MESH_SHARDS)
    sweeps = mesh_sweeps(gpu)
    out = mesh_scenarios(gpu, one_card, "b", sweeps)
    out.update(mesh_nodes(gpu, one_card, "c"))
    cards = torch.cuda.device_count()
    if cards >= 2:
        real = mesh_mod.Mesh([f"cuda:{i}" for i in range(cards)])
        again = mesh_scenarios(gpu, real, "d", sweeps)
        out["batch_launches"] += again["batch_launches"]
        out["pins_launches"] += again["pins_launches"]
        mesh_nodes(gpu, real, "d")
    else:
        print(f"phase 29d: not run: {cards} card on this machine, the real-card mesh needs a "
              f"second [{gpu}]", flush=True)
    return out


def workspace_check(label, gpu, plan, cls, scenarios, batch=False, pins_first=False) -> None:
    """One launch of `scenarios` with the allocator's peak reset: the cost
    count's workspace (obs/costs.py) must be at or above what the peak
    rose by, or a doomed launch would pass the ledger."""
    import torch

    from open_simulator_tpu_torch.obs import costs
    from open_simulator_tpu_torch.ops import fused_scan

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    if batch:
        out = fused_scan.run_fused_scan_batch(plan, cls, scenarios, pins_first=pins_first,
                                              site="workspace")
    else:
        out = fused_scan.run_fused_scan(plan, cls, *scenarios[0], site="workspace")
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - base
    del out
    name = (fused_scan.PINS_FIRST_KERNEL_NAME if pins_first
            else fused_scan.kernel_name(plan, batch))
    est = costs.workspace_bytes(plan, len(cls), len(scenarios), fused_scan.CLUSTERS[name])
    WORKSPACE.append({"label": label, "kernel": name, "scenarios": len(scenarios),
                      "estimate": est, "measured": measured,
                      "ratio": round(est / max(measured, 1), 4)})
    print(f"{label}: workspace of one {name} launch of {len(scenarios)} scenario(s): estimate "
          f"{est} B, the allocator's peak rose {measured} B (x{est / max(measured, 1):.3f}) "
          f"[{gpu}]", flush=True)
    if est < measured:
        raise AssertionError(f"{label}: the workspace estimate {est} B is below the measured "
                             f"{measured} B")


def instrumentation_cost(gpu, plan, batch, runs=3) -> dict:
    """B1 at phase 2's shape through the instrumented wrapper and through
    the bare launcher at the same cluster size, in turns (instrumented,
    bare, bare, instrumented, ...): card ms by CUDA events and host ms
    to the synchronised result."""
    import numpy as np

    from open_simulator_tpu_torch.ops import fused_scan

    n, p = plan.n, len(batch.class_of_pod)
    scen = [(np.ones(p, bool), np.ones(n, bool), batch.pinned_node)]
    cls = batch.class_of_pod
    cluster = fused_scan.choose_cluster(plan, 1, False)

    def inst():
        return fused_scan.run_fused_scan(plan, cls, *scen[0])

    def bare():
        return fused_scan._run_with_cluster(plan, cls, scen, False, cluster)

    times = {"instrumented": [], "bare": []}
    host = {"instrumented": [], "bare": []}
    for i in range(runs * 2):
        for name in (("instrumented", "bare") if i % 2 == 0 else ("bare", "instrumented")):
            fn = inst if name == "instrumented" else bare
            _, ms = cuda_ms(fn)
            _, h = timed(fn, 1)
            times[name].append(ms)
            host[name].append(h[0])
    med = {k: statistics.median(v) for k, v in times.items()}
    hmed = {k: statistics.median(v) for k, v in host.items()}
    print(f"phase 2: B1 at {n} x {p}, cluster {cluster}, instrumented against bare in turns: "
          f"card {med['instrumented']:.3f} vs {med['bare']:.3f} ms "
          f"(x{med['instrumented'] / med['bare']:.4f}; CUDA events, medians of {2 * runs}), "
          f"host to the synchronised result {hmed['instrumented']:.3f} vs {hmed['bare']:.3f} "
          f"ms (x{hmed['instrumented'] / hmed['bare']:.4f}) [{gpu}]", flush=True)
    return {"card": med, "host": hmed}


def main(argv=None) -> int:
    import numpy as np
    import torch

    argv = sys.argv[1:] if argv is None else argv
    only = argv[1].split(",") if len(argv) == 2 and argv[0] == "--only" else None
    if argv and only is None:
        print("usage: python3 chip_smoke.py [--only 14,17,18,19,21,22,23,24,25,26,27,28,29]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from open_simulator_tpu_torch.ops import fused_scan
    from open_simulator_tpu_torch.tools import stream_bench
    from open_simulator_tpu_torch.utils import nvcc

    t_start = time.perf_counter()
    gpu = card()
    print(f"card: {gpu}", flush=True)

    # ---- phase 1: build both sources, their compilers started together
    t0 = time.perf_counter()
    lib, stream_lib = nvcc.build_libraries([fused_scan.SOURCE, stream_bench.SOURCE])
    print(f"phase 1: built {lib.name} and {stream_lib.name} in "
          f"{time.perf_counter() - t0:.2f} s [{gpu}]", flush=True)
    print_build(lib)
    print_stream_build(stream_lib)
    if only is not None:
        # a focused run of phases that stand alone: no kernels or ok line
        import tempfile

        standalone = {"14": phase14, "17": phase17, "18": phase18, "19": phase19,
                      "21": phase21, "22": phase22, "23": phase23, "24": phase24,
                      "25": phase25, "26": phase26, "27": phase27, "28": phase28,
                      "29": phase29}
        with tempfile.TemporaryDirectory() as root:
            start_prep(root, [t for t, phs in (("shadow-full", "23"), ("shadow-cut", "23"),
                                               ("failover-config", "26 28"),
                                               ("twin-feed", "27"))
                              if set(phs.split()) & set(only)])
            for name in only:
                t0 = time.perf_counter()
                fn = standalone[name]
                fn(gpu) if name == "14" else fn(gpu, root)
                print(f"phase {name}: {time.perf_counter() - t0:.1f} s wall [{gpu}]",
                      flush=True)
        print(f"chip_smoke --only {','.join(only)}: {time.perf_counter() - t_start:.1f} s "
              f"[{gpu}]", flush=True)
        return 0

    # the host-only inputs of phases 23, 26 and 27, beside what follows
    import tempfile

    tmp = tempfile.TemporaryDirectory()
    start_prep(tmp.name)

    # ---- phase 2: B1 kernel vs plain on the card
    t0 = time.perf_counter()
    nodes, pods = build_scenario()
    plan, batch, names = encode(nodes, pods, "cuda")
    print(f"phase 2: encoded {plan.n} nodes x {len(names)} pods, {plan.u} classes "
          f"in {time.perf_counter() - t0:.2f} s (host)", flush=True)
    if plan.ext:
        raise AssertionError("phase 2: the default scenario must be the base plan")
    p, n = len(names), plan.n
    base = kernel_vs_plain("phase 2", gpu, plan, batch, np.ones(p, bool), np.ones(n, bool))
    sweep = cluster_sweep("phase 2", gpu, plan, batch,
                          [(np.ones(p, bool), np.ones(n, bool), batch.pinned_node)],
                          [base.pop("want")], PHASE2_CLUSTERS)
    base["prev_ms"] = sweep[1]
    instrumentation_cost(gpu, plan, batch)

    # ---- phase 3: the base main path
    base_launches = simulate_path("phase 3", gpu, nodes, pods, names, base["placements"],
                                  fused_scan.KERNEL_NAME)
    base["cluster"] = fused_scan.CLUSTERS[fused_scan.KERNEL_NAME]

    # ---- phase 4: B2
    g_nodes, g_pods = build_gpushare_scenario()
    g_plan, g_batch, g_names = encode(g_nodes, g_pods, "cuda")
    if not g_plan.has_gpu:
        raise AssertionError("phase 4a: the GPU-share plan has no GPU block")
    ext = kernel_vs_plain(f"phase 4a ({g_plan.n} GPU nodes x {len(g_names)} pods)", gpu,
                          g_plan, g_batch, np.ones(len(g_names), bool),
                          np.ones(g_plan.n, bool))
    ext_launches = simulate_path("phase 4a", gpu, g_nodes, g_pods, g_names,
                                 ext["placements"], fused_scan.EXT_KERNEL_NAME)
    m_nodes, m_pods = build_scenario(n_pods=MIXED_PODS, port_frac=0.1, scalar_frac=0.1)
    m_plan, m_batch, m_names = encode(m_nodes, m_pods, "cuda")
    if not (m_plan.has_ports and m_plan.has_scal):
        raise AssertionError("phase 4b: the plan lacks the port or scalar block")
    kernel_vs_plain(f"phase 4b (hostPorts + scalars, {m_plan.n} nodes x {len(m_names)} pods)",
                    gpu, m_plan, m_batch, np.ones(len(m_names), bool),
                    np.ones(m_plan.n, bool), runs=1)

    # ---- phase 5: B6, three scenarios of the default plan in one launch
    rng = np.random.RandomState(5)
    last_off = np.ones(n, bool)
    last_off[int(n * 0.9):] = False
    pin = batch.pinned_node
    scenarios = [
        (np.ones(p, bool), np.ones(n, bool), pin),
        (np.ones(p, bool), last_off, pin),
        (rng.rand(p) < 0.9, np.arange(n) % 7 != 0, pin),
    ]
    cls = batch.class_of_pod
    fused_scan.run_fused_scan_batch(plan, cls, scenarios)  # warm
    got, b_times = timed(lambda: fused_scan.run_fused_scan_batch(plan, cls, scenarios), 3)
    singles, s_times = timed(lambda: [fused_scan.run_fused_scan(plan, cls, a, v, pinned=q)
                                      for a, v, q in scenarios], 1)
    cut = prefix(scenarios, PHASE5_PLAIN_PODS)
    want, r_times = timed(lambda: fused_scan.fused_scan_batch_reference(plan, cls, cut), 1)
    batch_err = max(max_abs_err(g, w) for g, w in zip(
        fused_scan.run_fused_scan_batch(plan, cls, cut), want))
    single_err = max(max_abs_err(g, s) for g, s in zip(got, singles))
    if batch_err or single_err:
        raise AssertionError(f"phase 5: batch kernel != plain ({batch_err}) or != single "
                             f"launches ({single_err})")
    from open_simulator_tpu_torch.obs import costs

    b_bound = costs.bound(plan, cls, scenarios)
    workspace_check("phase 5", gpu, plan, cls, scenarios, batch=True)
    print(f"phase 5: clusters of {fused_scan.CLUSTERS[fused_scan.BATCH_KERNEL_NAME]} blocks; "
          f"{len(scenarios)} scenarios in one batch launch == single launches, "
          f"and over their first {PHASE5_PLAIN_PODS} pods == batch plain; batch kernel "
          f"{statistics.median(b_times):.3f} ms (median of 3: "
          f"{[round(t, 3) for t in b_times]}), {len(scenarios)} single launches "
          f"{s_times[0]:.1f} ms, batch plain of the cut {r_times[0]:.1f} ms, bound "
          f"{b_bound[0]:.4f} ms by {b_bound[1]} [{gpu}]", flush=True)

    # ---- phase 6: the capacity plan through the CLI; B6's entry is
    # measured there, at the shapes of its main path
    del plan, g_plan, m_plan, got, want, singles
    torch.cuda.empty_cache()
    cap = phase6(gpu)
    base["max_abs_err"] = max(base["max_abs_err"], cap["single_err"])
    print(f"phases 1-6: {time.perf_counter() - t_start:.1f} s [{gpu}]", flush=True)

    # ---- phase 7: B3, bench.py's storage scenario, then the 6-VG shape
    s_nodes, s_pods = build_storage_scenario()
    store = block_phase(f"phase 7 (B3, {STOR_NODES} storage nodes x {STOR_PODS} pods, plain "
                        f"over {B3_PLAIN_PODS})", gpu, s_nodes, s_pods,
                        fused_scan.STORE_KERNEL_NAME, plain_pods=B3_PLAIN_PODS)
    f_nodes, f_pods = build_storage_scenario(n_pods=FALLBACK_PODS, n_vgs=FALLBACK_VGS)
    block_phase(f"phase 7b ({FALLBACK_VGS} VGs, pods cut to {FALLBACK_PODS})", gpu, f_nodes,
                f_pods, fused_scan.STORE_KERNEL_NAME, simulate=False)
    del s_nodes, s_pods, f_nodes, f_pods

    # ---- phase 8: B4, the affinity stress at 10,000 nodes
    a_nodes = affinity_nodes(AFF_NODES, AFF_ZONES)
    a_pods = expand(a_nodes, affinity_stateful_sets())
    terms = block_phase(f"phase 8 (B4, affinity stress, {AFF_NODES} nodes x {len(a_pods)} "
                        f"pods, plain over {B4_PLAIN_PODS})", gpu, a_nodes, a_pods,
                        fused_scan.TERMS_KERNEL_NAME, plain_pods=B4_PLAIN_PODS)

    # ---- phase 9: B5, the same block at the JAX package's streamed size
    b5_nodes = affinity_nodes(B5_NODES, AFF_ZONES)
    b5_pods = expand(b5_nodes, affinity_stateful_sets())
    streamed = block_phase(f"phase 9 (B5, affinity stress, {B5_NODES} nodes x "
                           f"{len(b5_pods)} pods, plain over {B5_PLAIN_PODS})", gpu, b5_nodes,
                           b5_pods, fused_scan.TERMS_KERNEL_NAME, plain_pods=B5_PLAIN_PODS)
    del a_nodes, a_pods, b5_nodes, b5_pods
    torch.cuda.empty_cache()
    print(f"phases 7-9: {time.perf_counter() - t_start:.1f} s [{gpu}]", flush=True)

    # ---- phase 10: every block in one plan, single and batch
    mixed = phase10(gpu)

    # ---- phase 11: the slice's path through the CLI
    plan_launches = phase11(gpu)

    # ---- phase 12: B7, the streaming probe through its entry point
    stream = phase12(gpu)

    # ---- phase 13: A2, the torch scan under simulate()
    phase13(gpu)
    print(f"phases 10-13: {time.perf_counter() - t_start:.1f} s [{gpu}]", flush=True)

    # ---- phases 14-28: the planner's other paths, the timeline, shadow,
    # serve, the store, failover, the twin and the fleet; LANE_B's phases
    # in a second process, phase 25's processes beside phases 20-24
    torch.cuda.empty_cache()
    with tmp as root:
        lane_b = start_child(root, "lane-b", "lane", Path(root) / "lane-b", ",".join(LANE_B))
        chain = Background(store_chain, root)
        walls = {}
        for name, run in (("20", lambda: phase20(gpu, root, cap)),
                          ("23", lambda: phase23(gpu, root)),
                          ("24", lambda: phase24(gpu, root)),
                          ("25", lambda: phase25(gpu, root, chain)),
                          ("26", lambda: phase26(gpu, root)),
                          ("27", lambda: phase27(gpu, root)),
                          ("28", lambda: phase28(gpu, root))):
            t0 = time.perf_counter()
            walls[name] = run()
            print(f"phase {name}: {time.perf_counter() - t0:.1f} s wall [{gpu}]", flush=True)
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        other = wait_child(lane_b, echo=True)[0]
        print(f"phases {', '.join(LANE_B)} (lane b): waited {time.perf_counter() - t0:.1f} s "
              f"for them after phase 28 [{gpu}]", flush=True)
        walls.update(other["walls"])
        WORKSPACE.extend(other["workspace"])
    whatif, defrag, outage = walls["14"], walls["16"], walls["17"]
    print(f"phases 14-18: B6 launches on the new paths: {whatif['launches']} in the 8-spec "
          f"what-if's {whatif['rounds']} rounds, {defrag['launches']} for two defrag plans, "
          f"{outage['launches']} pins-first in phase 17's three runs [{gpu}]", flush=True)
    print(f"phases 19-21: the kubeConfig plan's launches {walls['19']['launches']}; the "
          f"resume, shell and halved plans' {[walls['20'][k] for k in ('resume', 'shell', 'oom')]} "
          f"[{gpu}]", flush=True)
    timeline, shadow = walls["22"], walls["23"]
    print(f"phases 22-23: {timeline['launches']} pins-first launches for the timeline's "
          f"{timeline['windows']} windows and probe decisions ({timeline['device_ms']:.1f} ms "
          f"on the card), {shadow['launches']} {fused_scan.KERNEL_NAME} launches for the "
          f"shadow replay's decisions, {shadow['tl_launches']} pins-first for its log's "
          f"timeline [{gpu}]", flush=True)
    serve = walls["24"]
    print(f"phase 24: {serve['batch_launches']} {fused_scan.BATCH_KERNEL_NAME} launches (one a "
          f"tick, {serve['card_ms']:.2f} ms on the card in the measured storm) and "
          f"{serve['base_launches']} {fused_scan.KERNEL_NAME} launches (the committed scan and "
          f"its re-simulations), other {serve['other_launches']} [{gpu}]", flush=True)
    aot, failover, twin = walls["25"], walls["26"], walls["27"]
    print(f"phases 25-27: {fused_scan.KERNEL_NAME} launches: {aot['launches']} in phase 25's "
          f"three processes, {failover['base_launches']} in phase 26's two daemons, "
          f"{twin['base_launches']} in phase 27's twin; "
          f"{fused_scan.BATCH_KERNEL_NAME} {failover['batch_launches']} in phase 26; "
          f"pins-first {twin['pins_launches']} for phase 27's forecast [{gpu}]", flush=True)
    fleet, mesh = walls["28"], walls["29"]
    print(f"phase 29: {fused_scan.BATCH_KERNEL_NAME} launches {mesh['batch_launches']} and "
          f"pins-first {mesh['pins_launches']} in the sharded runs [{gpu}]", flush=True)
    print(f"phase 28: {fused_scan.KERNEL_NAME} launches {fleet['base_launches']} and "
          f"{fused_scan.BATCH_KERNEL_NAME} {fleet['batch_launches']} in the fleets' replicas; "
          f"qps {fleet['qps'][1]:.2f} at 1 replica, {fleet['qps'][2]:.2f} at 2; "
          f"failover_first_200_s {fleet['first_200_s']:.3f}, failover_seconds "
          f"{fleet['failover_s']:.3f} [{gpu}]", flush=True)
    print("workspace estimate against the measured peak rise, a launch of each "
          "instantiation: " + json.dumps(WORKSPACE), flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s [{gpu}]", flush=True)

    def entry(name, replaces, launches, res):
        out = {"name": name, "route": "cuda",
               "source": "open_simulator_tpu_torch/csrc/fused_scan.cu",
               "replaces": replaces, "launches": launches,
               "max_abs_err": res["max_abs_err"], "ms": res["ms"],
               "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
               "bound_by": res["bound_by"], "library_ms": None}
        if "plain_pods" in res:  # plain_ms is over the first plain_pods pods
            out.update(plain_pods=res["plain_pods"], prefix_ms=res["prefix_ms"])
        return out

    print(gpu)  # nvidia-smi's own line: name, power limit
    print(json.dumps({"kernels": [
        dict(entry(fused_scan.KERNEL_NAME, "open_simulator_tpu/ops/pallas_scan.py:1690",
                   base_launches + shadow["launches"] + serve["base_launches"]
                   + aot["launches"] + failover["base_launches"] + twin["base_launches"]
                   + fleet["base_launches"], base),
             cluster=base["cluster"], prev_ms=base["prev_ms"],
             launches_by_phase={"3": base_launches, "23": shadow["launches"],
                                "24": serve["base_launches"], "25": aot["launches"],
                                "26": failover["base_launches"],
                                "27": twin["base_launches"],
                                "28": fleet["base_launches"]}),
        entry(fused_scan.EXT_KERNEL_NAME, "open_simulator_tpu/ops/pallas_scan.py:1961",
              ext_launches, ext),
        dict(entry(fused_scan.BATCH_KERNEL_NAME, "open_simulator_tpu/ops/pallas_scan.py:2974",
                   cap["launches"][fused_scan.BATCH_KERNEL_NAME] + serve["batch_launches"]
                   + failover["batch_launches"] + fleet["batch_launches"]
                   + mesh["batch_launches"], cap["batch"]),
             cluster=cap["batch"]["cluster"], prev_ms=cap["batch"]["prev_ms"],
             launches_by_phase={"6": cap["launches"][fused_scan.BATCH_KERNEL_NAME],
                                "24": serve["batch_launches"],
                                "26": failover["batch_launches"],
                                "28": fleet["batch_launches"],
                                "29": mesh["batch_launches"]}),
        dict(entry(fused_scan.STORE_KERNEL_NAME, "open_simulator_tpu/ops/pallas_scan.py:2028",
                   store["launches"], store), cluster=store["cluster"],
             prev_ms=store["prev_ms"]),
        dict(entry(fused_scan.TERMS_KERNEL_NAME, "open_simulator_tpu/ops/pallas_scan.py:2106",
                   terms["launches"], terms), cluster=terms["cluster"],
             prev_ms=terms["prev_ms"]),
        dict(entry(f"{fused_scan.TERMS_KERNEL_NAME} at {B5_NODES} nodes",
                   "open_simulator_tpu/ops/pallas_scan.py:1914", streamed["launches"],
                   streamed), cluster=streamed["cluster"], prev_ms=streamed["prev_ms"]),
        dict(entry(fused_scan.STORE_TERMS_KERNEL_NAME,
                   "open_simulator_tpu/ops/pallas_scan.py:2028",
                   plan_launches[fused_scan.STORE_TERMS_KERNEL_NAME], mixed),
             cluster=mixed["cluster"], prev_ms=mixed["prev_ms"]),
        dict(entry(fused_scan.PINS_FIRST_KERNEL_NAME,
                   "open_simulator_tpu/ops/pallas_scan.py:2974",
                   outage["launches"] + timeline["launches"] + twin["pins_launches"]
                   + mesh["pins_launches"], outage["cut"]),
             cluster=outage["cut"]["cluster"],
             pinned_step_us=outage["cut"]["pin_us"], free_step_us=outage["cut"]["free_us"],
             launches_by_phase={"17": outage["launches"], "22": timeline["launches"],
                                "27": twin["pins_launches"], "29": mesh["pins_launches"]}),
        dict(entry(stream_bench.KERNEL_NAME, "tools/stream_bench.py:31", stream["launches"],
                   stream), source="open_simulator_tpu_torch/csrc/stream_bench.cu",
             library_ms=stream["library_ms"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
