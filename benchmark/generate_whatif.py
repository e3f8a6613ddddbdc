"""The benchmark's generator of what-if rounds for `simon serve`.

A configuration with a `committed` workload (`configs/k8s-5k-serve.json`)
is a cluster that the daemon holds committed: its nodes, made from the
seed as benchmark/generate.py makes them, and one workload in the
cluster's own directory, which the daemon places when it builds its
session. A traffic mix of the `simon_serve` driver
(`traffic/whatif-16.json`) gives the what-if each of its `clients`
callers POSTs in a round, all at once. A what-if is an `Instance` of
the cluster's nodes with that caller's one workload: the reference
places it on the committed state (benchmark/reference/kube_v120_whatif.py).
The seed moves the zones and the names, never a size or a count.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import List

from . import generate


@dataclass
class Round:
    """One round: a what-if a caller, in the callers' order."""

    tag: str
    whatifs: List[generate.Instance]


def make_cluster(config: dict, seed: int) -> generate.Instance:
    """The cluster of a run seeded `seed`: its nodes, and its committed
    workload as the Instance's one workload."""
    committed = config["committed"]
    mix = {"namespace": committed["namespace"], "workloads": [committed]}
    return generate.make_instance(config, mix, seed, -1)


def make_round(cluster: generate.Instance, traffic: dict, seed: int, index: int) -> Round:
    """Round `index` of a run seeded `seed` (index -1 is the warm-up's):
    each caller's workload named from the round's own stream."""
    rng = generate._rng(seed, index + 2)
    token = generate._token(rng)
    whatifs = []
    for c in range(int(traffic["clients"])):
        ws = [generate.Workload(name=f"{w['name']}-{token}-{c:02d}", kind=w["kind"],
                                replicas=int(w["replicas"]), cpu=w["cpu"], memory=w["memory"])
              for w in traffic["workloads"]]
        whatifs.append(dataclasses.replace(cluster, tag=f"{token}-{c:02d}",
                                           namespace=traffic["namespace"], workloads=ws))
    return Round(tag=f"{traffic['namespace']}-{index + 1}-{token}", whatifs=whatifs)


def write_cluster(cluster: generate.Instance, root: str) -> str:
    """Write the cluster as a simon config under `root`, its committed
    workload in the cluster's own directory; returns the config's path.
    `simon serve` reads only the cluster: its apps arrive a request."""
    cfg = cluster.write(root)
    os.replace(os.path.join(root, "app", "workloads.yaml"),
               os.path.join(root, "cluster", "workloads.yaml"))
    return cfg


def envelope(whatif: generate.Instance) -> bytes:
    """The body a caller POSTs to /v1/simulate: its workloads, each an
    app named after it, as JSON (which YAML reads)."""
    apps = [{"name": w.name, "yaml": json.dumps(whatif._workload_doc(w))}
            for w in whatif.workloads]
    return json.dumps({"apps": apps}).encode()
