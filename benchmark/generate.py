"""The benchmark's generator of `simon apply` requests.

A cell is a configuration (a cluster deployment, `configs/<name>.json`)
under a traffic mix (`traffic/<name>.json`). The configuration gives
the nodes: how many, their template, the zone label and its values, the
node a plan adds. The traffic mix gives the apps one request asks for:
each workload's kind, replicas, requests, pod labels and constraints
(required pod anti-affinity terms, DoNotSchedule spread constraints).
From the two files and the run's seed this module makes the request
instances: each is a whole `simon apply` input, as plain arrays that
the reference reads and as the YAML files and simon config that the
program reads. The seed changes only the arrangement (which zone each
node lies in, the names), never a size or a count, so that every seed
asks for the same work.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

HOSTNAME_KEY = "kubernetes.io/hostname"
_NAME, _ZONE = "nodenameplaceholder", "zoneplaceholder"
_BIN = {"Ki": 1 << 10, "Mi": 1 << 20, "Gi": 1 << 30, "Ti": 1 << 40}


def cpu_milli(q: str) -> int:
    """Millicores of a CPU quantity ("500m", "2", "1.5")."""
    q = str(q)
    if q.endswith("m"):
        return int(q[:-1])
    whole, _, frac = q.partition(".")
    return int(whole or 0) * 1000 + int((frac + "000")[:3])


def mem_bytes(q: str) -> int:
    """Bytes of a memory quantity with a binary suffix or none."""
    q = str(q)
    for suf, mult in _BIN.items():
        if q.endswith(suf):
            return int(q[: -len(suf)]) * mult
    return int(q)


@dataclass
class Workload:
    """One Deployment or StatefulSet of a request. `labels` are its
    pods' labels; `anti` its required pod anti-affinity terms and
    `spread` its DoNotSchedule spread constraints, each a dict with a
    `key` (topology key) and a `selector` (matchLabels), a spread
    constraint also its `max_skew`."""

    name: str
    kind: str
    replicas: int
    cpu: str
    memory: str
    labels: Dict[str, str] = field(default_factory=dict)
    tolerate: bool = False
    anti: List[dict] = field(default_factory=list)
    spread: List[dict] = field(default_factory=list)

    @property
    def pod_labels(self) -> Dict[str, str]:
        """The labels each pod carries: `app` its workload's name, and
        the workload's own."""
        return {"app": self.name, **self.labels}

    @property
    def cpu_m(self) -> int:
        return cpu_milli(self.cpu)

    @property
    def mem(self) -> int:
        return mem_bytes(self.memory)

    def pod_keys(self) -> List[str]:
        """The identity of each replica in the comparison: a
        StatefulSet's pods by their own names, a Deployment's by the
        Deployment (its replicas are interchangeable)."""
        if self.kind == "StatefulSet":
            return [f"{self.name}-{i}" for i in range(self.replicas)]
        return [self.name] * self.replicas


@dataclass
class Instance:
    """One request: a cluster, the apps to place and the new node."""

    tag: str
    namespace: str
    node_names: List[str]
    node_cpu_m: np.ndarray
    node_mem: np.ndarray
    node_pods: np.ndarray
    tainted: np.ndarray
    zone: np.ndarray  # each node's zone, an index into zone_names
    zone_names: List[str]  # empty where the nodes carry no zone label
    zone_key: Optional[str]
    taint: Optional[dict]
    node_spec: dict
    new_node_spec: dict
    new_node_zone: int
    max_new: int
    workloads: List[Workload] = field(default_factory=list)

    @property
    def n_base(self) -> int:
        return len(self.node_names)

    @property
    def pods(self) -> int:
        return sum(w.replicas for w in self.workloads)

    def queue(self) -> List[int]:
        """Workload indices in the order their pods are queued: pods
        with tolerations first, then pods with a nodeSelector (none
        here), otherwise in the order the workloads are written."""
        order = list(range(len(self.workloads)))
        return sorted(order, key=lambda i: not self.workloads[i].tolerate)

    # -- the program's input ----------------------------------------------

    def write(self, root: str) -> str:
        """Write this request as a simon config under `root`; returns
        the config's path."""
        import yaml

        dumper = getattr(yaml, "CSafeDumper", yaml.SafeDumper)
        for sub in ("cluster", "app", "newnode"):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
        zone_of = (lambda i: self.zone_names[self.zone[i]]) if self.zone_names else None
        # every node's document is one of two (tainted or not) with its
        # name and zone filled in: the bytes yaml.dump_all would write
        form = {}
        for tainted in (False, True) if self.taint else (False,):
            doc = self._node_doc(None, tainted)
            form[tainted] = yaml.dump(doc, Dumper=dumper, sort_keys=False)
        with open(os.path.join(root, "cluster", "nodes.yaml"), "w") as f:
            docs = []
            for i in range(self.n_base):
                text = form[bool(self.tainted[i])].replace(_NAME, self.node_names[i])
                docs.append(text.replace(_ZONE, zone_of(i)) if zone_of else text)
            f.write("---\n".join(docs))
        with open(os.path.join(root, "app", "workloads.yaml"), "w") as f:
            yaml.dump_all([self._workload_doc(w) for w in self.workloads], f,
                          Dumper=dumper, sort_keys=False)
        with open(os.path.join(root, "newnode", "node.yaml"), "w") as f:
            text = yaml.dump(self._node_doc(self.new_node_spec, False), Dumper=dumper,
                             sort_keys=False).replace(_NAME, "new-node")
            if self.zone_names:
                text = text.replace(_ZONE, self.zone_names[self.new_node_zone])
            f.write(text)
        cfg = os.path.join(root, "simon-config.yaml")
        with open(cfg, "w") as f:
            yaml.dump({
                "apiVersion": "simon/v1alpha1", "kind": "Config",
                "metadata": {"name": self.tag},
                "spec": {"cluster": {"customConfig": os.path.join(root, "cluster")},
                         "appList": [{"name": self.namespace,
                                      "path": os.path.join(root, "app")}],
                         "newNode": os.path.join(root, "newnode")},
            }, f, Dumper=dumper, sort_keys=False)
        return cfg

    def _node_doc(self, spec: Optional[dict], tainted: bool) -> dict:
        """A node's document with placeholders for its name and zone."""
        spec = spec or self.node_spec
        res = {"cpu": spec["cpu"], "memory": spec["memory"], "pods": spec["pods"]}
        labels = {HOSTNAME_KEY: _NAME}
        if self.zone_names:
            labels[self.zone_key] = _ZONE
        doc = {"apiVersion": "v1", "kind": "Node",
               "metadata": {"name": _NAME, "labels": labels}}
        if tainted:
            doc["spec"] = {"taints": [dict(self.taint)]}
        doc["status"] = {"allocatable": dict(res), "capacity": dict(res)}
        return doc

    def _workload_doc(self, w: Workload) -> dict:
        labels = w.pod_labels
        pod_spec = {"containers": [{
            "name": "main", "image": f"registry.local/{self.namespace}/{w.name}:1.0",
            "resources": {"requests": {"cpu": w.cpu, "memory": w.memory}}}]}
        if w.tolerate:
            pod_spec["tolerations"] = [{"key": self.taint["key"], "operator": "Exists"}]
        if w.anti:
            pod_spec["affinity"] = {"podAntiAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [
                    {"labelSelector": {"matchLabels": dict(t["selector"])},
                     "topologyKey": t["key"]} for t in w.anti]}}
        if w.spread:
            pod_spec["topologySpreadConstraints"] = [{
                "maxSkew": int(c["max_skew"]), "topologyKey": c["key"],
                "whenUnsatisfiable": "DoNotSchedule",
                "labelSelector": {"matchLabels": dict(c["selector"])}} for c in w.spread]
        # simon gives each pod its workload's labels (its owner's, not
        # the template's), so both carry them
        return {"apiVersion": "apps/v1", "kind": w.kind,
                "metadata": {"name": w.name, "namespace": self.namespace,
                             "labels": dict(labels)},
                "spec": {"replicas": w.replicas, "selector": {"matchLabels": {"app": w.name}},
                         "template": {"metadata": {"labels": labels}, "spec": pod_spec}}}


def _rng(seed: int, index: int) -> np.random.Generator:
    """The generator of instance `index` of a run: any whole seed,
    negative or past 64 bits, maps onto one stream."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64), index]))


def _token(rng: np.random.Generator) -> str:
    letters = "abcdefghijklmnopqrstuvwxyz0123456789"
    return "".join(letters[int(i)] for i in rng.integers(0, len(letters), 5))


def make_instance(config: dict, traffic: dict, seed: int, index: int) -> Instance:
    """Request `index` of a run seeded `seed` (index -1 is the warm-up's)."""
    rng = _rng(seed, index + 1)
    n = int(config["nodes"])
    ids = np.arange(n)
    every = int(config.get("taint_every", 0))
    tainted = (((ids - int(rng.integers(every))) % every) == 0) if every else np.zeros(n, bool)
    zone_names = list(config.get("zone_values", []))
    # the same number of nodes in each zone on every seed, placed by it
    zone = rng.permutation(ids % len(zone_names)) if zone_names else np.zeros(n, np.int64)
    spec = config["node"]
    inst = Instance(
        tag=f"{traffic['namespace']}-{index + 1}-{_token(rng)}",
        namespace=traffic["namespace"],
        node_names=[f"node-{i:05d}" for i in range(n)],
        node_cpu_m=np.full(n, cpu_milli(spec["cpu"]), dtype=np.int64),
        node_mem=np.full(n, mem_bytes(spec["memory"]), dtype=np.int64),
        node_pods=np.full(n, int(spec["pods"]), dtype=np.int64),
        tainted=tainted, zone=zone, zone_names=zone_names,
        zone_key=config.get("zone_key"), taint=config.get("taint"),
        node_spec=dict(spec), new_node_spec=dict(config["new_node"]), new_node_zone=0,
        max_new=int(config["max_new_nodes"]),
    )
    token = _token(rng)
    for w in traffic["workloads"]:
        inst.workloads.append(Workload(
            name=f"{w['name']}-{token}", kind=w["kind"], replicas=int(w["replicas"]),
            cpu=w["cpu"], memory=w["memory"], labels=dict(w.get("labels", {})),
            tolerate=bool(w.get("tolerate")), anti=list(w.get("anti", [])),
            spread=list(w.get("spread", []))))
    return inst
