"""YAML ingestion: directory walking and the 13-kind object demux.

Mirrors pkg/utils/utils.go:44-131 (ParseFilePath / ReadYamlFile /
GetYamlContentFromDirectory) and pkg/simulator/utils.go:139-183
(GetObjectFromYamlContent). Objects are kept as plain dicts (the parsed
YAML); typed behavior lives in accessor modules.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List


_YAML_EXT = (".yaml", ".yml")


@dataclass
class ResourceTypes:
    """The 13 kinds the reference tracks (pkg/simulator/core.go:29-43)."""

    pods: List[dict] = field(default_factory=list)
    deployments: List[dict] = field(default_factory=list)
    replica_sets: List[dict] = field(default_factory=list)
    replication_controllers: List[dict] = field(default_factory=list)
    stateful_sets: List[dict] = field(default_factory=list)
    daemon_sets: List[dict] = field(default_factory=list)
    jobs: List[dict] = field(default_factory=list)
    cron_jobs: List[dict] = field(default_factory=list)
    nodes: List[dict] = field(default_factory=list)
    services: List[dict] = field(default_factory=list)
    persistent_volume_claims: List[dict] = field(default_factory=list)
    storage_classes: List[dict] = field(default_factory=list)
    pod_disruption_budgets: List[dict] = field(default_factory=list)
    # Extension beyond the reference demux (pkg/simulator/utils.go:139-183
    # has no PriorityClass case): kept so priorityClassName on workloads
    # can resolve to a numeric priority the way the real apiserver's
    # admission plugin would (scheduler/preemption.py).
    priority_classes: List[dict] = field(default_factory=list)

    def extend(self, other: "ResourceTypes"):
        for f in self.__dataclass_fields__:
            getattr(self, f).extend(getattr(other, f))

    def copy(self) -> "ResourceTypes":
        out = ResourceTypes()
        for f in self.__dataclass_fields__:
            setattr(out, f, list(getattr(self, f)))
        return out


_KIND_FIELD = {
    "Pod": "pods",
    "Deployment": "deployments",
    "ReplicaSet": "replica_sets",
    "ReplicationController": "replication_controllers",
    "StatefulSet": "stateful_sets",
    "DaemonSet": "daemon_sets",
    "Job": "jobs",
    "CronJob": "cron_jobs",
    "Node": "nodes",
    "Service": "services",
    "PersistentVolumeClaim": "persistent_volume_claims",
    "StorageClass": "storage_classes",
    "PodDisruptionBudget": "pod_disruption_budgets",
    "PriorityClass": "priority_classes",
}


def list_files(path: str) -> List[str]:
    """ParseFilePath: a dir yields its (recursive) files, a file itself."""
    if os.path.isdir(path):
        out = []
        for root, _, files in os.walk(path):
            for f in sorted(files):
                out.append(os.path.join(root, f))
        return sorted(out)
    return [path]


def safe_load_all(text: str) -> List:
    """`yaml.safe_load_all(text)` as a list. Parsed by libyaml where
    PyYAML has it (the same constructor and resolver, so the same
    documents, several times faster on a cluster of thousands of
    objects); text libyaml refuses is parsed again by the pure loader,
    so an error is PyYAML's own."""
    import yaml  # only YAML ingestion needs PyYAML

    loader = getattr(yaml, "CSafeLoader", None)
    if loader is not None:
        try:
            return list(yaml.load_all(text, Loader=loader))
        except yaml.YAMLError:
            pass
    return list(yaml.safe_load_all(text))


def read_yaml_documents(path: str) -> List[dict]:
    if not path.endswith(_YAML_EXT):
        return []
    with open(path) as f:
        docs = safe_load_all(f.read())
    return [d for d in docs if isinstance(d, dict)]


def yaml_content_from_directory(dir_path: str) -> List[str]:
    """Raw YAML strings from every .yaml/.yml under dir (recursively)."""
    out = []
    for p in list_files(dir_path):
        if p.endswith(_YAML_EXT):
            with open(p) as f:
                out.append(f.read())
    return out


def decode_yaml_content(yaml_strings: List[str]) -> ResourceTypes:
    """GetObjectFromYamlContent: demux documents by kind; unknown kinds
    are silently skipped (pkg/simulator/utils.go:175-177)."""
    res = ResourceTypes()
    for s in yaml_strings:
        for doc in safe_load_all(s):
            if not isinstance(doc, dict):
                continue
            kind = doc.get("kind")
            f = _KIND_FIELD.get(kind)
            if f is None:
                continue
            getattr(res, f).append(doc)
    return res


def load_directory(dir_path: str) -> ResourceTypes:
    return decode_yaml_content(yaml_content_from_directory(dir_path))
