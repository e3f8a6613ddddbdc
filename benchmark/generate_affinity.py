"""The generator of `simon apply` requests whose pods carry inter-pod
affinity of every kind (benchmark/generate.py makes the rest).

A traffic mix's workload may give, beside `anti` (required pod
anti-affinity), `affinity` (required pod affinity) and `pref_affinity`
and `pref_anti` (preferred pod affinity and anti-affinity, each term
with its `weight`). Every term is a dict with a `key` (topology key)
and a `selector` (matchLabels), and names the request's namespace in
`namespaces`, as scheduler_perf's templates name theirs. The seed
moves what generate.py's seed moves (the zones, the names) and nothing
else: `make_instance` draws from the same stream.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import List

from . import generate

# the term lists a workload may carry, by the field that holds them:
# (podAffinity or podAntiAffinity, required or preferred)
TERM_KINDS = {
    "affinity": ("podAffinity", "requiredDuringSchedulingIgnoredDuringExecution"),
    "anti": ("podAntiAffinity", "requiredDuringSchedulingIgnoredDuringExecution"),
    "pref_affinity": ("podAffinity", "preferredDuringSchedulingIgnoredDuringExecution"),
    "pref_anti": ("podAntiAffinity", "preferredDuringSchedulingIgnoredDuringExecution"),
}


@dataclass
class Workload(generate.Workload):
    """A workload with inter-pod affinity terms of all four kinds."""

    affinity: List[dict] = field(default_factory=list)
    pref_affinity: List[dict] = field(default_factory=list)
    pref_anti: List[dict] = field(default_factory=list)


@dataclass
class Instance(generate.Instance):
    """A request whose workloads are `Workload`s of this module."""

    def _workload_doc(self, w: Workload) -> dict:
        doc = super()._workload_doc(w)
        spec = doc["spec"]["template"]["spec"]
        spec.pop("affinity", None)
        affinity: dict = {}
        for kind, (group, when) in TERM_KINDS.items():
            for t in getattr(w, kind):
                term = {"labelSelector": {"matchLabels": dict(t["selector"])},
                        "topologyKey": t["key"], "namespaces": [self.namespace]}
                if when.startswith("preferred"):
                    term = {"podAffinityTerm": term, "weight": int(t["weight"])}
                affinity.setdefault(group, {}).setdefault(when, []).append(term)
        if affinity:
            spec["affinity"] = affinity
        return doc


def make_instance(config: dict, traffic: dict, seed: int, index: int) -> Instance:
    """Request `index` of a run seeded `seed` (index -1 is the warm-up's),
    its workloads with their inter-pod terms."""
    base = generate.make_instance(config, traffic, seed, index)
    inst = Instance(**{f.name: getattr(base, f.name) for f in fields(base)})
    inst.workloads = [
        Workload(**{f.name: getattr(w, f.name) for f in fields(w)},
                 **{kind: list(spec.get(kind, [])) for kind in
                    ("affinity", "pref_affinity", "pref_anti")})
        for w, spec in zip(base.workloads, traffic["workloads"])]
    return inst
