"""The GPU port's YAML ingestion (models/decode.py) against the JAX
package's: libyaml parses where PyYAML has it, and the documents, the
demux by kind and the errors are the pure loader's."""

import dataclasses
import os

import pytest
import yaml

from open_simulator_tpu.models import decode as jax_decode
from open_simulator_tpu_torch.models import decode as port_decode

_EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "example")
EXAMPLES = [os.path.relpath(os.path.join(root, d), _EXAMPLE)
            for root, dirs, _ in os.walk(_EXAMPLE) for d in dirs]

# scalars whose types the YAML 1.1 resolver decides: both parsers must
# hand the same events to it
_SCALARS = """\
kind: Pod
metadata:
  name: p-0
  labels: {a: "yes", b: on, c: off, d: ~, e: 0x1f, f: 1e3, g: 010, h: .inf, i: 2024-01-02}
  annotations:
    block: |
      line one
        line two
    folded: >
      folded
      text
spec:
  nodeName: node-0
  containers:
  - {name: c, image: "i:1", resources: {requests: {cpu: 500m, memory: 1Gi}}}
  tolerations: [{key: k, operator: Exists, effect: NoSchedule}]
---
kind: Node
metadata: {name: node-0, labels: {zone: z1, gpu: true}}
status: {allocatable: {cpu: "64", memory: 256Gi, pods: 110}}
---
# a comment document
---
kind: Deployment
metadata: {name: web, namespace: default}
spec: {replicas: 3, template: {spec: {containers: [{name: c, image: i}]}}}
"""


def _as_dict(res):
    return dataclasses.asdict(res)


@pytest.mark.parametrize("path", sorted(EXAMPLES))
def test_example_directories_decode_as_the_jax_package(path):
    """Each example directory decodes to the JAX package's objects, or
    (a chart's templates, which are not YAML before rendering) fails
    with its error."""
    path = os.path.join(_EXAMPLE, path)
    try:
        want = _as_dict(jax_decode.load_directory(path))
    except yaml.YAMLError as e:
        with pytest.raises(type(e)) as got:
            port_decode.load_directory(path)
        assert str(got.value) == str(e)
        return
    assert _as_dict(port_decode.load_directory(path)) == want


@pytest.mark.parametrize("c_loader", [True, False])
def test_scalars_and_documents_equal_the_pure_loader(monkeypatch, c_loader):
    if not c_loader:
        monkeypatch.delattr(yaml, "CSafeLoader", raising=False)
    got = port_decode.decode_yaml_content([_SCALARS])
    assert _as_dict(got) == _as_dict(jax_decode.decode_yaml_content([_SCALARS]))
    assert port_decode.safe_load_all(_SCALARS) == list(yaml.safe_load_all(_SCALARS))


def test_read_yaml_documents_equals_the_jax_package(tmp_path):
    path = tmp_path / "objects.yaml"
    path.write_text(_SCALARS)
    assert port_decode.read_yaml_documents(str(path)) == \
        jax_decode.read_yaml_documents(str(path))


@pytest.mark.parametrize("text", ["kind: Pod\nmetadata: {name: [unclosed\n",
                                  "a: b\n  c: d\n", "- a\nb: c\n", "key: 'open\n"])
def test_malformed_yaml_raises_the_pure_loaders_error(text):
    with pytest.raises(yaml.YAMLError) as want:
        list(yaml.safe_load_all(text))
    with pytest.raises(yaml.YAMLError) as got:
        port_decode.decode_yaml_content([text])
    assert type(got.value) is type(want.value) and str(got.value) == str(want.value)
