"""The GPU port's Helm renderer (open_simulator_tpu_torch/models/chart.py,
a copy of the JAX package's) renders every case of tests/test_chart.py
exactly as the JAX package's does.

Each case runs twice, once on each package's process_chart /
render_template / ChartError, recording every rendered output; both
runs must pass the case's own assertions and the outputs must be
identical. The cases that need the reference's example charts skip
where those are absent, as in tests/test_chart.py."""

import inspect

import pytest

import test_chart
from open_simulator_tpu.models import chart as jax_chart
from open_simulator_tpu_torch.models import chart as port_chart


def _cases():
    out = []
    for name, fn in sorted(vars(test_chart).items()):
        if not name.startswith("test_") or not callable(fn):
            continue
        marks = [m.name for m in getattr(fn, "pytestmark", [])]
        out.append(pytest.param(name, marks=pytest.mark.skipif(
            "skipif" in marks and not test_chart.os.path.isdir(test_chart.YODA),
            reason="reference example charts not mounted")))
    return out


def _run(case, module, monkeypatch, tmp_path):
    rendered = []

    def recording(fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            rendered.append(out)
            return out

        return call

    monkeypatch.setattr(test_chart, "process_chart", recording(module.process_chart))
    monkeypatch.setattr(test_chart, "render_template", recording(module.render_template))
    monkeypatch.setattr(test_chart, "ChartError", module.ChartError)
    fn = getattr(test_chart, case)
    root = tmp_path / module.__name__.split(".")[0]
    root.mkdir()
    fn(*([root] if "tmp_path" in inspect.signature(fn).parameters else []))
    return rendered


@pytest.mark.parametrize("case", _cases())
def test_render_case_is_identical(case, monkeypatch, tmp_path):
    jax_out = _run(case, jax_chart, monkeypatch, tmp_path)
    port_out = _run(case, port_chart, monkeypatch, tmp_path)
    assert port_out == jax_out
    assert port_out, "the case rendered nothing"


def test_quickstart_chart_renders_identically():
    chart = "example/application/charts/hello"
    assert port_chart.process_chart("hello-chart", chart) == jax_chart.process_chart(
        "hello-chart", chart)


def test_archive_scratch_is_the_ports_own(tmp_path):
    """A packaged subchart extracts under the port's own scratch prefix,
    never into the JAX package's."""
    import os
    import tarfile

    child = test_chart.write_chart(tmp_path, "child", {"cm.yaml": "kind: ConfigMap\n"})
    parent = test_chart.write_chart(tmp_path, "parent", {"cm.yaml": "kind: Service\n"},
                                    chart_yaml={"name": "parent", "version": "1.0.0",
                                                "dependencies": [{"name": "child"}]})
    os.makedirs(os.path.join(parent, "charts"))
    with tarfile.open(os.path.join(parent, "charts", "child-0.1.0.tgz"), "w:gz") as tf:
        tf.add(child, arcname="child")
    kinds = sorted(port_chart.process_chart("rel", parent))
    assert len(kinds) == 2
    dirs = port_chart._ARCHIVE_LIVE
    assert dirs and all(os.path.basename(d).startswith("simon-torch-chart-") for d in dirs)
