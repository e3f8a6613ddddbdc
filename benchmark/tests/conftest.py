"""Tests of the benchmark: `python3 -m pytest benchmark/tests`. They run
on the CPU, with the kernels' plain versions; a test that needs the card
carries the `cuda` marker and skips without one (it decides inside the
test, never at import): `python3 -m pytest benchmark/tests -m cuda` on
a machine with the card."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips where there is none)")


@pytest.fixture
def tiny_root(tmp_path):
    from benchmark.tests import tiny

    return tiny.make_root(tmp_path / "checkout")
