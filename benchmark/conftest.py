"""The test sizes of the configurations and traffic mixes that came
after benchmark/tests/tiny.py: pytest loads this file before the tests
under benchmark/tests, so that `tiny.make_root` cuts every configuration
and traffic mix of BENCHMARK.json to a size a CPU run holds."""

from benchmark.tests import tiny

tiny.TINY_NODES.setdefault("k8s-5k-mixed", 40)
tiny.TINY_REPLICAS.setdefault("mixed-rollout", [12] * 6)
tiny.TINY_REPLICAS.setdefault("basic-rollout", [1800])
