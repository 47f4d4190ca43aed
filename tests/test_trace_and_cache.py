"""The profiler trace reduction (tools/xplane.py) and the compile cache
location (tpulp.utils.compile_cache)."""

import os

import pytest

import jax
import jax.numpy as jnp

from tools.xplane import reduce_trace
from tpulp.utils.compile_cache import ENV_VAR, compile_cache_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_keeps_the_environment_variable():
    assert compile_cache_dir({ENV_VAR: "/srv/cache"}) == "/srv/cache"


def test_cache_dir_defaults_to_the_fixed_repo_path():
    assert compile_cache_dir({}) == os.path.join(REPO, ".jax_cache")


@pytest.fixture(scope="module")
def cpu_trace(tmp_path_factory):
    """A small trace recorded here: three calls of a jitted matmul."""
    trace_dir = str(tmp_path_factory.mktemp("trace"))
    f = jax.jit(lambda a: (a @ a).sum())
    x = jnp.ones((128, 128), jnp.float32)
    f(x).block_until_ready()
    with jax.profiler.trace(trace_dir):
        for _ in range(3):
            f(x).block_until_ready()
    return trace_dir


def test_reduce_trace_sums_op_time_on_a_named_plane(cpu_trace):
    r = reduce_trace(cpu_trace, plane=lambda name: name == "/host:CPU",
                     line=lambda name: name.startswith("tf_XLAPjRtCpuClient"))
    assert r["planes"] == ["/host:CPU"]
    dots = [k for k in r["ops"] if k.startswith("dot")]
    assert dots and r["ops"][dots[0]][1] >= 3
    assert 0 < r["busy_ns"] <= r["window_ns"]
    assert 0.0 <= r["idle_share"] < 1.0
    assert r["n_events"] == sum(c for _, c in r["ops"].values())


def test_reduce_trace_fails_without_a_matching_plane(cpu_trace):
    # the default predicate takes the GPU's planes; a CPU trace has none
    with pytest.raises(ValueError, match="no trace plane"):
        reduce_trace(cpu_trace)
