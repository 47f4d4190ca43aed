"""Tests that need the card: the executables compiled for the GPU.

Marked ``gpu``; the ``gpu`` fixture skips them where JAX has no GPU.
``chip_smoke.py`` runs them on the card (phase h)."""

import pytest

import jax
import jax.numpy as jnp

import bench
from tpulp.core import SolverOptions, Status
from tpulp.solve import run_simplex, run_simplex_blocked, solve_lp

pytestmark = pytest.mark.gpu


def test_compiled_pins_on_the_gpu(gpu):
    """Dantzig, Bland, devex, deep phase 1 and degenerate ties through the
    blocked driver compiled for the card, each proven optimal by an f64
    strong-duality certificate."""
    results = bench.compiled_pin_suite()
    assert len(results) == 5 and all(r["ok"] for r in results)


def test_blocked_and_rank1_agree_on_the_gpu(gpu):
    m = n = 256
    st = bench.make_bench_state(m, n, jnp.float32, seed=5, bounded=True)
    opts = SolverOptions.for_dtype(jnp.float32, max_iters=5000)
    rank1 = run_simplex(st, opts)
    blocked = run_simplex_blocked(st, opts, block=32)
    assert int(rank1.status) == int(blocked.status) == Status.OPTIMAL
    for out in (rank1, blocked):
        bench.verify_terminal_basis(out, m, n, 5, "float32", bounded=True)
    z1, zb = float(rank1.objective()), float(blocked.objective())
    assert abs(z1 - zb) <= 1e-4 * max(abs(z1), 1.0)


def test_auto_engine_solves_a_blocked_size_lp_on_the_gpu(gpu):
    """320x640 is past the blocked threshold: the f32 auto path must land
    the f64 solve's objective at the parity bar."""
    sf = bench.bench_standard_form(320, 320, seed=2)
    f32 = solve_lp(sf, dtype=jnp.float32)
    f64 = solve_lp(sf, dtype=jnp.float64)
    assert f32.status == f64.status == "optimal"
    assert abs(float(f32.objective) - float(f64.objective)) <= 1e-9 * max(
        abs(float(f64.objective)), 1.0)
    assert jax.devices()[0].platform == "gpu"
