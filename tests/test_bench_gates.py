"""The bench's captured correctness gates (bench.py), unit-tested on CPU.

These functions make every bench line a correctness artifact as well as a
measurement: ``verify_terminal_basis`` flags walks that break primal
feasibility on the original data (it caught the old infeasible-start bench
instance), and the compiled pins' strong-duality certificates are exercised
here on the CPU; the bench and ``tests/test_gpu.py`` apply the same pins
to the executable compiled for the GPU."""

import numpy as np
import pytest

import jax.numpy as jnp

import bench
from tpulp.core import SolverOptions, Status
from tpulp.solve import run_simplex


def test_bench_instance_is_canonically_feasible():
    """The timed instance must be a valid canonical start: b >= 0 under the
    claimed slack basis (the r2 instance could start infeasible)."""
    st = bench.make_bench_state(64, 48, jnp.float32, seed=0)
    b = np.asarray(st.T[2:, -1])
    assert (b >= 0).all()
    assert int(st.phase) == 2  # full slack basis, no artificials


def test_verify_terminal_basis_accepts_a_real_walk():
    m, n = 24, 16
    st = bench.make_bench_state(m, n, jnp.float64, seed=3, bounded=True)
    out = run_simplex(st, SolverOptions.for_dtype(jnp.float64,
                                                  max_iters=500))
    assert int(out.status) == Status.OPTIMAL
    # must not raise
    bench.verify_terminal_basis(out, m, n, seed=3, dtype_name="float64",
                                bounded=True)


def test_verify_terminal_basis_rejects_a_corrupted_basis():
    m, n = 24, 16
    st = bench.make_bench_state(m, n, jnp.float64, seed=3, bounded=True)
    out = run_simplex(st, SolverOptions.for_dtype(jnp.float64,
                                                  max_iters=500))
    # corrupt the claimed basis: point every row at column 0 (singular /
    # infeasible solve) -> the gate must fail loudly, not pass silently
    bad = out._replace(basis=jnp.zeros_like(out.basis))
    with pytest.raises((AssertionError, np.linalg.LinAlgError)):
        bench.verify_terminal_basis(bad, m, n, seed=3, dtype_name="float64",
                                    bounded=True)


def test_compiled_pin_suite_on_jnp_driver():
    """All five pins (Dantzig/Bland/devex/deep-phase-1/degenerate) with
    their strong-duality certificates, on the blocked driver (the same
    suite every bench run applies on the GPU)."""
    results = bench.compiled_pin_suite()
    assert len(results) == 5
    assert all(r["ok"] for r in results)
    names = {r["pin"] for r in results}
    assert names == {"random64_dantzig", "random24_bland", "random64_devex",
                     "eqheavy_phase1", "degenerate_ties"}
    # the certificate proves optimality: primal + dual feasible everywhere
    for r in results:
        assert r["min_xb"] >= -1e-7
        assert r["min_reduced_cost"] >= -1e-6


def test_pin_certificate_rejects_non_optimal_basis():
    """_basis_certificate must fail a basis that is not optimal (the f32
    false-verdict class): the slack basis of the pin instance violates
    primal feasibility and/or dual feasibility, and the certificate says
    so — exactly what a wrongly-converged compiled walk would trip on."""
    st, Af, b, cf = bench._pin_instances()[0][1](jnp.float64)
    slack_basis = list(range(Af.shape[1] - st.m, Af.shape[1]))
    z, min_xb, min_rc = bench._basis_certificate(slack_basis, Af, b, cf)
    assert not (min_xb >= -1e-7 and min_rc >= -1e-6), (min_xb, min_rc)


def test_device_peaks_resolve_for_the_h100():
    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["hbm_bytes_per_s"] == 3.35e12
    assert peaks["f32_flops_per_s"] == 67e12
    assert peaks["tf32_flops_per_s"] == 495e12


def test_device_peaks_refuse_an_unknown_device():
    with pytest.raises(KeyError, match="no published peaks"):
        bench.device_peaks("Unlisted Accelerator 9000")
