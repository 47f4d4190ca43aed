"""Numeric-failure detection and the precision-ladder fallback.

A f32 blowup poisons pricing with NaN; NaN < -tol is False, which an unguarded
driver reads as "no improving column" and reports a bogus OPTIMAL (a 512x512
dense f32 instance 'converged' to z = nan). Every driver must
instead report Status.NUMERIC, and solve_standard_form must escalate
f32 -> f64 -> exact host simplex.
"""

from fractions import Fraction as F

import numpy as np
import pytest

import jax.numpy as jnp

from tpulp.core import SolverOptions, Status, make_state
from tpulp.model.lower import lower_to_standard_form
from tpulp.solve import run_simplex, solve_standard_form
from tpulp.solve.api import solve_standard_form_host
from tpulp.solve.blocked import run_simplex_blocked


def _phase2_state(dtype=jnp.float32, m=4, n=6, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    x0 = np.abs(rng.normal(size=n))
    b = A @ x0 + np.abs(rng.normal(size=m))
    c = rng.normal(size=n)
    Afull = np.concatenate([A, np.eye(m)], axis=1)
    cfull = np.concatenate([c, np.zeros(m)])
    hint = list(range(n, n + m))
    return make_state(cfull, Afull, b, hint, dtype=dtype)


def _poison(state):
    """NaN in an active pricing-row entry (column 0 is structural/active)."""
    return state._replace(T=state.T.at[0, 0].set(jnp.nan))


class TestDriverNumericStatus:
    def test_rank1_driver_reports_numeric(self):
        out = run_simplex(_poison(_phase2_state()),
                          SolverOptions.for_dtype(jnp.float32, max_iters=50))
        assert int(out.status) == Status.NUMERIC

    def test_blocked_driver_reports_numeric(self):
        out = run_simplex_blocked(
            _poison(_phase2_state()),
            SolverOptions.for_dtype(jnp.float32, max_iters=50), block=8)
        assert int(out.status) == Status.NUMERIC

    def test_nan_rhs_reports_numeric(self):
        state = _phase2_state()
        state = state._replace(T=state.T.at[3, -1].set(jnp.nan))
        out = run_simplex(state,
                          SolverOptions.for_dtype(jnp.float32, max_iters=50))
        assert int(out.status) == Status.NUMERIC

    def test_clean_state_still_optimal(self):
        out = run_simplex(_phase2_state(),
                          SolverOptions.for_dtype(jnp.float32, max_iters=500))
        assert int(out.status) == Status.OPTIMAL


def _textbook():
    from tpulp import LinExpr, LinProg

    lp = LinProg()
    lp.addVar("x1")
    lp.addVar("x2")
    lp.maximize(LinExpr(40, "x1", 30, "x2"))
    lp.addConstraint(LinExpr(1, "x1", 1, "x2").constraintLeq(12))
    lp.addConstraint(LinExpr(2, "x1", 1, "x2").constraintLeq(16))
    return lower_to_standard_form(lp)


class TestFallbackLadder:
    def test_host_exact_solver(self):
        sol = solve_standard_form_host(_textbook())
        assert sol.status == "optimal"
        assert sol.objective == 400
        assert sol.x == {"x1": 4, "x2": 8}

    def test_numeric_escalates_to_host(self, monkeypatch):
        """Force the device solve to report NUMERIC: the API must fall
        through the ladder and still return the exact optimum."""
        import tpulp.solve.api as api

        real = api.run_simplex

        def fake(state, options):
            out = real(state, options)
            return out._replace(status=jnp.asarray(Status.NUMERIC, jnp.int32))

        monkeypatch.setattr(api, "run_simplex", fake)
        sol = solve_standard_form(_textbook(), dtype=jnp.float64)
        assert sol.status == "optimal"
        assert sol.objective == 400

    def test_fallback_none_reports_error(self, monkeypatch):
        import tpulp.solve.api as api

        real = api.run_simplex

        def fake(state, options):
            out = real(state, options)
            return out._replace(status=jnp.asarray(Status.NUMERIC, jnp.int32))

        monkeypatch.setattr(api, "run_simplex", fake)
        sol = solve_standard_form(_textbook(), dtype=jnp.float64,
                                  fallback="none")
        assert sol.status == "numerical_error"

    def test_f32_retry_reaches_f64(self, monkeypatch):
        """An f32-only failure retries on the f64 REFRESHED device rung
        (round 5: the ladder's middle rung is the periodic-refactorization
        driver, tpulp.solve.refresh) and succeeds without reaching the
        host solver."""
        import tpulp.solve.api as api
        import tpulp.solve.refresh as refresh_mod

        real = api.run_simplex
        calls = []

        def fake(state, options):
            calls.append(state.T.dtype)
            out = real(state, options)
            if state.T.dtype == jnp.dtype(np.float32):
                return out._replace(
                    status=jnp.asarray(Status.NUMERIC, jnp.int32))
            return out

        monkeypatch.setattr(api, "run_simplex", fake)

        refreshed_dtypes = []
        real_refreshed = refresh_mod.run_simplex_refreshed

        def spy(c, A, b, hint, opts=None, dtype=None, **kw):
            refreshed_dtypes.append(jnp.zeros((), dtype).dtype)
            return real_refreshed(c, A, b, hint, opts, dtype=dtype, **kw)

        monkeypatch.setattr(refresh_mod, "run_simplex_refreshed", spy)
        sol = solve_standard_form(_textbook(), dtype=jnp.float32)
        assert sol.status == "optimal"
        assert sol.objective == 400
        # the first (failing) attempt ran f32 on the plain driver; the
        # retry went through the refreshed rung at f64, not the host
        assert calls == [jnp.dtype(np.float32)]
        assert refreshed_dtypes == [jnp.dtype(np.float64)]
