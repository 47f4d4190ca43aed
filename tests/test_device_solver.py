"""Device (JAX) two-phase simplex: status coverage, parity vs the exact host
oracle, refinement modes, predicates, and randomized property tests.

Runs on CPU (x64) via conftest; the same code path runs on the GPU in bench.py."""

from fractions import Fraction as F

import numpy as np
import pytest

import jax.numpy as jnp

from tpulp import LinExpr, LinProg, LinVar, Simplex, Tableau
from tpulp.core import (
    RULE_BLAND,
    SolverOptions,
    Status,
    is_canonical,
    is_degenerate,
    is_optimal,
    make_state,
)
from tpulp.solve import (
    extract_solution,
    run_simplex,
    solve_lp,
    state_from_standard_form,
)


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


class TestEndToEnd:
    def test_textbook_exact_parity(self):
        sol = solve_lp(textbook_lp())
        assert sol.status == "optimal"
        assert sol.objective == 400          # exact Fraction via refinement
        assert sol.x == {"x1": 4, "x2": 8}
        assert sol.niter >= 1

    def test_beale_anticycling(self):
        sol = solve_lp(beale_lp())
        assert sol.status == "optimal"
        assert sol.objective == F(-1, 20)

    def test_bland_rule(self):
        sol = solve_lp(beale_lp(), rule=RULE_BLAND)
        assert sol.status == "optimal"
        assert sol.objective == F(-1, 20)

    def test_infeasible(self):
        lp = LinProg()
        lp.addVar("x")
        lp.minimize(LinExpr(1, "x"))
        lp.addConstraint(LinExpr(1, "x").constraintLeq(1))
        lp.addConstraint(LinExpr(1, "x").constraintGeq(3))
        assert solve_lp(lp).status == "infeasible"

    def test_unbounded(self):
        lp = LinProg()
        lp.addVar("x")
        lp.minimize(LinExpr(-1, "x"))
        lp.addConstraint(LinExpr(1, "x").constraintGeq(1))
        assert solve_lp(lp).status == "unbounded"

    def test_iteration_limit(self):
        sol = solve_lp(beale_lp(), max_iters=1)
        assert sol.status == "iteration_limit"

    def test_phase1_equalities_and_redundancy(self):
        lp = LinProg()
        lp.addVar("x")
        lp.addVar("y")
        lp.minimize(LinExpr(2, "x", 3, "y"))
        lp.addConstraint(LinExpr(1, "x", 1, "y").constraintGeq(4))
        lp.addConstraint(LinExpr(1, "x", -1, "y").constraintEq(0))
        lp.addConstraint(LinExpr(2, "x", 2, "y").constraintGeq(8))  # dependent
        sol = solve_lp(lp)
        assert sol.status == "optimal"
        assert sol.objective == 10
        assert sol.x == {"x": 2, "y": 2}

    def test_trivially_infeasible_short_circuit(self):
        lp = LinProg()
        lp.addVar("x", lb=5, ub=2)
        lp.minimize(LinExpr(1, "x"))
        assert solve_lp(lp).status == "infeasible"

    def test_free_and_boxed_vars(self):
        lp = LinProg()
        lp.addVariable(LinVar("f"))             # free
        lp.addVar("b", lb=1, ub=3)
        lp.minimize(LinExpr(1, "f", 1, "b"))
        lp.addConstraint(LinExpr(1, "f").constraintGeq(-10))
        sol = solve_lp(lp)
        assert sol.status == "optimal"
        assert sol.objective == -9
        assert sol.x == {"f": -10, "b": 1}

    def test_float32_iterates_exact_refinement(self):
        # f32 on-device iterates + exact final-basis solve -> exact objective
        sol = solve_lp(textbook_lp(), dtype=jnp.float32, refine="exact")
        assert sol.status == "optimal"
        assert sol.objective == 400

    def test_refine_none_and_float64(self):
        s_none = solve_lp(textbook_lp(), refine="none")
        assert s_none.status == "optimal"
        assert abs(s_none.objective - 400) < 1e-6
        s_f64 = solve_lp(textbook_lp(), refine="float64")
        assert abs(s_f64.objective - 400) < 1e-9

    def test_maximization_sense_reported(self):
        lp = LinProg()
        lp.addVar("x", ub=7)
        lp.maximize(LinExpr(3, "x", 1))
        sol = solve_lp(lp)
        assert sol.objective == 22
        # internal min form is the negated objective
        assert sol.objective_min == -22


class TestStateAndPredicates:
    def test_make_state_slack_basis_starts_phase2(self):
        sf = textbook_lp().lower()
        st = state_from_standard_form(sf)
        assert int(st.phase) == 2
        assert bool(is_canonical(st))
        assert not bool(is_optimal(st))

    def test_make_state_artificials_start_phase1(self):
        lp = LinProg()
        lp.addVar("x")
        lp.minimize(LinExpr(1, "x"))
        lp.addConstraint(LinExpr(1, "x").constraintGeq(3))
        st = state_from_standard_form(lp.lower())
        assert int(st.phase) == 1
        assert bool(jnp.any(st.art_cols))
        assert bool(is_canonical(st))  # artificial basis is canonical

    def test_solved_state_predicates(self):
        sf = textbook_lp().lower()
        st = run_simplex(state_from_standard_form(sf))
        assert int(st.status) == Status.OPTIMAL
        assert bool(is_optimal(st))
        assert bool(is_canonical(st))
        x, z = extract_solution(st)
        assert abs(float(z) - (-400)) < 1e-9
        assert np.allclose(np.asarray(x)[:2], [4, 8])

    def test_degenerate_predicate(self):
        lp = LinProg()
        lp.addVar("x")
        lp.addVar("y")
        lp.maximize(LinExpr(1, "x", 1, "y"))
        lp.addConstraint(LinExpr(1, "x").constraintLeq(0))
        lp.addConstraint(LinExpr(1, "x", 1, "y").constraintLeq(2))
        st = state_from_standard_form(lp.lower())
        assert bool(is_degenerate(st))

    def test_padded_artificials_shape(self):
        sf = textbook_lp().lower()
        st0 = state_from_standard_form(sf)
        st2 = state_from_standard_form(sf, n_extra_art=2)
        assert st2.n == st0.n + 2
        out = run_simplex(st2)
        assert int(out.status) == Status.OPTIMAL
        assert abs(float(out.objective()) - (-400)) < 1e-9


class TestRandomParity:
    """Property test: device f64 + exact refinement matches the exact-rational
    host oracle on random integer-data LPs (SURVEY.md §4 test plan)."""

    @pytest.mark.parametrize("seed", range(12))
    def test_random_feasible_lp(self, seed):
        rng = np.random.default_rng(seed)
        m, n = 8, 13
        A = rng.integers(-4, 5, size=(m, n))
        x0 = rng.integers(0, 4, size=n)          # known feasible point
        b = A @ x0
        c = rng.integers(-5, 6, size=n)
        comps = rng.choice(["<=", ">=", "=="], size=m)

        lp = LinProg()
        for j in range(n):
            lp.addVar(f"x{j}")
        lp.minimize(
            sum((LinExpr(int(c[j]), f"x{j}") for j in range(n)), LinExpr()))
        for i in range(m):
            expr = sum(
                (LinExpr(int(A[i, j]), f"x{j}") for j in range(n)), LinExpr())
            lp.addConstraint(
                {"<=": expr.constraintLeq, ">=": expr.constraintGeq,
                 "==": expr.constraintEq}[comps[i]](int(b[i])))

        sf = lp.lower()
        # oracle
        tab = Tableau.fromArrays(sf.c, sf.A, sf.b, names=sf.col_names)
        sx = Simplex(tab, on_infeasible="status")
        oracle_status = (
            "infeasible" if sx.getStatus() is not None else sx.solve().value)
        # device
        sol = solve_lp(sf, refine="exact",
                       options=SolverOptions(max_iters=2000))
        assert sol.status == oracle_status, f"seed {seed}"
        if oracle_status == "optimal":
            assert sol.objective_min == sx.getObjValue() + sf.obj_const, \
                f"seed {seed}"


class TestDriverAutoSelect:
    """solve_lp(driver=...): the public API reaches every single-device
    engine, and 'auto' routes big tableaus off the rank-1 path."""

    def _big_sf(self, seed=0):
        import numpy as np

        from tpulp import LinExpr, LinProg

        rng = np.random.default_rng(seed)
        m, nv = 60, 40
        lp = LinProg()
        obj = LinExpr()
        for j in range(nv):
            lp.addVar(f"v{j}", lb=0)
            obj += LinExpr(int(rng.integers(-9, 10)), f"v{j}")
        lp.maximize(obj)
        for i in range(m):
            e = LinExpr()
            for j in range(nv):
                e += LinExpr(int(rng.integers(0, 5)), f"v{j}")
            lp.addConstraint(e.constraintLeq(int(rng.integers(40, 200))))
        return lp.lower()

    def test_all_engines_agree(self):
        from tpulp.solve import solve_lp

        sf = self._big_sf()
        sols = {d: solve_lp(sf, driver=d, block=16)
                for d in ("rank1", "blocked", "auto")}
        ref = sols["rank1"]
        assert ref.status == "optimal"
        for d, s in sols.items():
            assert s.status == "optimal", d
            assert s.objective == ref.objective, d

    def test_unknown_driver_rejected(self):
        import pytest

        from tpulp.solve import solve_lp

        with pytest.raises(ValueError):
            solve_lp(self._big_sf(), driver="warp")
