"""Sharded solver on the virtual 8-device CPU mesh (the fake cluster):
both the GSPMD-annotated path and the explicit shard_map collective path
must match the single-device driver exactly (same pivots, same statuses)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpulp import LinExpr, LinProg
from tpulp.core import SolverOptions, Status
from tpulp.shard import (
    from_sharded_state,
    make_mesh,
    run_simplex_gspmd,
    run_simplex_sharded,
    run_simplex_sharded_blocked,
    shard_state,
    to_sharded_state,
)
from tpulp.solve import run_simplex, state_from_standard_form
from tpulp.solve.blocked import run_simplex_blocked


def textbook_lp():
    lp = LinProg()
    lp.addVar("x1")
    lp.addVar("x2")
    lp.maximize(LinExpr(40, "x1", 30, "x2"))
    lp.addConstraint(LinExpr(1, "x1", 1, "x2").constraintLeq(12))
    lp.addConstraint(LinExpr(2, "x1", 1, "x2").constraintLeq(16))
    return lp


def phase1_lp():
    lp = LinProg()
    lp.addVar("x")
    lp.addVar("y")
    lp.minimize(LinExpr(2, "x", 3, "y"))
    lp.addConstraint(LinExpr(1, "x", 1, "y").constraintGeq(4))
    lp.addConstraint(LinExpr(1, "x", -1, "y").constraintEq(0))
    return lp


def random_dense_state(seed, m=24, n=48):
    """Random canonical-form LP (slack identity basis) as a device state."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    x0 = np.abs(rng.normal(size=n))
    b = A @ x0 + np.abs(rng.normal(size=m))  # slack room -> feasible
    c = rng.normal(size=n)
    from tpulp.core import make_state

    Afull = np.concatenate([A, np.eye(m)], axis=1)
    cfull = np.concatenate([c, np.zeros(m)])
    hint = list(range(n, n + m))
    return make_state(cfull, Afull, b, hint, dtype=jnp.float64)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return make_mesh(8)


class TestGspmd:
    def test_textbook(self, mesh):
        sf = textbook_lp().lower()
        st = state_from_standard_form(sf)
        out = run_simplex_gspmd(shard_state(st, mesh), mesh)
        assert int(out.status) == Status.OPTIMAL
        assert abs(float(out.objective()) - (-400)) < 1e-9

    def test_random_matches_single(self, mesh):
        st = random_dense_state(0)
        ref = run_simplex(st)
        out = run_simplex_gspmd(shard_state(st, mesh), mesh)
        assert int(out.status) == int(ref.status)
        assert abs(float(out.objective()) - float(ref.objective())) < 1e-8
        assert int(out.niter) == int(ref.niter)


class TestShardMap:
    def test_textbook(self, mesh):
        sf = textbook_lp().lower()
        st = state_from_standard_form(sf)
        sh = to_sharded_state(st, mesh)
        out_sh = run_simplex_sharded(sh, mesh)
        out = from_sharded_state(out_sh, st.n)
        assert int(out.status) == Status.OPTIMAL
        assert abs(float(out.objective()) - (-400)) < 1e-9

    def test_phase1_transition(self, mesh):
        sf = phase1_lp().lower()
        st = state_from_standard_form(sf)
        out_sh = run_simplex_sharded(to_sharded_state(st, mesh), mesh)
        out = from_sharded_state(out_sh, st.n)
        assert int(out.status) == Status.OPTIMAL
        assert abs(float(out.objective()) - 10) < 1e-9

    def test_statuses(self, mesh):
        inf_lp = LinProg()
        inf_lp.addVar("x")
        inf_lp.minimize(LinExpr(1, "x"))
        inf_lp.addConstraint(LinExpr(1, "x").constraintLeq(1))
        inf_lp.addConstraint(LinExpr(1, "x").constraintGeq(3))
        st = state_from_standard_form(inf_lp.lower())
        out = run_simplex_sharded(to_sharded_state(st, mesh), mesh)
        assert int(out.status) == Status.INFEASIBLE

        unb_lp = LinProg()
        unb_lp.addVar("x")
        unb_lp.minimize(LinExpr(-1, "x"))
        unb_lp.addConstraint(LinExpr(1, "x").constraintGeq(1))
        st2 = state_from_standard_form(unb_lp.lower())
        out2 = run_simplex_sharded(to_sharded_state(st2, mesh), mesh)
        assert int(out2.status) == Status.UNBOUNDED

    @pytest.mark.parametrize("seed", [1, 2, 3])
    def test_random_exact_pivot_parity(self, mesh, seed):
        """The sharded driver must take the SAME pivot sequence as the
        single-device driver (identical pricing/ratio decisions), hence
        identical iteration counts and bit-close objectives."""
        st = random_dense_state(seed)
        ref = run_simplex(st)
        out_sh = run_simplex_sharded(to_sharded_state(st, mesh), mesh)
        out = from_sharded_state(out_sh, st.n)
        assert int(out.status) == int(ref.status)
        assert int(out.niter) == int(ref.niter)
        assert abs(float(out.objective()) - float(ref.objective())) < 1e-8
        assert np.array_equal(np.asarray(out.basis), np.asarray(ref.basis))

    def test_poisoned_state_reports_numeric(self, mesh):
        """Mirror of tests/test_numeric_guard.py for the sharded driver: a
        NaN in an active pricing entry must read NUMERIC, never a bogus
        OPTIMAL (the failure class the guard exists for)."""
        st = random_dense_state(5)
        st = st._replace(T=st.T.at[0, 0].set(jnp.nan))
        opts = SolverOptions.for_dtype(st.T.dtype, max_iters=50)
        out_sh = run_simplex_sharded(to_sharded_state(st, mesh), mesh, opts)
        assert int(out_sh.status) == Status.NUMERIC

    def test_poisoned_rhs_reports_numeric(self, mesh):
        st = random_dense_state(6)
        st = st._replace(T=st.T.at[4, -1].set(jnp.nan))
        opts = SolverOptions.for_dtype(st.T.dtype, max_iters=50)
        out_sh = run_simplex_sharded(to_sharded_state(st, mesh), mesh, opts)
        assert int(out_sh.status) == Status.NUMERIC

    def test_mesh_sizes(self):
        # sharding must work for any divisor mesh, including size 1
        st = random_dense_state(4, m=10, n=21)
        ref = run_simplex(st)
        for p in [1, 2, 4]:
            mesh = make_mesh(p)
            out_sh = run_simplex_sharded(to_sharded_state(st, mesh), mesh)
            out = from_sharded_state(out_sh, st.n)
            assert int(out.status) == int(ref.status), p
            assert abs(float(out.objective()) - float(ref.objective())) < 1e-8


class TestShardedBlocked:
    """Sharded rank-K eta-block driver (VERDICT r1 item 3): must walk the
    SAME pivot sequence as the single-device blocked driver — local eta
    slices per shard, one fused (m+2+K) psum per pivot, one local rank-K
    flush per block."""

    def test_textbook(self, mesh):
        sf = textbook_lp().lower()
        st = state_from_standard_form(sf)
        out_sh = run_simplex_sharded_blocked(
            to_sharded_state(st, mesh), mesh, block=8)
        out = from_sharded_state(out_sh, st.n)
        assert int(out.status) == Status.OPTIMAL
        assert abs(float(out.objective()) - (-400)) < 1e-9

    def test_phase1_transition(self, mesh):
        sf = phase1_lp().lower()
        st = state_from_standard_form(sf)
        out_sh = run_simplex_sharded_blocked(
            to_sharded_state(st, mesh), mesh, block=8)
        out = from_sharded_state(out_sh, st.n)
        assert int(out.status) == Status.OPTIMAL
        assert abs(float(out.objective()) - 10) < 1e-9

    @pytest.mark.parametrize("seed", [1, 2, 3])
    @pytest.mark.parametrize("block", [8, 32])
    def test_pivot_parity_vs_blocked(self, mesh, seed, block):
        """Identical basis sequence / iteration count vs run_simplex_blocked
        at the same K (the parity bar the VERDICT set for this driver)."""
        st = random_dense_state(seed)
        ref = run_simplex_blocked(st, block=block)
        out_sh = run_simplex_sharded_blocked(
            to_sharded_state(st, mesh), mesh, block=block)
        out = from_sharded_state(out_sh, st.n)
        assert int(out.status) == int(ref.status)
        assert int(out.niter) == int(ref.niter)
        assert abs(float(out.objective()) - float(ref.objective())) < 1e-7
        assert np.array_equal(np.asarray(out.basis), np.asarray(ref.basis))

    def test_statuses(self, mesh):
        inf_lp = LinProg()
        inf_lp.addVar("x")
        inf_lp.minimize(LinExpr(1, "x"))
        inf_lp.addConstraint(LinExpr(1, "x").constraintLeq(1))
        inf_lp.addConstraint(LinExpr(1, "x").constraintGeq(3))
        st = state_from_standard_form(inf_lp.lower())
        out = run_simplex_sharded_blocked(
            to_sharded_state(st, mesh), mesh, block=8)
        assert int(out.status) == Status.INFEASIBLE

        unb_lp = LinProg()
        unb_lp.addVar("x")
        unb_lp.minimize(LinExpr(-1, "x"))
        unb_lp.addConstraint(LinExpr(1, "x").constraintGeq(1))
        st2 = state_from_standard_form(unb_lp.lower())
        out2 = run_simplex_sharded_blocked(
            to_sharded_state(st2, mesh), mesh, block=8)
        assert int(out2.status) == Status.UNBOUNDED

    def test_poisoned_state_reports_numeric(self, mesh):
        st = random_dense_state(5)
        st = st._replace(T=st.T.at[0, 0].set(jnp.nan))
        opts = SolverOptions.for_dtype(st.T.dtype, max_iters=50)
        out_sh = run_simplex_sharded_blocked(
            to_sharded_state(st, mesh), mesh, opts, block=8)
        assert int(out_sh.status) == Status.NUMERIC

    def test_mesh_sizes(self):
        st = random_dense_state(4, m=10, n=21)
        ref = run_simplex_blocked(st, block=8)
        for p in [1, 2, 4]:
            mesh = make_mesh(p)
            out_sh = run_simplex_sharded_blocked(
                to_sharded_state(st, mesh), mesh, block=8)
            out = from_sharded_state(out_sh, st.n)
            assert int(out.status) == int(ref.status), p
            assert abs(float(out.objective()) - float(ref.objective())) < 1e-8


class TestBatchGspmd2D:
    """FULL solve under the 2D (batch, cols) GSPMD layout — round-1 weak
    item 7: the dryrun only ran one step at 2D; this pins lane-wise parity
    of the complete batched solve against the single-device driver."""

    def test_full_solve_matches_single(self):
        from jax.sharding import Mesh
        from tpulp.batch import stack_states
        from tpulp.shard.sharded import run_simplex_batch_gspmd

        devs = np.array(jax.devices()[:8]).reshape(2, 4)
        mesh2d = Mesh(devs, ("batch", "cols"))
        # width must divide the cols axis: m=10, n=21 -> n_tot+1 = 32
        states = [random_dense_state(s, m=10, n=21) for s in range(4)]
        refs = [run_simplex(st) for st in states]
        batched = stack_states(states)
        out = run_simplex_batch_gspmd(batched, mesh2d)
        for k, ref in enumerate(refs):
            assert int(out.status[k]) == int(ref.status), k
            assert int(out.niter[k]) == int(ref.niter), k
            z = float(-out.T[k, 0, -1])
            assert abs(z - float(ref.objective())) < 1e-8, k
            assert np.array_equal(np.asarray(out.basis[k]),
                                  np.asarray(ref.basis)), k


class TestHybridMesh:
    """(hosts, cols) hybrid layout: the column dimension split host-major
    over BOTH mesh axes (tuple axis names through every collective) — the
    multi-host form where intra-host collectives ride NVLink and only the
    final reductions cross the network."""

    def _bounded_state(self, seed=1, m=24, n=48):
        rng = np.random.default_rng(seed)
        A = rng.normal(size=(m, n))
        x0 = np.abs(rng.normal(size=n))
        b = A @ x0 + np.abs(rng.normal(size=m))
        c = rng.normal(size=n)
        A[-1] = 1.0
        b[-1] = 2.0 * x0.sum()  # bounded polytope: OPTIMAL guaranteed
        from tpulp.core import make_state

        Afull = np.concatenate([A, np.eye(m)], axis=1)
        cfull = np.concatenate([c, np.zeros(m)])
        return make_state(cfull, Afull, b, list(range(n, n + m)),
                          dtype=jnp.float64)

    def test_rank1_pivot_parity(self):
        from jax.sharding import Mesh

        st = self._bounded_state()
        ref = run_simplex(st)
        mesh2d = Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                      ("hosts", "cols"))
        ax = ("hosts", "cols")
        out = from_sharded_state(
            run_simplex_sharded(to_sharded_state(st, mesh2d, axis=ax),
                                mesh2d, axis=ax), st.n)
        assert int(out.status) == Status.OPTIMAL == int(ref.status)
        assert int(out.niter) == int(ref.niter)
        assert np.array_equal(np.asarray(out.basis), np.asarray(ref.basis))
        assert abs(float(out.objective()) - float(ref.objective())) < 1e-8

    def test_blocked_matches_flat_mesh(self):
        from jax.sharding import Mesh

        st = self._bounded_state(seed=2)
        mesh2d = Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                      ("hosts", "cols"))
        ax = ("hosts", "cols")
        out2d = from_sharded_state(
            run_simplex_sharded_blocked(
                to_sharded_state(st, mesh2d, axis=ax), mesh2d, block=8,
                axis=ax), st.n)
        flat = make_mesh(8)
        outf = from_sharded_state(
            run_simplex_sharded_blocked(
                to_sharded_state(st, flat), flat, block=8), st.n)
        assert int(out2d.status) == int(outf.status)
        assert int(out2d.niter) == int(outf.niter)
        assert np.array_equal(np.asarray(out2d.basis),
                              np.asarray(outf.basis))


class TestShardedBlockedDevex:
    """Devex pricing on the column-partitioned eta driver (VERDICT r3 item
    3): gamma is sharded like the tableau columns, gamma_q rides the fused
    per-pivot psum, and the walk pins against the single-device blocked
    RULE_DEVEX driver."""

    def _devex_opts(self, dtype=jnp.float64, **kw):
        import dataclasses

        from tpulp.core import RULE_DEVEX

        return dataclasses.replace(
            SolverOptions.for_dtype(dtype, **kw), rule=RULE_DEVEX)

    @pytest.mark.parametrize("seed", [1, 2, 3])
    @pytest.mark.parametrize("block", [8, 32])
    def test_pivot_parity_vs_blocked_devex(self, mesh, seed, block):
        st = random_dense_state(seed)
        opts = self._devex_opts()
        ref = run_simplex_blocked(st, opts, block=block)
        out_sh = run_simplex_sharded_blocked(
            to_sharded_state(st, mesh), mesh, opts, block=block)
        out = from_sharded_state(out_sh, st.n)
        assert int(out.status) == int(ref.status)
        assert int(out.niter) == int(ref.niter)
        assert abs(float(out.objective()) - float(ref.objective())) < 1e-7
        assert np.array_equal(np.asarray(out.basis), np.asarray(ref.basis))

    def test_equality_heavy_fewer_pivots_than_dantzig(self, mesh):
        from tpulp.corpus import get_case

        case = get_case("equality_heavy_24")
        st = state_from_standard_form(case.lp().lower())
        dz = run_simplex_sharded_blocked(
            to_sharded_state(st, mesh), mesh, block=8)
        dv = run_simplex_sharded_blocked(
            to_sharded_state(st, mesh), mesh, self._devex_opts(), block=8)
        assert int(dz.status) == int(dv.status) == Status.OPTIMAL
        assert int(dv.niter) < int(dz.niter)

    def test_solve_lp_mesh_devex(self, mesh):
        """pricing='devex' through the one-call mesh path."""
        from tpulp.corpus import get_case
        from tpulp.solve import solve_lp

        case = get_case("equality_heavy_24")
        sol = solve_lp(case.lp(), mesh=mesh, pricing="devex")
        assert sol.status == "optimal"
        assert sol.objective == case.objective

    def test_mesh_devex_requires_blocked(self, mesh):
        from tpulp.solve import solve_lp

        with pytest.raises(ValueError, match="blocked"):
            solve_lp(textbook_lp(), mesh=mesh, pricing="devex",
                     shard_driver="rank1")


class TestShardedBounded:
    """Sharded bounded-variable driver (round 4): spans in the ratio test
    on the column-partitioned layout, pinned against the SOLO bounded
    driver's exact walk."""

    def _solo_and_sharded(self, mesh, lp, max_iters=1000):
        from tpulp.solve.bounded import (make_bounded_state,
                                         run_simplex_bounded)
        from tpulp.shard import (from_sharded_bounded_state,
                                 run_simplex_sharded_bounded,
                                 to_sharded_bounded_state)

        sf = lp.lower(simple_bounds=True)
        st = state_from_standard_form(sf)
        opts = SolverOptions.for_dtype(st.T.dtype, max_iters=max_iters)
        solo = run_simplex_bounded(make_bounded_state(st, sf.upper), opts)
        sb = to_sharded_bounded_state(
            make_bounded_state(state_from_standard_form(sf), sf.upper),
            mesh)
        out = from_sharded_bounded_state(
            run_simplex_sharded_bounded(sb, mesh, opts), st.n)
        return solo, out

    def test_box_lp_exact_walk_parity(self, mesh):
        lp = LinProg()
        lp.addVar("x", lb=0, ub=4)
        lp.addVar("y", lb=0, ub=3)
        lp.maximize(LinExpr(3, "x", 2, "y"))
        lp.addConstraint(LinExpr(1, "x", 1, "y").constraintLeq(5))
        solo, out = self._solo_and_sharded(mesh, lp)
        assert int(out.s.status) == int(solo.s.status) == Status.OPTIMAL
        assert int(out.s.niter) == int(solo.s.niter)
        assert np.array_equal(np.asarray(out.s.basis),
                              np.asarray(solo.s.basis))
        assert np.array_equal(np.asarray(out.at_upper),
                              np.asarray(solo.at_upper))
        assert abs(float(out.s.objective()) + 14) < 1e-9  # min form of 14

    @pytest.mark.parametrize("seed", [1, 2, 3, 4])
    def test_random_box_walk_parity(self, mesh, seed):
        rng = np.random.default_rng(seed)
        nv, mc = 6, 4
        lp = LinProg()
        obj = LinExpr()
        for jv in range(nv):
            lp.addVar(f"v{jv}", lb=0, ub=int(rng.integers(1, 9)))
            obj += LinExpr(int(rng.integers(-9, 10)), f"v{jv}")
        lp.maximize(obj)
        for i in range(mc):
            e = LinExpr()
            for jv in range(nv):
                e += LinExpr(int(rng.integers(-3, 6)), f"v{jv}")
            lp.addConstraint(e.constraintLeq(int(rng.integers(5, 30))))
        solo, out = self._solo_and_sharded(mesh, lp)
        assert int(out.s.status) == int(solo.s.status), seed
        assert int(out.s.niter) == int(solo.s.niter), seed
        assert np.array_equal(np.asarray(out.s.basis),
                              np.asarray(solo.s.basis)), seed
        assert np.array_equal(np.asarray(out.at_upper),
                              np.asarray(solo.at_upper)), seed

    def test_pure_flip_solution(self, mesh):
        # max x, x <= 2 with slack bound only: solo solves by ONE flip
        lp = LinProg()
        lp.addVar("x", lb=0, ub=2)
        lp.maximize(LinExpr(1, "x"))
        lp.addConstraint(LinExpr(1, "x").constraintLeq(10))
        solo, out = self._solo_and_sharded(mesh, lp)
        assert int(out.s.status) == Status.OPTIMAL
        assert int(out.s.niter) == int(solo.s.niter)
        assert bool(np.asarray(out.at_upper)[0])  # x nonbasic at upper

    def test_solve_lp_mesh_simple_bounds_end_to_end(self, mesh):
        from tpulp.solve import solve_lp

        lp = LinProg()
        lp.addVar("x", lb=0, ub=4)
        lp.addVar("y", lb=0, ub=3)
        lp.maximize(LinExpr(3, "x", 2, "y"))
        lp.addConstraint(LinExpr(1, "x", 1, "y").constraintLeq(5))
        sol = solve_lp(lp, mesh=mesh, simple_bounds=True)
        assert sol.status == "optimal" and sol.objective == 14
        # spans produced NO rows even on the mesh path
        assert lp.lower(simple_bounds=True).m == 1

    def test_statuses(self, mesh):
        from tpulp.solve import solve_lp

        inf_lp = LinProg()
        inf_lp.addVar("x", lb=0, ub=5)
        inf_lp.minimize(LinExpr(1, "x"))
        inf_lp.addConstraint(LinExpr(1, "x").constraintGeq(9))
        assert solve_lp(inf_lp, mesh=mesh,
                        simple_bounds=True).status == "infeasible"
        unb = LinProg()
        unb.addVar("x", lb=0, ub=5)
        unb.addVar("free", lb=0)
        unb.maximize(LinExpr(1, "x", 1, "free"))
        unb.addConstraint(LinExpr(1, "x").constraintLeq(4))
        assert solve_lp(unb, mesh=mesh,
                        simple_bounds=True).status == "unbounded"
