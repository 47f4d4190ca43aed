"""Netlib-style corpus parity: every device driver x every corpus case.

The parity bar (BASELINE.md): relative objective gap <= 1e-9 vs the exact
oracle — here it is EXACT equality, because every driver's final basis is
refined by the exact rational solve (tpulp/solve/refine.py). Statuses must
match too (infeasible/unbounded certificates).

Oracle technique follows the reference's golden-LP approach
(/root/reference/lpsol/test_tableau.py:7-29) scaled up: analytic optima by
strong duality / brute force where the instance is too big for the exact
host simplex, host-simplex-pinned optima elsewhere (verified in
tpulp/corpus.py's registry).
"""

from fractions import Fraction as F

import numpy as np
import pytest

import jax.numpy as jnp

from tpulp.core import SolverOptions, Status
from tpulp.corpus import CASES, get_case
from tpulp.model.prog import MAX
from tpulp.shard import (
    from_sharded_state,
    make_mesh,
    run_simplex_sharded,
    to_sharded_state,
)
from tpulp.solve import (
    run_simplex,
    run_simplex_blocked,
    solve_standard_form,
    state_from_standard_form,
)
from tpulp.solve.refine import refine_basis_solution

# the 8-way sharded driver and the small-block runs are much slower per
# pivot on the CPU test backend; cap their instance size (the big instances
# still run through rank-1 + blocked here, and on the GPU via
# bench.py --mode corpus)
SMALL = [c for c in CASES if c.size_hint <= 96]
CASE_IDS = [c.name for c in CASES]
SMALL_IDS = [c.name for c in SMALL]
# the blocked driver serves every large tableau: K=32 on every case, and
# K=16 on the small ones, which crosses many more flush boundaries
BLOCKED_RUNS = ([pytest.param(c, 32, id=c.name) for c in CASES]
                + [pytest.param(c, 16, id=f"{c.name}-K16") for c in SMALL])


def _refined(sf, out):
    status = Status.NAMES[int(out.status)]
    if status != "optimal":
        return status, None
    basis = [int(j) for j in np.asarray(out.basis)]
    vals, zmin = refine_basis_solution(sf, basis, mode="exact")
    for v in vals.values():
        assert v >= -F(1, 10**6), "refined basis infeasible"
    return status, (-zmin if sf.sense == MAX else zmin)


def _check(case, status, obj):
    assert status == case.status, (case.name, status)
    if case.status == "optimal":
        assert obj == case.objective, (case.name, obj, case.objective)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_rank1_driver(case):
    sf = case.lp().lower()
    st = state_from_standard_form(sf)
    out = run_simplex(st, SolverOptions.for_dtype(
        st.T.dtype, max_iters=case.max_iters))
    _check(case, *_refined(sf, out))


@pytest.mark.parametrize("case,block", BLOCKED_RUNS)
def test_blocked_driver(case, block):
    sf = case.lp().lower()
    st = state_from_standard_form(sf)
    out = run_simplex_blocked(
        st, SolverOptions.for_dtype(st.T.dtype, max_iters=case.max_iters),
        block=block)
    _check(case, *_refined(sf, out))


@pytest.mark.parametrize("case", SMALL, ids=SMALL_IDS)
def test_sharded_driver(case):
    import jax

    assert len(jax.devices()) >= 8
    mesh = make_mesh(8)
    sf = case.lp().lower()
    st = state_from_standard_form(sf)
    out_sh = run_simplex_sharded(
        to_sharded_state(st, mesh), mesh,
        SolverOptions.for_dtype(st.T.dtype, max_iters=case.max_iters))
    out = from_sharded_state(out_sh, st.n)
    _check(case, *_refined(sf, out))


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_solve_api(case):
    """The user-facing path (precision ladder + refinement) on every case."""
    from tpulp.solve import solve_lp

    sol = solve_lp(case.lp().lower(), max_iters=case.max_iters)
    assert sol.status == case.status, (case.name, sol.status)
    if case.status == "optimal":
        assert sol.objective == case.objective


@pytest.mark.parametrize(
    "case", [c for c in CASES if c.oracle == "host"],
    ids=[c.name for c in CASES if c.oracle == "host"])
def test_host_oracle_values_are_honest(case):
    """The pinned 'host' optima must re-derive from the exact host simplex
    (guards against registry drift when a generator changes)."""
    from tpulp.solve.api import solve_standard_form_host

    sol = solve_standard_form_host(case.lp().lower())
    assert sol.status == case.status
    if case.status == "optimal":
        assert sol.objective == case.objective


def test_batch_corpus():
    """All optimal corpus cases solved in ONE vmapped device call."""
    from tpulp.batch import solve_lp_batch

    cases = [c for c in CASES
             if c.status == "optimal" and c.size_hint <= 96]
    sols = solve_lp_batch([c.lp().lower() for c in cases])
    for c, sol in zip(cases, sols):
        assert sol.status == "optimal", (c.name, sol.status)
        assert sol.objective == c.objective, (c.name, sol.objective)


# sharded rank-K: full corpus sweep (VERDICT r2 item 7). The 256-row case is
# capped out of the CPU suite like the other per-pivot-slow backends.
@pytest.mark.parametrize("case", SMALL, ids=SMALL_IDS)
def test_sharded_blocked_driver(case):
    import jax

    from tpulp.shard import run_simplex_sharded_blocked

    assert len(jax.devices()) >= 8
    mesh = make_mesh(8)
    sf = case.lp().lower()
    st = state_from_standard_form(sf)
    out_sh = run_simplex_sharded_blocked(
        to_sharded_state(st, mesh), mesh,
        SolverOptions.for_dtype(st.T.dtype, max_iters=case.max_iters),
        block=16)
    out = from_sharded_state(out_sh, st.n)
    _check(case, *_refined(sf, out))


@pytest.mark.parametrize("case", SMALL, ids=SMALL_IDS)
def test_solve_api_sharded(case):
    """One-call sharded solve: solve_lp(..., mesh=...) shards, solves with
    the rank-K SPMD driver, gathers, refines and certifies (VERDICT r2
    item 7: the sharded path is now reachable from the public API)."""
    from tpulp.solve import solve_lp

    mesh = make_mesh(8)
    sol = solve_lp(case.lp().lower(), max_iters=case.max_iters, mesh=mesh,
                   shard_block=16)
    assert sol.status == case.status, (case.name, sol.status)
    if case.status == "optimal":
        assert sol.objective == case.objective
