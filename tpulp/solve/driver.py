"""Jitted two-phase simplex driver: one ``lax.while_loop`` state machine.

Device-first redesign of the reference's solver loop (simplex.py:110-148) and
phase-1 orchestration (simplex.py:36-108). The entire two-phase algorithm —
pricing, ratio test, pivot, Bland anti-cycling switch, phase transition,
termination — is a single compiled loop over a static-shape
``SimplexState``; there is no host round-trip per pivot. ``vmap`` of
``simplex_step``/``run_simplex`` over a leading axis is the batched solver
(``tpulp.batch``), and the same step logic re-appears column-sharded in
``tpulp.shard``.

Algorithmic contract (matching the reference's observable behavior, with its
bugs fixed — SURVEY.md §2.7):

* Dantzig pricing (most-negative reduced cost, first index on ties) with a
  PERMANENT switch to Bland's rule after ``stall_limit`` consecutive pivots
  that fail to improve the CURRENT objective value.
* Bland mode: first improving column; smallest basic-variable index among
  min-ratio tie rows (the combination with termination guarantee).
* Status reporting, never asserts: optimal / unbounded / infeasible /
  iteration_limit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from ..core.state import (
    RULE_BLAND,
    RULE_MAX_INCREASE,
    TIE_MAXPIV,
    SimplexState,
    SolverOptions,
    Status,
)

__all__ = [
    "simplex_step",
    "run_simplex",
    "extract_solution",
    "pivot_update",
    "find_pivot_all",
]


def pivot_update(T: jax.Array, r_glob: jax.Array, j: jax.Array) -> jax.Array:
    """Gauss-Jordan rank-1 pivot on global row ``r_glob``, column ``j``.

    ``T <- T - T[:, j] (x) (T[r]/piv)``; the pivot row is the normalized
    original and column ``j`` is snapped to an exact unit vector to stop
    float drift (the device analogue of exact cancellation in the rational
    reference, tableau.py:295-308).
    """
    piv = T[r_glob, j]
    prow = T[r_glob, :] * (1.0 / piv)
    colv = T[:, j]
    nrows, ncols = T.shape
    is_r = (jnp.arange(nrows) == r_glob)[:, None]
    is_j = (jnp.arange(ncols) == j)[None, :]
    # one fused elementwise pass: eliminate, overwrite the pivot row with the
    # normalized row, snap column j to the exact unit vector (no
    # dynamic-update-slice, so XLA fuses everything into a single read+write
    # of the tableau)
    Tn = T - colv[:, None] * prow[None, :]
    Tn = jnp.where(is_r, prow[None, :], Tn)
    Tn = jnp.where(is_j, is_r.astype(T.dtype), Tn)
    return Tn


def simplex_step(state: SimplexState, opts: SolverOptions,
                 stall_limit: int) -> SimplexState:
    """One transition of the solver state machine — fully BRANCHLESS.

    Every iteration performs exactly one unconditional ``pivot_update``; all
    control flow lives in scalars. When no real pivot should happen (terminal
    state, phase transition, dependent cleanup row) the update is redirected
    to the exact no-op pivot ``(row 0, basis[0])``: a basic column is an
    exact unit vector (entering columns are snapped on every pivot), so
    pivoting on it reproduces the tableau bit-for-bit.

    Why branchless: a ``lax.cond`` whose branches carry the (m+2)x(n+1)
    tableau costs a full-tableau copy on the untaken side (and under vmap
    BOTH branches execute every iteration). Measured on a 4096x8192 f32
    tableau this restructure is what moves the per-pivot cost toward the
    single read+write HBM bound.

    The end-of-phase-1 artificial drive-out (see git history for the
    motivation: zero-value basic artificials grow when an entering column
    has a negative entry in their row) is folded into the same uniform
    iteration: in phase 2, while any basic artificial remains, the iteration
    pivots it out on the first active column with a nonzero entry in its row
    (feasibility-preserving because that row's RHS is 0); a row with no such
    entry is linearly dependent and its artificial is reclassified as
    permanently-inactive structural (cleared from ``art_cols`` — it can
    never be priced because ``col_active`` already excludes it)."""
    T = state.T
    dtype = T.dtype
    n = state.n
    inf = jnp.asarray(jnp.inf, dtype)
    running = state.status == Status.RUNNING

    # ---- cleanup scan: basic artificials still in the basis (phase 2) -----
    art_basic = state.art_cols[state.basis]           # (m,) bool
    in_phase2 = state.phase == 2
    cleanup = jnp.any(art_basic) & in_phase2
    r_d = jnp.argmax(art_basic).astype(jnp.int32)     # first such row
    row_d = T[2 + r_d, :-1]
    elig = state.col_active & ~state.art_cols & (jnp.abs(row_d) > opts.piv_tol)
    has_elig = jnp.any(elig)
    col_ids = jnp.arange(n, dtype=jnp.int32)
    j_d = jnp.min(jnp.where(elig, col_ids, n - 1)).astype(jnp.int32)
    # dependent row: retire its artificial so the scan never re-selects it
    retire = cleanup & ~has_elig & running
    art_cols = jnp.where(
        retire,
        state.art_cols.at[state.basis[r_d]].set(False),
        state.art_cols,
    )

    # ---- pricing ----------------------------------------------------------
    crow = jnp.where(state.phase == 1, T[1, :-1], T[0, :-1])
    c_eff = jnp.where(state.col_active, crow, inf)
    improving = c_eff < -opts.opt_tol
    has_improving = jnp.any(improving)
    use_bland = state.bland | (opts.rule == RULE_BLAND)
    j_dantzig = jnp.argmin(c_eff).astype(jnp.int32)
    j_bland = jnp.min(jnp.where(improving, col_ids, n - 1)).astype(jnp.int32)
    if opts.rule == RULE_MAX_INCREASE:
        # greatest-improvement pricing (device form of the reference's
        # findPivotMaxIncrease, simplex.py:286-328): one full-tableau pass
        # computes every column's min ratio; decrease_j = -c_j * ratio_j.
        # An improving column with NO positive entry certifies unboundedness
        # -> give it +inf decrease so it is selected and the ratio test
        # reports unbounded this very pivot (the reference does the same).
        # opts.rule is static, so other rules never pay this scan.
        Ablock = T[2:, :-1]
        bcol = T[2:, -1]
        posA = Ablock > opts.piv_tol
        ratA = jnp.where(posA, bcol[:, None] / jnp.where(posA, Ablock, 1.0),
                         inf)
        ratio_j = jnp.min(ratA, axis=0)                       # (n,)
        dec = jnp.where(
            improving,
            jnp.where(ratio_j < inf, -c_eff * ratio_j, inf),
            -inf)
        j_maxinc = jnp.argmax(dec).astype(jnp.int32)
        j_price = jnp.where(use_bland, j_bland, j_maxinc)
    else:
        j_price = jnp.where(use_bland, j_bland, j_dantzig)

    # ---- phase bookkeeping scalars ----------------------------------------
    z1 = -T[1, -1]
    phase1_done = (state.phase == 1) & ~has_improving & running
    became_infeasible = phase1_done & (z1 > opts.infeas_tol)
    to_phase2 = phase1_done & ~became_infeasible
    pricing_pivot = has_improving & ~cleanup & ~phase1_done

    # ---- entering column + ratio test -------------------------------------
    j = jnp.where(cleanup, j_d, j_price)
    col = T[2:, j]
    b = T[2:, -1]
    pos = col > opts.piv_tol
    has_ratio = jnp.any(pos)
    ratios = jnp.where(pos, b / jnp.where(pos, col, 1.0), inf)
    min_ratio = jnp.min(ratios)
    tie = ratios <= min_ratio
    if opts.tie_break == TIE_MAXPIV:
        # stabilized tie resolution: among min-ratio rows take the LARGEST
        # pivot element (partial-pivoting flavor — bounds the 1/piv growth
        # factor on deep float walks; see SolverOptions.tie_break)
        r_first = jnp.argmax(jnp.where(tie, col, -inf)).astype(jnp.int32)
    else:
        r_first = jnp.argmax(tie).astype(jnp.int32)
    r_bland = jnp.argmin(
        jnp.where(tie, state.basis, jnp.int32(2**30))).astype(jnp.int32)
    r_price = jnp.where(use_bland, r_bland, r_first)

    became_unbounded = pricing_pivot & ~has_ratio & in_phase2
    # phase 1 is bounded below by 0: no-ratio there means numerical failure;
    # report infeasible conservatively
    became_failed1 = pricing_pivot & ~has_ratio & ~in_phase2

    # ---- the one pivot ----------------------------------------------------
    do_cleanup = cleanup & has_elig & running
    do_pricing = pricing_pivot & has_ratio & running
    do_pivot = do_cleanup | do_pricing
    r = jnp.where(do_cleanup, r_d, r_price)
    r_eff = jnp.where(do_pivot, r + 2, 2)
    j_eff = jnp.where(do_pivot, j, state.basis[0])
    Tn = pivot_update(T, r_eff, j_eff)

    basis = jnp.where(do_pivot, state.basis.at[r].set(j), state.basis)

    # ---- stall / Bland switch (pricing pivots only; fix of SURVEY §2.7-2:
    # compare against the CURRENT objective, not a stale snapshot) ----------
    z = jnp.where(state.phase == 1, -Tn[1, -1], -Tn[0, -1])
    improved = (state.last_z - z) > opts.degen_tol
    stuck = jnp.where(
        do_pricing,
        jnp.where(improved, 0, state.stuck + 1),
        state.stuck,
    ).astype(jnp.int32)
    last_z = jnp.where(do_pricing, z, state.last_z)
    bland = state.bland | (stuck >= stall_limit)

    # ---- phase transition + termination (all scalar selects) --------------
    phase = jnp.where(to_phase2, 2, state.phase).astype(jnp.int32)
    col_active = jnp.where(to_phase2, state.col_active & ~art_cols,
                           state.col_active)
    stuck = jnp.where(to_phase2, 0, stuck)
    last_z = jnp.where(to_phase2, inf, last_z)

    finished_opt = in_phase2 & ~has_improving & ~cleanup
    # Non-finite guard: a f32 blowup poisons pricing with NaN (NaN < -tol is
    # False), which would otherwise read as "no improving column" -> a bogus
    # OPTIMAL. Check the pricing row actually driving this step's decision,
    # the post-pivot objective, and the post-pivot RHS; any NaN/inf ->
    # NUMERIC so callers can retry at higher precision.
    finite_ok = (
        jnp.isfinite(z)
        & jnp.isfinite(jnp.sum(jnp.abs(Tn[2:, -1])))
        & jnp.isfinite(jnp.sum(jnp.where(state.col_active, jnp.abs(crow), 0.0)))
    )
    new_status = jnp.where(
        ~finite_ok, jnp.int32(Status.NUMERIC),
        jnp.where(
            became_infeasible | became_failed1, jnp.int32(Status.INFEASIBLE),
            jnp.where(became_unbounded, jnp.int32(Status.UNBOUNDED),
                      jnp.where(finished_opt, jnp.int32(Status.OPTIMAL),
                                jnp.int32(Status.RUNNING)))))
    status = jnp.where(running, new_status, state.status)

    return SimplexState(
        T=Tn,
        basis=basis,
        col_active=col_active,
        art_cols=art_cols,
        phase=phase,
        status=status,
        niter=state.niter + do_pivot.astype(jnp.int32),
        stuck=stuck,
        bland=bland,
        last_z=last_z,
    )


@functools.lru_cache(maxsize=64)
def _compiled_driver(opts: SolverOptions, stall_limit: int):
    """Compiled driver keyed on everything EXCEPT the pivot budget:
    ``max_iters`` is a traced operand, so changing the budget (the common
    case for benchmarking and incremental solving) reuses the executable
    instead of compiling anew. Callers pass
    ``_budget_key(opts)`` so the cache key is budget-independent."""

    @jax.jit
    def driver(state: SimplexState, max_iters: jax.Array) -> SimplexState:
        def cond(s):
            return (s.status == Status.RUNNING) & (s.niter < max_iters)

        def body(s):
            # simplex_step is internally frozen for terminal lanes (its
            # pivot becomes an exact no-op and every mutation is guarded on
            # status==RUNNING), so vmapped lanes that finish early coast
            return simplex_step(s, opts, stall_limit)

        out = lax.while_loop(cond, body, state)
        hit_limit = (out.status == Status.RUNNING)
        return out._replace(
            status=jnp.where(
                hit_limit, jnp.int32(Status.ITERATION_LIMIT), out.status))

    return driver


def _budget_key(opts: SolverOptions) -> SolverOptions:
    """Normalize away the traced pivot budget for executable caching."""
    import dataclasses

    return dataclasses.replace(opts, max_iters=0)


def run_simplex(state: SimplexState, opts: SolverOptions | None = None
                ) -> SimplexState:
    """Run the jitted driver to termination (single problem)."""
    if opts is None:
        opts = SolverOptions.for_dtype(state.T.dtype)
    stall_limit = opts.resolved_stall_limit(state.m, state.n)
    driver = _compiled_driver(_budget_key(opts), stall_limit)
    return driver(state, jnp.asarray(opts.max_iters, jnp.int32))


def find_pivot_all(state: SimplexState, opts: SolverOptions | None = None
                   ) -> jax.Array:
    """(m, n) bool mask of EVERY feasibility-preserving pivot: entry (i, j)
    is True iff pivoting there keeps b >= 0 — i.e. column j's positive
    entries' min-ratio tie set. Device form of the reference's teaching /
    degeneracy-exploration tool ``findPivotAll``
    (/root/reference/lpsol/simplex.py:330-360), computed in one vectorized
    pass instead of a per-column scan. Inactive columns are all-False."""
    if opts is None:
        opts = SolverOptions.for_dtype(state.T.dtype)
    T = state.T
    inf = jnp.asarray(jnp.inf, T.dtype)
    Ablock = T[2:, :-1]
    b = T[2:, -1]
    pos = Ablock > opts.piv_tol
    rat = jnp.where(pos, b[:, None] / jnp.where(pos, Ablock, 1.0), inf)
    min_ratio = jnp.min(rat, axis=0)                          # (n,)
    mask = pos & (rat <= min_ratio[None, :]) & (min_ratio[None, :] < inf)
    return mask & state.col_active[None, :]


def extract_solution(state: SimplexState):
    """(x, z): primal column values and phase-2 objective (min sense).

    ``x`` scatters the RHS through the basis; nonbasic columns are 0."""
    n = state.n
    b = state.T[2:, -1]
    x = jnp.zeros((n,), dtype=state.T.dtype).at[state.basis].set(b)
    return x, state.objective()
