"""Periodic tableau refactorization: the production answer to float drift.

The reference solver keeps the tableau exact through every pivot
(/root/reference/lpsol/tableau.py:295-308 — all ``Fraction``s), so depth
never degrades it. The float device substitute accumulates rank-1 update
roundoff: dense random-normal equality systems at 512 rows can end phase 1
with the artificial objective stuck above tolerance even at f64 — a FALSE
infeasible. Production float simplex codes bound that drift by
refactorizing the basis from original data every ~100 pivots; this module
is the tableau-form equivalent, architected for the device driver:

* the device runs the compiled ``lax.while_loop`` driver in SEGMENTS of
  ``segment`` pivots (no per-pivot host round trip — the host touches the
  state only at segment boundaries);
* between segments the host rebuilds the ENTIRE tableau from the original
  (un-drifted) data over the current basis — one ``m x m`` LU solve
  against ``[A | b]`` in float64, microseconds at these sizes — and snaps
  basic columns to exact unit vectors;
* terminal verdicts (optimal / infeasible / unbounded) are never accepted
  from drifted data: the driver refreshes and RESUMES once, and only a
  verdict that re-derives from freshly-factorized data with no further
  pivots is reported. A phase-1 "infeasible" whose refreshed artificial
  objective is actually ~0 simply continues into phase 2.

Combined with the stabilized ratio-test tie-break
(``SolverOptions.tie_break = TIE_MAXPIV``: largest pivot element among
min-ratio ties, bounding the 1/pivot growth factor), this is the engine
``solve_standard_form`` escalates to before leaving the device for the
exact-rational host rung.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..core.state import (SimplexState, SolverOptions, Status, TIE_MAXPIV,
                          canonical_dtype, make_state)

__all__ = ["refresh_tableau", "run_simplex_refreshed", "stabilized_options"]


def stabilized_options(opts: SolverOptions) -> SolverOptions:
    """``opts`` with the growth-bounding ratio tie-break enabled."""
    return dataclasses.replace(opts, tie_break=TIE_MAXPIV)


def refresh_tableau(
    T0: np.ndarray,
    basis: np.ndarray,
    art0: np.ndarray,
    feas_tol: float = 1e-6,
) -> Optional[np.ndarray]:
    """Rebuild the canonical tableau over ``basis`` from original data.

    ``T0`` is the INITIAL (m+2, n+1) tableau from ``make_state`` — row 0
    the raw objective ``[c | 0]``, rows 2+ the raw ``[A_full | b]`` (slack
    and artificial columns included). Returns the refreshed tableau
    (float64): rows 2+ are ``B^-1 [A | b]`` with basic columns snapped to
    exact units, row 0 the reduced costs ``c - c_B B^-1 A`` (corner
    ``-z2``), row 1 the phase-1 reduced costs over the original artificial
    cost vector ``art0`` (corner ``-z1``).

    Small negative basic values (|.| <= ``feas_tol`` * scale) are drift and
    are clamped to 0; a larger violation means the float walk genuinely
    lost primal feasibility — returns ``None`` (as does a singular basis).
    ``feas_tol=None`` clamps ANY negative basic value (Harris-style bound
    shifting): the right mode for f32 engines, whose deep phase-1 walks
    transiently carry ~1e-3..3e-1 violations while still making real
    progress (measured on the 1024x2048 family). The perturbation cannot
    accumulate — every refresh re-derives from the ORIGINAL data, and
    terminal verdicts/certificates are anchored there too.
    """
    m = T0.shape[0] - 2
    T0 = np.asarray(T0, dtype=np.float64)
    basis = np.asarray(basis)
    Ab = T0[2:, :]
    B = Ab[:, basis]
    try:
        X = np.linalg.solve(B, Ab)
    except np.linalg.LinAlgError:
        return None
    if not np.all(np.isfinite(X)):
        return None
    rows = np.arange(m)
    X[:, basis] = 0.0
    X[rows, basis[rows]] = 1.0
    bcol = X[:, -1]
    if feas_tol is not None:
        scale = 1.0 + float(np.max(np.abs(T0[2:, -1]), initial=0.0))
        bad = bcol < -feas_tol * scale
        if np.any(bad):
            return None
    np.clip(bcol, 0.0, None, out=bcol)
    c = T0[0, :]
    c1 = np.concatenate([np.where(np.asarray(art0), 1.0, 0.0), [0.0]])
    row0 = c - c[basis] @ X
    row1 = c1 - c1[basis] @ X
    row0[basis] = 0.0
    row1[basis] = 0.0
    Tn = np.empty_like(T0)
    Tn[0] = row0
    Tn[1] = row1
    Tn[2:] = X
    return Tn


def _resume_state(base: SimplexState, T_np: np.ndarray,
                  dtype) -> SimplexState:
    inf = np.asarray(np.inf, dtype=np.dtype(jnp.zeros((), dtype).dtype))
    return base._replace(
        T=jnp.asarray(T_np, dtype=dtype),
        status=jnp.asarray(Status.RUNNING, jnp.int32),
        stuck=jnp.asarray(0, jnp.int32),
        last_z=jnp.asarray(inf, dtype=dtype),
    )


def run_simplex_refreshed(
    c,
    A,
    b,
    basis_hint,
    opts: Optional[SolverOptions] = None,
    dtype=jnp.float64,
    segment: int = 512,
    engine: str = "rank1",
    block: int = 64,
) -> SimplexState:
    """Two-phase simplex with periodic refactorization (see module doc).

    Terminates with a verdict that was RE-DERIVED from freshly refactorized
    data (or iteration_limit / a numerical_error the refresh could not
    repair). ``engine``: 'rank1' or 'blocked' for the per-segment device
    driver. The returned state's ``niter`` counts pivots across all
    segments.
    """
    from .driver import run_simplex

    dtype = canonical_dtype(dtype)
    if opts is None:
        opts = SolverOptions.for_dtype(dtype)
    opts = stabilized_options(opts)
    state = make_state(c, A, b, basis_hint, dtype=dtype)
    T0 = np.asarray(state.T, np.float64)
    art0 = np.asarray(state.art_cols).copy()
    budget = opts.max_iters
    segment = max(1, min(segment, budget))
    # f32 engines: clamp-all (Harris-style bound shifting) — their deep
    # walks transiently violate feasibility by far more than drift
    # tolerances while still progressing; f64 keeps the tight gate
    clamp_tol = None if dtype == jnp.dtype(np.float32) \
        else max(opts.feas_tol, 1e-7)

    def run_seg(s, target):
        # ``niter`` is absolute and carried across resumes; the drivers'
        # budget compare is ``niter < max_iters``, so targets are absolute
        seg_opts = dataclasses.replace(opts, max_iters=target)
        if engine == "blocked":
            from .blocked import run_simplex_blocked

            return run_simplex_blocked(s, seg_opts, block=block)
        return run_simplex(s, seg_opts)

    total = 0
    last_claim = None  # (status, total_pivots) at the previous verdict
    verdict_refreshes = 0
    while True:
        out = run_seg(state, min(total + segment, budget))
        total = int(out.niter)
        st = int(out.status)
        if st == Status.ITERATION_LIMIT and total < budget:
            # segment cap, not the real budget: refresh and continue
            Tn = refresh_tableau(T0, np.asarray(out.basis), art0,
                                 feas_tol=clamp_tol)
            if Tn is None:
                return out._replace(
                    status=jnp.asarray(Status.NUMERIC, jnp.int32))
            state = _resume_state(out, Tn, dtype)
            continue
        if st == Status.ITERATION_LIMIT:
            return out
        # terminal claim (optimal/infeasible/unbounded/numeric): only accept
        # a verdict that re-derives from fresh data with no further pivots
        claim = (st, total)
        if last_claim == claim or verdict_refreshes >= 8:
            return out
        verdict_refreshes += 1
        Tn = refresh_tableau(T0, np.asarray(out.basis), art0,
                             feas_tol=clamp_tol)
        if Tn is None:
            # unrepairable basis: report NUMERIC so the ladder escalates
            return out._replace(
                status=jnp.asarray(Status.NUMERIC, jnp.int32))
        last_claim = claim
        state = _resume_state(out, Tn, dtype)
