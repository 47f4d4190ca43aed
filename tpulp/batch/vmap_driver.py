"""Batched (vmapped) simplex: solve many independent LPs in one compiled call.

The reference solves exactly one LP at a time (SURVEY.md §2.8); this layer is
new capability mandated by BASELINE.json config 3 ("vmap over 1k+ independent
random dense LPs per chip") and is the engine under MILP branch-and-bound
(``tpulp.milp``): every B&B frontier wave is one batched solve.

Design: ``SimplexState`` is a pytree, so the batched solver is literally
``vmap(single-problem driver)`` with a leading problem axis on every leaf.
The driver's loop body freezes terminated lanes, so lanes with divergent
pivot counts coexist in one ``while_loop`` (the wall clock is the slowest
lane's pivot count). Problems of different shapes are padded to a common
static shape: zero rows get their own unit "pad slack" basic column, extra
columns are priced-inactive, and padded artificial columns keep phase-1
shapes uniform.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..core.state import SimplexState, SolverOptions, Status, make_state
from ..model.lower import StandardForm, lower_to_standard_form
from ..model.prog import LinProg
from ..solve.api import Solution, solve_standard_form
from ..solve.driver import _compiled_driver
from ..solve.refine import refine_basis_solution

__all__ = [
    "stack_states",
    "unstack_state",
    "make_batched_states",
    "make_batched_bounded_states",
    "run_simplex_batch",
    "solve_lp_batch",
    "extract_batch_solutions",
    "extract_batch_bounded_solutions",
]


def stack_states(states: Sequence[SimplexState]) -> SimplexState:
    """Stack same-shape states along a new leading problem axis."""
    return jax.tree.map(lambda *xs: jnp.stack(xs, axis=0), *states)


def unstack_state(batched: SimplexState, i: int) -> SimplexState:
    """Extract problem ``i`` from a batched state."""
    return jax.tree.map(lambda x: x[i], batched)


def _padded_arrays(sf: StandardForm, m_max: int, n_base: int):
    """Pad one problem's dense arrays to (m_max, n_base) non-artificial
    columns: zero rows each get a fresh unit basic column (a 'pad slack'),
    extra columns stay zero/costless."""
    c, A, b, hint = *sf.to_dense(np.float64), list(sf.basis_hint)
    m, n = A.shape
    pad_rows = m_max - m
    cp = np.zeros((n_base,))
    cp[:n] = c
    Ap = np.zeros((m_max, n_base))
    Ap[:m, :n] = A
    bp = np.zeros((m_max,))
    bp[:m] = b
    for k in range(pad_rows):
        Ap[m + k, n + k] = 1.0  # pad slack
        hint.append(n + k)
    return cp, Ap, bp, hint


def make_batched_states(
    sfs: Sequence[StandardForm],
    dtype=jnp.float64,
    return_host_art: bool = False,
) -> SimplexState:
    """Lower a list of StandardForms to ONE batched state of uniform shape.

    simple_bounds lowerings are rejected here — the batched driver has no
    bounded ratio test and silently ignoring the spans would return wrong
    answers; callers materialize the bounds into rows first
    (``materialize_simple_bounds``, done by ``solve_lp_batch``).

    ``return_host_art=True`` also returns the host numpy copy of the
    batched ``art_cols`` as ``(state, art_cols_np)`` — the data exists on
    host during assembly anyway, and fetching it back off the device
    costs a blocking host round trip (tpulp.milp reads it once per
    solve)."""
    if not sfs:
        raise ValueError("empty batch")
    if any(sf.upper is not None and any(u is not None for u in sf.upper)
           for sf in sfs):
        raise ValueError(
            "batched solving needs row-based bounds: materialize "
            "simple_bounds lowerings first (model.lower."
            "materialize_simple_bounds)")
    dims = []
    for sf in sfs:
        n_art = sum(1 for h in sf.basis_hint if h < 0)
        dims.append((sf.m, sf.n, n_art))
    m_max = max(d[0] for d in dims)
    n_base = max(d[1] + (m_max - d[0]) for d in dims)
    art_max = max(d[2] for d in dims)

    states = []
    for sf, (m, n, n_art) in zip(sfs, dims):
        cp, Ap, bp, hint = _padded_arrays(sf, m_max, n_base)
        st = make_state(cp, Ap, bp, hint, dtype=dtype,
                        n_extra_art=art_max - n_art, _numpy=True)
        states.append(st)
    # stack on host, ONE device transfer per leaf (eager per-state transfers
    # measured as a dominant cost of B&B wave setup)
    stacked = jax.tree.map(lambda *xs: np.stack(xs, axis=0), *states)
    dev = jax.tree.map(jnp.asarray, stacked)
    if return_host_art:
        return dev, np.asarray(stacked.art_cols)
    return dev


def make_batched_bounded_states(
    sfs: Sequence[StandardForm],
    dtype=jnp.float64,
):
    """Batched BoundedState from simple_bounds lowerings (VERDICT r3 item
    6): the span vectors are padded alongside the tableaus — structural
    columns carry their finite spans, pad slacks / extra columns /
    artificials get +inf (never flip)."""
    from ..solve.bounded import BoundedState

    plain = [dataclasses.replace(sf, upper=None) for sf in sfs]
    batched = make_batched_states(plain, dtype=dtype)
    n_batched = batched.T.shape[2] - 1
    uppers = np.full((len(sfs), n_batched), np.inf)
    for k, sf in enumerate(sfs):
        if sf.upper is None:
            continue
        for j, u in enumerate(sf.upper):
            if u is not None:
                uppers[k, j] = float(u)
    return BoundedState(
        s=batched,
        upper=jnp.asarray(uppers, batched.T.dtype),
        at_upper=jnp.zeros((len(sfs), n_batched), jnp.bool_),
    )


def extract_batch_bounded_solutions(sfs: Sequence[StandardForm], bout,
                                    refine: str) -> List[Solution]:
    """One Solution per StandardForm from a terminal batched BoundedState:
    basis columns are remapped to each problem's own space like the
    unbounded extractor, then refined/certified through the bounded
    pipeline (nonbasic-at-upper columns sit exactly at their spans)."""
    from ..model.prog import MAX
    from ..solve.refine import (bounded_basis_certificate,
                                float_bounded_certificate,
                                refine_bounded_basis)

    out = bout.s
    statuses = np.asarray(out.status)
    niters = np.asarray(out.niter)
    bases = np.asarray(out.basis)
    art_cols_np = np.asarray(out.art_cols)
    at_upper_np = np.asarray(bout.at_upper)
    results: List[Solution] = []
    for k, sf in enumerate(sfs):
        status = Status.NAMES.get(int(statuses[k]), "unknown")
        if status != "optimal":
            results.append(Solution(status=status, niter=int(niters[k])))
            continue
        lane_art = art_cols_np[k]
        n_batched = lane_art.shape[0]
        art_start = int(lane_art.argmax()) if bool(lane_art.any()) \
            else n_batched
        remapped = []
        for j in (int(v) for v in bases[k][:sf.m]):
            if j < sf.n:
                remapped.append(j)
            elif j >= art_start:
                remapped.append(sf.n + (j - art_start))
            else:
                remapped.append(j)
        # structural columns coincide in [0, sf.n); pads/artificials carry
        # infinite spans and are never at-upper
        at_up = at_upper_np[k]
        mode = "float64" if refine == "none" else refine
        try:
            col_values, z_min = refine_bounded_basis(
                sf, remapped, at_up, mode=mode)
            if sf.m <= 192:
                primal_ok, dual_ok = bounded_basis_certificate(
                    sf, remapped, at_up)
            else:
                primal_ok, dual_ok = float_bounded_certificate(
                    sf, remapped, at_up)
        except (ZeroDivisionError, np.linalg.LinAlgError):
            results.append(Solution(status="numerical_error",
                                    niter=int(niters[k])))
            continue
        if not (primal_ok and dual_ok):
            results.append(Solution(status="numerical_error",
                                    niter=int(niters[k])))
            continue
        from fractions import Fraction

        def colval(j):
            return col_values.get(j, Fraction(0))

        x = {}
        for name, (terms, const) in sf.recover.items():
            v = const
            for col, coeff in terms:
                v = v + coeff * colval(col)
            x[name] = v
        obj = -z_min if sf.sense == MAX else z_min
        results.append(Solution(
            status="optimal", objective=obj, x=x, niter=int(niters[k]),
            objective_min=z_min, col_values=dict(col_values),
            basis=remapped))
    return results


def pad_batched_columns(batched: SimplexState, multiple: int) -> SimplexState:
    """Pad the batched tableau WIDTH (n+1) to a multiple of ``multiple``
    with pricing-inactive zero columns inserted before the RHS column —
    the GSPMD cols-axis divisibility requirement
    (``shard.run_simplex_batch_gspmd``). Padded columns are never priced
    (col_active False) and never basic, so walks are unchanged."""
    width = batched.T.shape[2]
    pad = (-width) % multiple
    if pad == 0:
        return batched
    B, M, _ = batched.T.shape
    T = jnp.concatenate(
        [batched.T[:, :, :-1],
         jnp.zeros((B, M, pad), batched.T.dtype),
         batched.T[:, :, -1:]], axis=2)
    fmask = jnp.zeros((B, pad), dtype=bool)
    return batched._replace(
        T=T,
        col_active=jnp.concatenate([batched.col_active, fmask], axis=1),
        art_cols=jnp.concatenate([batched.art_cols, fmask], axis=1),
    )


@functools.lru_cache(maxsize=32)
def _batched_driver(opts: SolverOptions, stall_limit: int):
    single = _compiled_driver.__wrapped__(opts, stall_limit)
    return jax.jit(jax.vmap(single, in_axes=(0, None)))


def run_simplex_batch(
    batched: SimplexState,
    opts: SolverOptions | None = None,
) -> SimplexState:
    """Run the vmapped driver to termination of every lane."""
    if opts is None:
        opts = SolverOptions.for_dtype(batched.T.dtype)
    from ..solve.driver import _budget_key
    m = batched.T.shape[1] - 2
    n = batched.T.shape[2] - 1
    stall_limit = opts.resolved_stall_limit(m, n)
    driver = _batched_driver(_budget_key(opts), stall_limit)
    return driver(batched, jnp.asarray(opts.max_iters, jnp.int32))


def solve_lp_batch(
    progs: Sequence[Union[LinProg, StandardForm]],
    options: SolverOptions | None = None,
    dtype=jnp.float64,
    refine: str = "auto",
    return_state: bool = False,
    pad_to: int | None = None,
    driver: str = "rank1",
    block: int = 32,
    simple_bounds: bool = False,
    mesh=None,
    batch_axis: str = "batch",
    cols_axis: str = "cols",
    warm_start=None,
    **opt_overrides,
) -> List[Solution]:
    """Solve a batch of LPs in one device call; one Solution per problem.

    ``warm_start`` (late r5): a prior ``Solution`` of the SAME-STRUCTURE
    program — the batch must share one constraint matrix / objective /
    lowering layout and differ ONLY in RHS (the scenario-analysis shape).
    All lanes warm-start from its basis through ONE compiled dual-simplex
    wave (``tpulp.solve.dual.run_warm_batch`` — the B&B child engine),
    then refine/certify per lane as usual; lanes the wave cannot settle
    (infeasible verdicts, failed certificates) re-solve solo through the
    ladder so statuses keep solve_lp's confirmation semantics. Plain
    row-form path only (no mesh / simple_bounds). Note: an RHS change
    that flips a constraint's sign lowers to a DIFFERENT layout (row
    negation + surplus), which the structure check rejects — scenarios
    must keep each RHS on its base sign.

    ``driver='blocked'`` routes the wave through the vmapped rank-K eta
    driver (``solve.blocked.run_simplex_blocked_batch``) — the right engine
    once per-lane tableaus stop being small (each rank-1 batched
    pivot re-reads every lane's whole tableau).

    ``mesh`` (round 5, VERDICT r4 item 3) makes this a one-call MULTI-CHIP
    batch solve over the (batch, cols) GSPMD layout — SCALING.md §3.3's
    conclusion made executable: the BATCH axis is the scalable cross-host
    dimension (zero per-pivot cross-shard traffic between lanes), with
    optional per-lane column sharding when the mesh has a ``cols_axis``.
    Lanes are padded to a multiple of the batch-axis size (replicating
    lane 0) and tableau width to the cols-axis size; every lane still goes
    through the SAME per-lane refinement + certificate pipeline as the
    single-device batch. Requires ``driver='rank1'`` (the GSPMD wave) and
    row-based bounds (``simple_bounds=False``).

    With ``return_state=True`` returns ``(solutions, out_state, lane_of)``
    where ``out_state`` is the batched terminal SimplexState and ``lane_of``
    maps problem index -> lane index (or -1 for trivially-infeasible problems
    that never reached the device) — the hook the MILP layer uses to run its
    per-wave integrality check on device.

    ``pad_to`` replicates lane 0 to a fixed batch dimension so repeated
    callers (B&B waves of varying width) hit ONE compiled executable instead
    of recompiling per batch size (measured: recompiles were 70% of MILP
    wall time). Padded lanes run on device but are never extracted."""
    if options is None:
        options = SolverOptions.for_dtype(dtype)
    if opt_overrides:
        options = dataclasses.replace(options, **opt_overrides)
    from ..model.lower import materialize_simple_bounds

    sfs = [
        p if isinstance(p, StandardForm)
        else lower_to_standard_form(p, simple_bounds=simple_bounds)
        for p in progs
    ]
    if not simple_bounds:
        # simple_bounds lowerings become explicit bound rows (exact, same
        # optimum): the unbounded batched drivers have no bounded ratio test
        sfs = [materialize_simple_bounds(sf) if sf.upper is not None else sf
               for sf in sfs]
    solvable = [i for i, sf in enumerate(sfs) if not sf.trivially_infeasible]
    results: List[Solution] = [Solution(status="infeasible")] * len(sfs)
    if not solvable:
        return (results, None, [-1] * len(sfs)) if return_state else results

    if warm_start is not None:
        if simple_bounds or mesh is not None:
            raise ValueError(
                "warm_start batching supports the plain row-form batch "
                "path only (no mesh, no simple_bounds)")
        return _solve_batch_warm(sfs, solvable, warm_start, options,
                                 dtype, refine, results, return_state)

    sf_batch = [sfs[i] for i in solvable]
    if pad_to is not None and len(sf_batch) < pad_to:
        # replicate the first problem up to the fixed batch width; padded
        # lanes run on device but are never extracted below
        sf_batch = sf_batch + [sf_batch[0]] * (pad_to - len(sf_batch))
    if mesh is not None:
        if simple_bounds:
            raise ValueError(
                "mesh batching has no sharded bounded-variable wave yet; "
                "use simple_bounds=False (bounds become explicit rows)")
        if driver != "rank1":
            raise ValueError(
                "mesh batching runs the GSPMD rank-1 wave; use "
                "driver='rank1'")
        from ..shard.sharded import run_simplex_batch_gspmd

        bsz = mesh.shape[batch_axis]
        lane_pad = (-len(sf_batch)) % bsz
        if lane_pad:
            sf_batch = sf_batch + [sf_batch[0]] * lane_pad
        batched = make_batched_states(sf_batch, dtype=dtype)
        csz = mesh.shape.get(cols_axis, 1) \
            if hasattr(mesh.shape, "get") else dict(mesh.shape).get(
                cols_axis, 1)
        batched = pad_batched_columns(batched, csz)
        out = run_simplex_batch_gspmd(batched, mesh, options,
                                      batch_axis=batch_axis,
                                      cols_axis=cols_axis)
        extracted = extract_batch_solutions(
            [sfs[i] for i in solvable], out, refine)
        for k, i in enumerate(solvable):
            results[i] = extracted[k]
        if return_state:
            lane_of = [-1] * len(sfs)
            for k, i in enumerate(solvable):
                lane_of[i] = k
            return results, out, lane_of
        return results
    if simple_bounds:
        # bound-free tableaus: spans ride the batched BoundedState and the
        # vmapped bounded-variable driver enforces them in its ratio test
        # (VERDICT r3 item 6 — one dense row per finite bound is gone)
        from ..solve.bounded import run_simplex_bounded_batch

        bstate = make_batched_bounded_states(sf_batch, dtype=dtype)
        bout = run_simplex_bounded_batch(bstate, options)
        extracted = extract_batch_bounded_solutions(
            [sfs[i] for i in solvable], bout, refine)
        for k, i in enumerate(solvable):
            results[i] = extracted[k]
        if return_state:
            lane_of = [-1] * len(sfs)
            for k, i in enumerate(solvable):
                lane_of[i] = k
            return results, bout.s, lane_of
        return results
    batched = make_batched_states(sf_batch, dtype=dtype)
    if driver == "blocked":
        from ..solve.blocked import run_simplex_blocked_batch

        out = run_simplex_blocked_batch(batched, options, block=block)
    elif driver == "rank1":
        out = run_simplex_batch(batched, options)
    else:
        raise ValueError(f"unknown batch driver {driver!r}")

    extracted = extract_batch_solutions(
        [sfs[i] for i in solvable], out, refine)
    for k, i in enumerate(solvable):
        results[i] = extracted[k]
    if return_state:
        lane_of = [-1] * len(sfs)
        for k, i in enumerate(solvable):
            lane_of[i] = k
        return results, out, lane_of
    return results


def _solve_batch_warm(sfs, solvable, warm_start, options, dtype, refine,
                      results, return_state):
    """One warm dual-simplex wave over same-structure RHS scenarios.

    Shared root frame + per-lane b + the warm basis tiled across lanes —
    exactly ``run_warm_batch``'s (B&B child) contract. Lanes whose wave
    verdict is anything but a certified optimum re-solve solo through
    ``solve_standard_form`` so the batch keeps the ladder's status-
    confirmation semantics.
    """
    from ..solve.api import solve_standard_form
    from ..solve.dual import run_warm_batch

    if warm_start.basis is None:
        raise ValueError(
            "warm_start solution carries no basis (status-only or "
            "presolve-reduced solves don't); re-solve cold")
    dense = {i: sfs[i].to_dense(np.float64) for i in solvable}
    sf0 = sfs[solvable[0]]
    c0, A0, b0 = dense[solvable[0]]
    for i in solvable[1:]:
        sf = sfs[i]
        ci, Ai, _ = dense[i]
        if (sf.m != sf0.m or sf.n != sf0.n
                or list(sf.basis_hint) != list(sf0.basis_hint)
                or not np.array_equal(Ai, A0)
                or not np.array_equal(ci, c0)):
            raise ValueError(
                "warm_start batching requires SAME-STRUCTURE scenarios "
                "(identical constraint matrix, objective, and lowering "
                f"layout; program {i} differs — only the RHS may vary)")
    st0 = make_state(c0, A0, b0, sf0.basis_hint, dtype=dtype)
    wb = np.asarray(warm_start.basis, np.int32)
    if wb.shape != (st0.m,) or (wb.size and (
            int(wb.min()) < 0 or int(wb.max()) >= st0.n)):
        raise ValueError(
            f"warm_basis must be {st0.m} augmented-column indices in "
            f"[0, {st0.n}) for this program structure; got shape "
            f"{wb.shape}")
    # phase-2 frames: artificial columns must not be priceable
    active = st0.col_active & ~st0.art_cols
    b_mat = np.stack([dense[i][2] for i in solvable])
    basis_mat = np.tile(wb, (len(solvable), 1))
    out = run_warm_batch(st0.T[2:, :-1], st0.T[0, :-1], active,
                         st0.art_cols, basis_mat, b_mat, opts=options)
    extracted = extract_batch_solutions(
        [sfs[i] for i in solvable], out, refine)
    for k, i in enumerate(solvable):
        sol = extracted[k]
        if sol.status != "optimal":
            # float wave verdicts are unconfirmed; the solo ladder decides
            sol = solve_standard_form(sfs[i], options=options, dtype=dtype,
                                      refine=refine)
        results[i] = sol
    if return_state:
        lane_of = [-1] * len(sfs)
        for k, i in enumerate(solvable):
            lane_of[i] = k
        return results, out, lane_of
    return results


def extract_batch_solutions(sfs: Sequence[StandardForm], out: SimplexState,
                            refine: str,
                            prefetched=None) -> List[Solution]:
    """One Solution per StandardForm from the terminal batched state; lane k
    corresponds to ``sfs[k]`` (trailing padded lanes are ignored).

    ``prefetched`` optionally supplies already-on-host copies of
    ``(statuses, niters, bases, corners, art_cols)`` so callers that batch
    their device reads (one ``jax.device_get`` per wave — tpulp.milp) pay a
    single host round trip instead of five."""
    # ONE host fetch per leaf: per-lane device reads would each pay a full
    # device->host round trip
    if prefetched is not None:
        statuses, niters, bases, corners, art_cols_np = prefetched
    else:
        statuses = np.asarray(out.status)
        niters = np.asarray(out.niter)
        bases = np.asarray(out.basis)
        corners = np.asarray(out.T[:, 0, -1])
        art_cols_np = np.asarray(out.art_cols)
    rhs_np = np.asarray(out.T[:, 2:, -1]) if refine == "none" else None
    results: List[Solution] = []
    for k, sf in enumerate(sfs):
        status = Status.NAMES.get(int(statuses[k]), "unknown")
        if status != "optimal":
            results.append(Solution(status=status, niter=int(niters[k])))
            continue
        # map batched column indices back to this problem's own space:
        # cols < sf.n are structural; pad slacks & artificials -> unit rows
        basis_cols = [int(j) for j in bases[k]]
        results.append(_extract_one(
            sf, basis_cols, float(-corners[k]), int(niters[k]), refine,
            art_cols_np[k], None if rhs_np is None else rhs_np[k]))
    return results


def _extract_one(sf: StandardForm, basis_cols, z_float, niter, refine,
                 art_cols_lane: np.ndarray,
                 rhs_lane: Optional[np.ndarray]) -> Solution:
    """Refine + recover one lane's solution (host side).

    ``art_cols_lane``/``rhs_lane`` are this lane's rows of the already-
    fetched host copies (see extract_batch_solutions)."""
    from ..model.prog import MAX

    m = sf.m
    # keep only this problem's real rows' basis entries; padded rows carry
    # pad slacks / padded artificials which don't exist in sf's column space
    basis = basis_cols[:m]
    # batched column index -> sf column index: structural columns coincide
    # ([0, sf.n)); anything >= sf.n is a pad slack or artificial. Artificials
    # of THIS problem start at n_base in the batched layout but at sf.n in
    # refine's convention, so remap them.
    n_batched = art_cols_lane.shape[0]
    art_start_batched = int(art_cols_lane.argmax()) \
        if bool(art_cols_lane.any()) else n_batched
    remapped = []
    for j in basis:
        if j < sf.n:
            remapped.append(j)
        elif j >= art_start_batched:
            remapped.append(sf.n + (j - art_start_batched))
        else:
            # pad slack basic in a real row cannot happen (pad slacks live
            # only in padded rows, and rows only swap basis via pivots in
            # their own row)
            remapped.append(j)
    if refine == "none":
        col_values = None
        z_min = z_float + float(sf.obj_const)
        obj = -z_min if sf.sense == MAX else z_min
        # recover x from the float tableau directly
        b = rhs_lane[:m]
        vals = {}
        for k2, j in enumerate(remapped):
            if j < sf.n:
                vals[j] = float(b[k2])
        x = {}
        for name, (terms, const) in sf.recover.items():
            v = const
            for col, coeff in terms:
                v = v + coeff * vals.get(col, 0.0)
            x[name] = v
        return Solution(status="optimal", objective=obj, x=x, niter=niter,
                        objective_min=z_min, col_values=vals, basis=remapped)
    try:
        col_values, z_min = refine_basis_solution(sf, remapped, mode=refine)
    except (ZeroDivisionError, np.linalg.LinAlgError):
        return Solution(status="numerical_error", niter=niter)
    # optimality-certificate check (same contract as solve_standard_form):
    # the batch has no per-lane precision ladder, so a failed certificate is
    # reported as numerical_error for the caller to re-solve solo. The
    # certificate's precision FOLLOWS the refine mode: callers that chose
    # f64 refinement (e.g. MILP bounding waves, which exact-verify their
    # incumbents separately) must not pay an O(m^3) rational certificate
    # per lane.
    from ..solve.refine import exact_basis_certificate, float_basis_certificate

    mode = refine
    if mode == "auto":
        mode = "exact" if sf.m <= 192 else "float64"
    try:
        if mode == "exact":
            primal_ok, dual_ok = exact_basis_certificate(sf, remapped)
        else:
            primal_ok, dual_ok = float_basis_certificate(sf, remapped)
    except (ZeroDivisionError, np.linalg.LinAlgError):
        return Solution(status="numerical_error", niter=niter)
    if not (primal_ok and dual_ok):
        return Solution(status="numerical_error", niter=niter)
    obj = -z_min if sf.sense == MAX else z_min
    from fractions import Fraction

    def colval(j):
        return col_values.get(j, Fraction(0))

    x = {}
    for name, (terms, const) in sf.recover.items():
        v = const
        for col, coeff in terms:
            v = v + coeff * colval(col)
        x[name] = v
    return Solution(status="optimal", objective=obj, x=x, niter=niter,
                    objective_min=z_min, col_values=dict(col_values),
                    basis=remapped)
