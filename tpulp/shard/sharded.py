"""Column-partitioned multi-chip simplex (SPMD over a device mesh).

The domain's "big axis" is tableau width n (SURVEY.md §5: the LP analogue of
sequence parallelism), so the tableau is sharded along columns over a mesh
axis (``"cols"``), optionally combined with a batch axis (``"batch"``) for
data-parallel batches of LPs — the 2D mesh (batch, cols) is this framework's
(dp, tp) layout. Per BASELINE.json config 5.

Communication pattern per pivot (NVLink within a host, the network across):

1. pricing: each shard reduces its local reduced costs to a (value, index)
   candidate; an ``all_gather`` of P pairs + replicated argmin picks the
   global entering column (Dantzig) or global first-improving (Bland, a pmin)
2. entering-column fetch: the owner shard contributes its column, everyone
   else zeros — one ``psum`` of an (m+2)-vector broadcasts it
3. ratio test: fully replicated (b is replicated)
4. rank-1 update: purely local on each shard's column block

This module provides BOTH multi-chip paths:

* ``shard_state`` + the ordinary driver under jit with NamedShardings — the
  "annotate and let GSPMD insert collectives" path (scaling-book recipe);
* ``run_simplex_sharded`` — the explicit shard_map driver above, with
  hand-placed collectives (the performance path; same SimplexState layout
  split into a sharded column block and a replicated RHS column).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.state import RULE_BLAND, SimplexState, SolverOptions, Status
from ..solve.driver import _compiled_driver

__all__ = [
    "shard_state",
    "run_simplex_gspmd",
    "run_simplex_batch_gspmd",
    "ShardedState",
    "to_sharded_state",
    "from_sharded_state",
    "run_simplex_sharded",
    "make_mesh",
]


# ---------------------------------------------------------------------------
# Path A: GSPMD auto-partitioning of the single-chip driver
# ---------------------------------------------------------------------------

def make_mesh(n_devices: Optional[int] = None, axis: str = "cols") -> Mesh:
    """A 1D mesh over the first ``n_devices`` devices (all by default)."""
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"need {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def _axis_size(mesh: Mesh, axis) -> int:
    """Total shard count along ``axis`` (a mesh axis name or tuple of names —
    the tuple form is the multi-host (hosts, cols) hybrid layout, where the
    column dimension is split host-major so per-host blocks are contiguous
    and intra-host collectives stay on NVLink)."""
    if isinstance(axis, str):
        return mesh.shape[axis]
    return int(np.prod([mesh.shape[a] for a in axis]))


def state_sharding(mesh: Mesh, axis: str = "cols") -> SimplexState:
    """NamedShardings for each SimplexState leaf: the tableau is sharded on
    the column axis; the (n,)-bool masks stay replicated (their width n and
    the tableau's n+1 cannot both divide the mesh, and they are tiny —
    GSPMD handles the mixed layout)."""
    def ns(*spec):
        return NamedSharding(mesh, P(*spec))

    return SimplexState(
        T=ns(None, axis),
        basis=ns(None),
        col_active=ns(None),
        art_cols=ns(None),
        phase=ns(),
        status=ns(),
        niter=ns(),
        stuck=ns(),
        bland=ns(),
        last_z=ns(),
    )


def shard_state(state: SimplexState, mesh: Mesh, axis: str = "cols"
                ) -> SimplexState:
    """Place a state on the mesh, column-sharded.

    Pads the column count to a multiple of the axis size (padded columns are
    zero, costless and inactive, so they never enter pricing)."""
    p = _axis_size(mesh, axis)
    n = state.n
    # T's trailing RHS column makes the padded width n+1+pad; sharding evenly
    # requires (n+1+pad) % p == 0
    pad = (-(n + 1)) % p
    if pad:
        zcol = jnp.zeros((state.T.shape[0], pad), dtype=state.T.dtype)
        # insert padding BEFORE the RHS column so the RHS stays last
        T = jnp.concatenate([state.T[:, :-1], zcol, state.T[:, -1:]], axis=1)
        fmask = jnp.zeros((pad,), dtype=bool)
        state = state._replace(
            T=T,
            col_active=jnp.concatenate([state.col_active, fmask]),
            art_cols=jnp.concatenate([state.art_cols, fmask]),
        )
    shardings = state_sharding(mesh, axis)
    return jax.tree.map(jax.device_put, state, shardings)


def run_simplex_gspmd(
    state: SimplexState,
    mesh: Mesh,
    opts: SolverOptions | None = None,
    axis: str = "cols",
) -> SimplexState:
    """Run the standard driver under GSPMD: shardings annotated, collectives
    inserted by XLA. ``state`` should come from ``shard_state``."""
    if opts is None:
        opts = SolverOptions.for_dtype(state.T.dtype)
    from ..solve.driver import _budget_key

    stall_limit = opts.resolved_stall_limit(state.m, state.n)
    driver = _compiled_driver.__wrapped__(_budget_key(opts), stall_limit)
    shardings = state_sharding(mesh, axis)
    fn = jax.jit(
        driver,
        in_shardings=(shardings, NamedSharding(mesh, P())),
        out_shardings=shardings,
    )
    return fn(state, jnp.asarray(opts.max_iters, jnp.int32))


def batch_state_sharding(mesh: Mesh, batch_axis: str = "batch",
                         cols_axis: str = "cols") -> SimplexState:
    """NamedShardings for a BATCHED state on a 2D (batch, cols) mesh — the
    LP domain's (dp, tp) layout: independent problems split over the batch
    axis, each problem's tableau columns split over the cols axis. A 1D
    mesh with only the batch axis (batch-outermost, SCALING.md §3.3's
    scalable cross-host dimension) leaves the columns unsharded."""
    if cols_axis not in mesh.axis_names:
        cols_axis = None

    def ns(*spec):
        return NamedSharding(mesh, P(*spec))

    return SimplexState(
        T=ns(batch_axis, None, cols_axis),
        basis=ns(batch_axis),
        col_active=ns(batch_axis),
        art_cols=ns(batch_axis),
        phase=ns(batch_axis),
        status=ns(batch_axis),
        niter=ns(batch_axis),
        stuck=ns(batch_axis),
        bland=ns(batch_axis),
        last_z=ns(batch_axis),
    )


def run_simplex_batch_gspmd(
    batched: SimplexState,
    mesh: Mesh,
    opts: SolverOptions | None = None,
    batch_axis: str = "batch",
    cols_axis: str = "cols",
) -> SimplexState:
    """FULL batched solve under the 2D (batch, cols) GSPMD layout.

    The vmapped single-problem driver is jitted with dp x tp shardings and
    XLA inserts the cross-shard collectives (pricing argmin, entering-column
    gather) along the cols axis per lane. The batch dimension and the
    tableau width (n+1) must divide their mesh axes; ``shard_state``-style
    column padding is the caller's job (see tests)."""
    if opts is None:
        opts = SolverOptions.for_dtype(batched.T.dtype)
    from ..solve.driver import _budget_key

    m = batched.T.shape[1] - 2
    n = batched.T.shape[2] - 1
    stall_limit = opts.resolved_stall_limit(m, n)
    single = _compiled_driver.__wrapped__(_budget_key(opts), stall_limit)
    shardings = batch_state_sharding(mesh, batch_axis, cols_axis)
    fn = jax.jit(
        jax.vmap(single, in_axes=(0, None)),
        in_shardings=(shardings, NamedSharding(mesh, P())),
        out_shardings=shardings,
    )
    batched = jax.tree.map(jax.device_put, batched, shardings)
    return fn(batched, jnp.asarray(opts.max_iters, jnp.int32))


# ---------------------------------------------------------------------------
# Path B: explicit shard_map driver with hand-placed collectives
# ---------------------------------------------------------------------------

class ShardedState(NamedTuple):
    """SimplexState split for explicit SPMD: the (m+2, n) coefficient block
    is column-sharded; the RHS column (objective corners + b) is replicated
    and updated identically on every shard."""

    T: jax.Array           # (m+2, n) sharded on axis 1
    rhs: jax.Array         # (m+2,) replicated: [-z2, -z1, b...]
    basis: jax.Array       # (m,) int32, replicated
    col_active: jax.Array  # (n,) sharded
    art_cols: jax.Array    # (n,) sharded
    phase: jax.Array
    status: jax.Array
    niter: jax.Array
    stuck: jax.Array
    bland: jax.Array
    last_z: jax.Array


def to_sharded_state(state: SimplexState, mesh: Mesh, axis: str = "cols"
                     ) -> ShardedState:
    """Split a SimplexState and place it on the mesh (pads columns to a
    multiple of the axis size). ``axis`` may be a tuple of mesh axis names
    (the multi-host hybrid layout)."""
    p = _axis_size(mesh, axis)
    n = state.n
    pad = (-n) % p
    T = state.T[:, :-1]
    rhs = state.T[:, -1]
    col_active = state.col_active
    art_cols = state.art_cols
    if pad:
        T = jnp.concatenate(
            [T, jnp.zeros((T.shape[0], pad), dtype=T.dtype)], axis=1)
        fmask = jnp.zeros((pad,), dtype=bool)
        col_active = jnp.concatenate([col_active, fmask])
        art_cols = jnp.concatenate([art_cols, fmask])

    def ns(*spec):
        return NamedSharding(mesh, P(*spec))

    return ShardedState(
        T=jax.device_put(T, ns(None, axis)),
        rhs=jax.device_put(rhs, ns(None)),
        basis=jax.device_put(state.basis, ns(None)),
        col_active=jax.device_put(col_active, ns(axis)),
        art_cols=jax.device_put(art_cols, ns(axis)),
        phase=state.phase,
        status=state.status,
        niter=state.niter,
        stuck=state.stuck,
        bland=state.bland,
        last_z=state.last_z,
    )


def from_sharded_state(sh: ShardedState, n: int) -> SimplexState:
    """Reassemble a SimplexState (dropping column padding)."""
    T = jnp.concatenate([sh.T[:, :n], sh.rhs[:, None]], axis=1)
    return SimplexState(
        T=T,
        basis=sh.basis,
        col_active=sh.col_active[:n],
        art_cols=sh.art_cols[:n],
        phase=sh.phase,
        status=sh.status,
        niter=sh.niter,
        stuck=sh.stuck,
        bland=sh.bland,
        last_z=sh.last_z,
    )


def _fetch_column(T_local, j, axis: str):
    """Entering column as a replicated (m+2,) vector: owner shard contributes,
    psum broadcasts (one m-vector collective per pivot)."""
    n_local = T_local.shape[1]
    ax = lax.axis_index(axis)
    owner = (j // n_local) == ax
    j_local = j % n_local
    u = jnp.where(owner, T_local[:, j_local], 0.0)
    return lax.psum(u, axis), owner, j_local


def _sharded_step(s: ShardedState, opts: SolverOptions, stall_limit: int,
                  n_global: int, axis: str) -> ShardedState:
    """One BRANCHLESS transition of the sharded state machine.

    Mirrors ``tpulp.solve.driver.simplex_step`` (same decision logic, same
    no-op-pivot freezing for terminal states, same in-iteration phase
    transition and artificial cleanup) with the three collectives of the
    column-partitioned layout: an all_gather of per-shard pricing candidates,
    pmin reductions for first-index rules, and one psum to broadcast the
    entering column. Branchless for the same reason as the local driver: a
    lax.cond carrying the local tableau block costs a copy of it on the
    untaken side every iteration."""
    dtype = s.T.dtype
    n_local = s.T.shape[1]
    m = s.basis.shape[0]
    nrows = s.T.shape[0]
    ax = lax.axis_index(axis)
    inf = jnp.asarray(jnp.inf, dtype)
    running = s.status == Status.RUNNING
    in_phase2 = s.phase == 2
    local_ids = (jnp.arange(n_local, dtype=jnp.int32) + ax * n_local)
    BIG = jnp.int32(2**30)

    # ---- cleanup scan: which rows hold a basic artificial ------------------
    # basis is replicated; each shard gathers its owned entries, psum merges
    owner_b = (s.basis // n_local) == ax                       # (m,)
    art_at_basis = s.art_cols[s.basis % n_local]               # local gather
    art_basic = lax.psum(
        jnp.where(owner_b, art_at_basis.astype(jnp.int32), 0), axis) > 0
    cleanup = jnp.any(art_basic) & in_phase2 & running
    r_d = jnp.argmax(art_basic).astype(jnp.int32)
    row_d = s.T[2 + r_d, :]                                    # local slice
    elig = s.col_active & ~s.art_cols & (jnp.abs(row_d) > opts.piv_tol)
    l_first_elig = jnp.min(jnp.where(elig, local_ids, BIG))
    j_d = lax.pmin(l_first_elig, axis)
    has_elig = j_d < BIG
    j_d = jnp.minimum(j_d, n_global - 1)
    # dependent row: retire its artificial (owner shard clears the bit)
    retire = cleanup & ~has_elig
    basis_rd = s.basis[r_d]
    owner_rd = (basis_rd // n_local) == ax
    art_cols = jnp.where(
        retire & owner_rd,
        s.art_cols.at[basis_rd % n_local].set(False),
        s.art_cols)

    # ---- pricing: per-shard candidate + tiny all_gather reduction ----------
    crow = jnp.where(s.phase == 1, s.T[1], s.T[0])
    c_eff = jnp.where(s.col_active, crow, inf)
    l_min = jnp.min(c_eff)
    l_arg = (jnp.argmin(c_eff) + ax * n_local).astype(jnp.int32)
    g_vals = lax.all_gather(l_min, axis)     # (P,)
    g_idxs = lax.all_gather(l_arg, axis)     # (P,)
    k = jnp.argmin(g_vals)
    j_dantzig = g_idxs[k]
    c_min = g_vals[k]
    improving_l = c_eff < -opts.opt_tol
    l_first = jnp.min(jnp.where(improving_l, local_ids, n_global))
    j_bland = lax.pmin(l_first, axis)
    has_improving = c_min < -opts.opt_tol
    use_bland = s.bland | (opts.rule == RULE_BLAND)
    j_price = jnp.where(
        use_bland, jnp.minimum(j_bland, n_global - 1), j_dantzig)

    # ---- phase bookkeeping scalars ----------------------------------------
    z1 = -s.rhs[1]
    phase1_done = (s.phase == 1) & ~has_improving & running
    became_infeasible = phase1_done & (z1 > opts.infeas_tol)
    to_phase2 = phase1_done & ~became_infeasible
    pricing_pivot = has_improving & ~cleanup & ~phase1_done

    # ---- entering column via psum broadcast + replicated ratio test --------
    j = jnp.where(cleanup, j_d, j_price)
    u, owner, j_local = _fetch_column(s.T, j, axis)
    col = u[2:]
    b = s.rhs[2:]
    pos = col > opts.piv_tol
    has_ratio = jnp.any(pos)
    ratios = jnp.where(pos, b / jnp.where(pos, col, 1.0), inf)
    min_ratio = jnp.min(ratios)
    tie = ratios <= min_ratio
    r_first = jnp.argmax(tie).astype(jnp.int32)
    r_bland = jnp.argmin(jnp.where(tie, s.basis, BIG)).astype(jnp.int32)
    r_price = jnp.where(use_bland, r_bland, r_first)

    became_unbounded = pricing_pivot & ~has_ratio & in_phase2 & running
    became_failed1 = pricing_pivot & ~has_ratio & ~in_phase2 & running

    # ---- the one pivot (no-op redirect when idle) --------------------------
    do_cleanup = cleanup & has_elig
    do_pricing = pricing_pivot & has_ratio & running
    do_pivot = do_cleanup | do_pricing
    r = jnp.where(do_cleanup, r_d, r_price)
    rg = jnp.where(do_pivot, r + 2, 2)
    # no-op pivot: basis[0]'s column is an exact unit vector (snapped), so
    # pivoting on (row 2, basis[0]) reproduces the block bit-for-bit
    j_eff = jnp.where(do_pivot, j, s.basis[0])
    u_eff, owner_eff, j_local_eff = lax.cond(
        do_pivot,
        lambda: (u, owner, j_local),
        lambda: _fetch_column(s.T, s.basis[0], axis),
    )
    piv = u_eff[rg]
    invp = 1.0 / piv
    prow = s.T[rg, :] * invp                        # local pivot-row slice
    Tn = s.T - u_eff[:, None] * prow[None, :]
    is_rg = (jnp.arange(nrows) == rg)[:, None]
    Tn = jnp.where(is_rg, prow[None, :], Tn)
    unit = is_rg[:, 0].astype(dtype)
    is_j = owner_eff & (jnp.arange(n_local) == j_local_eff)
    Tn = jnp.where(is_j[None, :], unit[:, None], Tn)
    rhs_piv = s.rhs[rg] * invp
    rhsn = s.rhs - u_eff * rhs_piv
    rhsn = rhsn.at[rg].set(rhs_piv)

    basis = jnp.where(do_pivot, s.basis.at[r].set(j), s.basis)

    # ---- stall / Bland switch ---------------------------------------------
    z = jnp.where(s.phase == 1, -rhsn[1], -rhsn[0])
    improved = (s.last_z - z) > opts.degen_tol
    stuck = jnp.where(
        do_pricing,
        jnp.where(improved, 0, s.stuck + 1),
        s.stuck).astype(jnp.int32)
    last_z = jnp.where(do_pricing, z, s.last_z)
    bland = s.bland | (stuck >= stall_limit)

    # ---- phase transition + termination ------------------------------------
    phase = jnp.where(to_phase2, 2, s.phase).astype(jnp.int32)
    col_active = jnp.where(to_phase2, s.col_active & ~art_cols, s.col_active)
    stuck = jnp.where(to_phase2, 0, stuck)
    last_z = jnp.where(to_phase2, inf, last_z)

    finished_opt = in_phase2 & ~has_improving & ~cleanup & running
    # Non-finite guard (same contract as solve/driver.py:240-252): a f32
    # blowup poisons pricing with NaN (NaN < -tol is False), which would
    # otherwise read as "no improving column" -> a bogus OPTIMAL. The pricing
    # check needs a psum so every shard sees non-finiteness anywhere in the
    # sharded reduced-cost row; rhs is replicated so its check is local.
    finite_ok = (
        jnp.isfinite(z)
        & jnp.isfinite(jnp.sum(jnp.abs(rhsn[2:])))
        & jnp.isfinite(lax.psum(
            jnp.sum(jnp.where(s.col_active, jnp.abs(crow), 0.0)), axis))
    )
    new_status = jnp.where(
        ~finite_ok, jnp.int32(Status.NUMERIC),
        jnp.where(
            became_infeasible | became_failed1, jnp.int32(Status.INFEASIBLE),
            jnp.where(became_unbounded, jnp.int32(Status.UNBOUNDED),
                      jnp.where(finished_opt, jnp.int32(Status.OPTIMAL),
                                jnp.int32(Status.RUNNING)))))
    status = jnp.where(running, new_status, s.status)

    return ShardedState(
        T=Tn,
        rhs=rhsn,
        basis=basis,
        col_active=col_active,
        art_cols=art_cols,
        phase=phase,
        status=status,
        niter=s.niter + do_pivot.astype(jnp.int32),
        stuck=stuck,
        bland=bland,
        last_z=last_z,
    )


@functools.lru_cache(maxsize=16)
def _sharded_driver(opts: SolverOptions, stall_limit: int, n_global: int,
                    axis: str, mesh_key):
    mesh = mesh_key  # Mesh is hashable in recent jax
    from jax import shard_map

    specs = ShardedState(
        T=P(None, axis),
        rhs=P(),
        basis=P(),
        col_active=P(axis),
        art_cols=P(axis),
        phase=P(),
        status=P(),
        niter=P(),
        stuck=P(),
        bland=P(),
        last_z=P(),
    )

    def solve_local(s: ShardedState, max_iters) -> ShardedState:
        def cond(st):
            return (st.status == Status.RUNNING) & (st.niter < max_iters)

        def body(st):
            return _sharded_step(st, opts, stall_limit, n_global, axis)

        out = lax.while_loop(cond, body, s)
        return out._replace(status=jnp.where(
            out.status == Status.RUNNING,
            jnp.int32(Status.ITERATION_LIMIT), out.status))

    return jax.jit(shard_map(
        solve_local, mesh=mesh, in_specs=(specs, P()), out_specs=specs,
        check_vma=False))


def run_simplex_sharded(
    sh: ShardedState,
    mesh: Mesh,
    opts: SolverOptions | None = None,
    axis: str = "cols",
) -> ShardedState:
    """Run the explicit-collective sharded driver to termination."""
    if opts is None:
        opts = SolverOptions.for_dtype(sh.T.dtype)
    m = sh.basis.shape[0]
    n_global = sh.T.shape[1]
    stall_limit = opts.resolved_stall_limit(m, n_global)
    from ..solve.driver import _budget_key

    driver = _sharded_driver(_budget_key(opts), stall_limit, n_global, axis,
                             mesh)
    return driver(sh, jnp.asarray(opts.max_iters, jnp.int32))
