"""Device tableau state and solver options.

Device-first redesign of the reference's tableau + simplex state
(tableau.py:36-52, simplex.py:32-33). Key differences, all driven by XLA's
static-shape compilation model (SURVEY.md §7 "hard parts"):

* ONE dense array ``T`` of shape ``(m + 2, n + 1)`` holds everything that the
  pivot touches, so the rank-1 update is a single fused operation::

      row 0   : phase-2 (real) reduced costs | -z2
      row 1   : phase-1 (artificial) costs   | -z1
      row 2+i : A[i, :]                      | b[i]

  Carrying BOTH objective rows through every pivot is what makes the
  two-phase method branchless: when phase 1 ends, the real objective row is
  already reduced over the current basis — the transition is just "switch
  pricing row, mask artificial columns" (no tableau surgery like the
  reference's simplex.py:86-105).

* The tableau never changes shape. Artificial columns are pre-allocated and
  *masked out* of pricing for phase 2 instead of deleted; linearly dependent
  rows keep their artificial basic at value ~0 instead of being removed
  (masking also fixes the reference's row-deletion bug, SURVEY.md §2.7-1).

* All algorithm state lives in one pytree so the driver is a pure
  ``state -> state`` function: jit/vmap/shard_map compose around it.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = [
    "Status",
    "SolverOptions",
    "SimplexState",
    "make_state",
    "RULE_DANTZIG",
    "RULE_BLAND",
    "RULE_MAX_INCREASE",
    "RULE_DEVEX",
    "TIE_FIRST",
    "TIE_MAXPIV",
    "eta_scaled_options",
]

RULE_DANTZIG = 0
RULE_BLAND = 1
# ratio-test tie resolution modes (SolverOptions.tie_break)
TIE_FIRST = 0
TIE_MAXPIV = 1
# greatest-improvement pricing (reference findPivotMaxIncrease,
# /root/reference/lpsol/simplex.py:286-328): scans the whole tableau per
# pivot — same O(m n) cost class as the pivot itself, opt-in
RULE_MAX_INCREASE = 2
# devex reference-framework pricing (c_j^2 / gamma_j): far fewer pivots on
# equality-heavy instances; honored by the rank-K blocked driver (the
# rank-1 path has its own devex driver, tpulp.solve.devex); no reference
# counterpart
RULE_DEVEX = 3


class Status:
    """Solver status codes (int32 on device). The reference asserted or threw
    on non-optimal outcomes (SURVEY.md §2.7-4); the device solver always
    reports."""

    RUNNING = 0
    OPTIMAL = 1
    UNBOUNDED = 2
    INFEASIBLE = 3
    ITERATION_LIMIT = 4
    # non-finite value detected in the iterates (f32 blowup): the basis is
    # untrustworthy; callers should retry at higher precision (solve_lp
    # retries in f64 automatically)
    NUMERIC = 5

    NAMES = {
        0: "running",
        1: "optimal",
        2: "unbounded",
        3: "infeasible",
        4: "iteration_limit",
        5: "numerical_error",
    }


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Static solver configuration (hashable: passed as a jit static arg).

    The pivot-rule surface matches the reference (Dantzig default with a
    Bland anti-cycling fallback, simplex.py:123-146) but the stall detector
    compares against the *current* objective (fix of SURVEY.md §2.7-2), and
    the switch trips after ``stall_limit`` consecutive non-improving pivots.
    """

    rule: int = RULE_DANTZIG
    max_iters: int = 10_000
    # reduced-cost optimality tolerance
    opt_tol: float = 1e-9
    # pivot-element positivity tolerance for the ratio test. CRITICAL for
    # float32: accepting a near-zero pivot element amplifies the whole
    # tableau by 1/pivot and destroys feasibility/monotonicity — use
    # ``SolverOptions.for_dtype`` to get dtype-appropriate tolerances.
    piv_tol: float = 1e-9
    # |z - last_z| below this counts as a degenerate (stalled) pivot
    degen_tol: float = 0.0
    # consecutive stalled pivots before permanently switching to Bland;
    # 0 means "scale with problem size" (m + n, like the reference)
    stall_limit: int = 0
    # phase-1 optimum above this is reported infeasible
    infeas_tol: float = 1e-7
    # dual simplex: basic values above -feas_tol count as primal feasible
    # (termination test of tpulp.solve.dual)
    feas_tol: float = 1e-9
    # min-ratio tie resolution (non-Bland pricing only): TIE_FIRST picks the
    # first tie row (reference-compatible walks); TIE_MAXPIV picks the tie
    # row with the LARGEST pivot element — the partial-pivoting flavor that
    # bounds tableau element growth over deep float walks (every production
    # float simplex stabilizes the ratio test this way; the exact-rational
    # reference never needed to). Used by the refreshed/stabilized drivers
    # (tpulp.solve.refresh).
    tie_break: int = 0

    def resolved_stall_limit(self, m: int, n: int) -> int:
        return self.stall_limit if self.stall_limit > 0 else m + n

    @classmethod
    def for_dtype(cls, dtype, **overrides) -> "SolverOptions":
        """Defaults scaled to the iterate precision: f32 needs much looser
        pivot/optimality tolerances than f64 (f32 eps ~1.2e-7)."""
        # canonicalize first: under a no-x64 session a float64 request
        # truncates to f32 iterates, which need the f32 tolerances
        name = canonical_dtype(dtype).name
        if name == "float32":
            base = dict(opt_tol=1e-5, piv_tol=1e-5, infeas_tol=1e-4,
                        feas_tol=1e-5)
        elif name == "bfloat16":
            # bf16 STORAGE experiment (compute stays f32): eps ~ 7.8e-3, so
            # decision tolerances sit well above the quantization floor
            base = dict(opt_tol=1e-3, piv_tol=1e-2, infeas_tol=1e-1,
                        feas_tol=1e-2)
        else:
            base = dict(opt_tol=1e-9, piv_tol=1e-9, infeas_tol=1e-7,
                        feas_tol=1e-9)
        base.update(overrides)
        return cls(**base)


class SimplexState(NamedTuple):
    """The complete per-problem solver state (a pytree; vmap over axis 0 of
    every field gives the batched solver)."""

    T: jax.Array           # (m + 2, n + 1) tableau, see module docstring
    basis: jax.Array       # (m,) int32: basic column per constraint row
    col_active: jax.Array  # (n,) bool: columns available for pricing
    art_cols: jax.Array    # (n,) bool: which columns are artificial
    phase: jax.Array       # () int32: 1 or 2
    status: jax.Array      # () int32: Status.*
    niter: jax.Array       # () int32: pivots performed (both phases)
    stuck: jax.Array       # () int32: consecutive non-improving pivots
    bland: jax.Array       # () bool: permanently switched to Bland's rule
    last_z: jax.Array      # () objective at the previous pivot (current phase)

    @property
    def m(self) -> int:
        return self.T.shape[0] - 2

    @property
    def n(self) -> int:
        return self.T.shape[1] - 1

    def objective(self) -> jax.Array:
        """Current phase-2 objective value (minimization)."""
        return -self.T[0, -1]


ETA_F32_PIV_TOL = 1e-4


def eta_scaled_options(opts, dtype):
    """Ratio-test tolerance for rank-K (eta-reconstruction) engines.

    Blocked-family drivers reconstruct the entering column as
    ``T0[:, j] + V[:, j]^T U``; after up to K etas the reconstruction noise
    is ~1e-4 relative at f32 — an entry that reads +2e-5 can truly be
    negative. Pivoting on such noise destroys feasibility while the engine
    still reports OPTIMAL (measured: a 24x24 f32 RULE_BLAND walk lost
    primal feasibility at piv_tol=1e-5 and landed a provably non-optimal
    basis; >=5e-5 restores the correct walk — round-4 compiled-pin
    finding). Rank-1 engines update the full tableau and keep the sharper
    dtype default. No-op for f64 or when the caller already asked for a
    looser tolerance."""
    import dataclasses

    if canonical_dtype(dtype) != jnp.dtype("float32"):
        return opts
    if opts.piv_tol >= ETA_F32_PIV_TOL:
        return opts
    return dataclasses.replace(opts, piv_tol=ETA_F32_PIV_TOL)


def canonical_dtype(dtype):
    """The dtype JAX will actually use for ``dtype`` in this session.

    When x64 is disabled an explicit float64 request silently becomes
    float32 (the precision-ladder paths rely on this truncation); resolving
    it once here keeps jnp's per-array truncation UserWarning out of bench
    artifacts and user logs."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jnp.zeros((), dtype).dtype


def make_state(
    c,
    A,
    b,
    basis_hint,
    dtype=jnp.float32,
    n_extra_art: int = 0,
    _numpy: bool = False,
) -> SimplexState:
    """Build the initial device state from standard-form arrays.

    ``basis_hint[i] >= 0`` names a ready basic column for row i (slack from
    the lowering); rows with ``-1`` get an artificial column appended. If no
    row needs one, the state starts directly in phase 2.

    ``n_extra_art`` pads additional (inactive) artificial columns so batched
    problems with different artificial counts share one shape.

    ``_numpy=True`` returns numpy leaves instead of device arrays — the
    batched builder stacks many states on host and does ONE device transfer
    (per-state eager transfers dominated B&B wave setup).
    """
    import numpy as np

    dtype = canonical_dtype(dtype)
    c = np.asarray(c, dtype=np.float64)
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    m, n0 = A.shape
    hint = list(basis_hint)
    art_rows = [i for i in range(m) if hint[i] < 0]
    n_art = len(art_rows) + int(n_extra_art)
    n = n0 + n_art

    T = np.zeros((m + 2, n + 1), dtype=np.float64)
    T[0, :n0] = c
    T[2:, :n0] = A
    T[2:, -1] = b

    basis = np.zeros((m,), dtype=np.int32)
    art_mask = np.zeros((n,), dtype=bool)
    art_mask[n0:] = True
    for k, i in enumerate(art_rows):
        j = n0 + k
        T[2 + i, j] = 1.0
        basis[i] = j
    for i in range(m):
        if hint[i] >= 0:
            basis[i] = hint[i]

    if art_rows:
        # phase-1 objective (min sum of artificials), pre-reduced over the
        # initial basis: row1 = -sum of artificial rows; corner = -sum b
        T[1, :] = -T[2:, :][np.array(art_rows)].sum(axis=0)
        T[1, n0: n0 + len(art_rows)] = 0.0
        phase = 1
    else:
        phase = 2

    col_active = np.ones((n,), dtype=bool)
    col_active[n0 + len(art_rows):] = False  # padded artificials: never priceable
    if phase == 2:
        col_active &= ~art_mask

    if _numpy:
        np_dtype = np.dtype(jnp.zeros((), dtype).dtype)
        return SimplexState(
            T=T.astype(np_dtype),
            basis=basis,
            col_active=col_active,
            art_cols=art_mask,
            phase=np.int32(phase),
            status=np.int32(Status.RUNNING),
            niter=np.int32(0),
            stuck=np.int32(0),
            bland=np.bool_(False),
            last_z=np_dtype.type(np.inf),
        )
    return SimplexState(
        T=jnp.asarray(T, dtype=dtype),
        basis=jnp.asarray(basis),
        col_active=jnp.asarray(col_active),
        art_cols=jnp.asarray(art_mask),
        phase=jnp.asarray(phase, dtype=jnp.int32),
        status=jnp.asarray(Status.RUNNING, dtype=jnp.int32),
        niter=jnp.asarray(0, dtype=jnp.int32),
        stuck=jnp.asarray(0, dtype=jnp.int32),
        bland=jnp.asarray(False),
        last_z=jnp.asarray(np.inf, dtype=dtype),
    )
