"""Final-basis refinement: recover high-precision solutions from low-precision
iterates.

Device simplex iterates run in f32/f64 floating point, but the parity bar is a
<=1e-9 relative objective gap against the reference's exact rationals
(BASELINE.md). The production trick: the *basis* identified by the float
iteration is discrete — once it is correct, re-solving ``B x_B = b`` against
the ORIGINAL problem data (exactly, or in f64 on host) recovers the objective
to full precision regardless of iterate drift. This replaces the reference's
everything-exact arithmetic (which is why it is an academic-speed tool,
SURVEY.md §6) with exact arithmetic only at the final solve.
"""

from __future__ import annotations

import math

from fractions import Fraction
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..model.lower import StandardForm

__all__ = [
    "refine_basis_solution",
    "exact_basis_solve",
    "basis_duals",
    "exact_basis_certificate",
    "float_basis_certificate",
    "original_sensitivity",
    "refine_bounded_basis",
    "bounded_basis_certificate",
    "float_bounded_certificate",
]

ZERO = Fraction(0)
ONE = Fraction(1)


def _artificial_row_map(sf: StandardForm) -> List[int]:
    """Artificial column k (0-based, appended after sf's columns) belongs to
    the k-th row lacking a basis hint; its column in original space is e_row."""
    return [i for i in range(sf.m) if sf.basis_hint[i] < 0]


def _basis_columns_exact(sf: StandardForm, basis: Sequence[int]
                         ) -> List[List[Fraction]]:
    """m x m exact basis matrix; artificial indices map to unit columns."""
    art_rows = _artificial_row_map(sf)
    cols: List[List[Fraction]] = []
    for j in basis:
        j = int(j)
        if j < sf.n:
            cols.append([sf.A[i][j] for i in range(sf.m)])
        else:
            row = art_rows[j - sf.n]
            cols.append([ONE if i == row else ZERO for i in range(sf.m)])
    return cols


def _exact_gauss_solve(cols: List[List[Fraction]], rhs: List[Fraction]
                       ) -> List[Fraction]:
    """Solve ``M x = rhs`` exactly where M's k-th COLUMN is cols[k].

    Bareiss fraction-free elimination: rows are scaled to integers once,
    forward elimination runs in pure big-int arithmetic with EXACT interior
    divisions (each entry is a minor determinant of the scaled matrix, so
    the previous pivot divides evenly — Bareiss' theorem, preserved under
    row swaps), and only the O(m^2) back-substitution touches Fractions.
    Replaces rational Gauss-Jordan whose every op paid gcd normalization —
    measured 8-20x faster at m = 30..60 (the MILP node / corpus oracle
    sizes).

    Raises ZeroDivisionError on a singular matrix."""
    m = len(rhs)
    if m == 0:
        return []
    # integer-scale each row of [M | rhs] (row scaling preserves solutions)
    aug = []
    for i in range(m):
        row = [cols[k][i] for k in range(m)] + [rhs[i]]
        den = 1
        for v in row:
            d = v.denominator
            if d != 1:
                den = den * d // math.gcd(den, d)
        aug.append([int(v.numerator) * (den // v.denominator) for v in row])

    prev = 1
    for k in range(m - 1):
        p = next((i for i in range(k, m) if aug[i][k] != 0), None)
        if p is None:
            raise ZeroDivisionError("singular basis matrix")
        if p != k:
            aug[k], aug[p] = aug[p], aug[k]
        pk = aug[k][k]
        rk = aug[k]
        for i in range(k + 1, m):
            ri = aug[i]
            aik = ri[k]
            if aik == 0:
                if prev != 1:
                    for j in range(k + 1, m + 1):
                        ri[j] = pk * ri[j] // prev
                else:
                    for j in range(k + 1, m + 1):
                        ri[j] = pk * ri[j]
            else:
                for j in range(k + 1, m + 1):
                    ri[j] = (pk * ri[j] - aik * rk[j]) // prev
                ri[k] = 0
        prev = pk
    if aug[m - 1][m - 1] == 0:
        raise ZeroDivisionError("singular basis matrix")

    # back-substitution in rationals over the integer triangle
    x: List[Fraction] = [ZERO] * m
    for i in range(m - 1, -1, -1):
        s = Fraction(aug[i][m])
        for j in range(i + 1, m):
            if aug[i][j]:
                s -= aug[i][j] * x[j]
        x[i] = s / aug[i][i]
    return x


def exact_basis_solve(sf: StandardForm, basis: Sequence[int]
                      ) -> Tuple[Dict[int, Fraction], Fraction]:
    """Solve ``B x_B = b`` in exact rationals; returns ({col: value}, z_min)
    where z_min is the minimization objective INCLUDING obj_const.

    Raises ZeroDivisionError if the basis matrix is singular (meaning the
    float iteration returned a numerically-broken basis)."""
    cols = _basis_columns_exact(sf, basis)
    xb = _exact_gauss_solve(cols, list(sf.b))
    values: Dict[int, Fraction] = {}
    z = sf.obj_const
    for k, j in enumerate(basis):
        j = int(j)
        if j < sf.n:
            values[j] = xb[k]
            z += sf.c[j] * xb[k]
        # artificial basics contribute nothing (value must be 0 for a
        # feasible basis; callers may check)
    return values, z


def basis_duals(sf: StandardForm, basis: Sequence[int], mode: str = "exact",
                exact_max_m: int = 192):
    """Row duals (shadow prices) of a basis: ``y = B^-T c_B``.

    ``y[i]`` is the marginal change of the minimization objective per unit
    increase of ``b[i]`` while the basis stays optimal — the standard
    sensitivity output the reference never exposed. ``mode`` as in
    ``refine_basis_solution``: 'exact' (Fractions), 'float64', or 'auto'.
    Raises ZeroDivisionError on a singular basis."""
    if mode == "auto":
        mode = "exact" if sf.m <= exact_max_m else "float64"
    m = sf.m
    if mode == "exact":
        cols = _basis_columns_exact(sf, basis)
        cb = [sf.c[int(j)] if int(j) < sf.n else ZERO for j in basis]
        bt_cols = [[cols[k][i] for k in range(m)] for i in range(m)]
        return _exact_gauss_solve(bt_cols, cb)
    if mode != "float64":
        raise ValueError(f"unknown duals mode {mode!r}")
    c64, A64, _ = sf.to_dense(np.float64)
    art_rows = _artificial_row_map(sf)
    B = np.zeros((m, m))
    cb = np.zeros(m)
    for k, j in enumerate(basis):
        j = int(j)
        if j < sf.n:
            B[:, k] = A64[:, j]
            cb[k] = c64[j]
        else:
            B[art_rows[j - sf.n], k] = 1.0
    return list(np.linalg.solve(B.T, cb))


def _bounded_sets(sf: StandardForm, basis, at_upper):
    """(basic set, nonbasic-at-upper columns with exact spans)."""
    bset = {int(j) for j in basis}
    ups = []
    for j, flag in enumerate(at_upper):
        if flag and j not in bset and j < sf.n and sf.upper[j] is not None:
            ups.append((j, sf.upper[j]))
    return bset, ups


def refine_bounded_basis(sf: StandardForm, basis, at_upper,
                         mode: str = "auto", exact_max_m: int = 192):
    """({col: TRUE value}, z_min) for a bounded-variable basis.

    Nonbasic at-upper columns sit exactly at their span ``u_j``; basic true
    values solve ``B x_B = b - sum_F u_j A_j`` (true space — the driver's
    complement representation never leaks out here). Same mode ladder as
    ``refine_basis_solution``."""
    if mode == "auto":
        mode = "exact" if sf.m <= exact_max_m else "float64"
    _, ups = _bounded_sets(sf, basis, at_upper)
    if mode == "exact":
        rhs = list(sf.b)
        for j, u in ups:
            for i in range(sf.m):
                rhs[i] = rhs[i] - u * sf.A[i][j]
        cols = _basis_columns_exact(sf, basis)
        xb = _exact_gauss_solve(cols, rhs)
        values: Dict[int, Fraction] = {j: u for j, u in ups}
        z = sf.obj_const + sum((sf.c[j] * u for j, u in ups), ZERO)
        for k, j in enumerate(basis):
            j = int(j)
            if j < sf.n:
                values[j] = xb[k]
                z += sf.c[j] * xb[k]
        return values, z
    if mode != "float64":
        raise ValueError(f"unknown refine mode {mode!r}")
    c64, A64, b64 = sf.to_dense(np.float64)
    for j, u in ups:
        b64 = b64 - float(u) * A64[:, j]
    m = sf.m
    art_rows = _artificial_row_map(sf)
    B = np.zeros((m, m))
    for k, j in enumerate(basis):
        j = int(j)
        if j < sf.n:
            B[:, k] = A64[:, j]
        else:
            B[art_rows[j - sf.n], k] = 1.0
    xb = np.linalg.solve(B, b64)
    values = {j: float(u) for j, u in ups}
    z = float(sf.obj_const) + sum(float(c64[j]) * float(u) for j, u in ups)
    for k, j in enumerate(basis):
        j = int(j)
        if j < sf.n:
            values[j] = float(xb[k])
            z += float(c64[j]) * float(xb[k])
    return values, z


def bounded_basis_certificate(sf: StandardForm, basis, at_upper
                              ) -> Tuple[bool, bool]:
    """Exact optimality certificate for a bounded-variable basis: primal
    ``0 <= x_B <= u_B`` (artificial basics at 0) given nonbasic-at-upper
    columns at their spans; dual ``c_j - y.A_j >= 0`` at lower and ``<= 0``
    at upper (the KKT conditions of the box-constrained standard form)."""
    m = sf.m
    _, ups = _bounded_sets(sf, basis, at_upper)
    rhs = list(sf.b)
    for j, u in ups:
        for i in range(m):
            rhs[i] = rhs[i] - u * sf.A[i][j]
    cols = _basis_columns_exact(sf, basis)
    xb = _exact_gauss_solve(cols, rhs)
    primal = True
    for k, j in enumerate(basis):
        j = int(j)
        if j >= sf.n:
            if xb[k] != 0:
                primal = False
        else:
            if xb[k] < 0:
                primal = False
            u = sf.upper[j] if sf.upper is not None else None
            if u is not None and xb[k] > u:
                primal = False
    cb = [sf.c[int(j)] if int(j) < sf.n else ZERO for j in basis]
    bt_cols = [[cols[k][i] for k in range(m)] for i in range(m)]
    y = _exact_gauss_solve(bt_cols, cb)
    up_set = {j for j, _ in ups}
    bset = {int(j) for j in basis}
    dual = True
    for j in range(sf.n):
        if j in bset:
            continue
        s = sf.c[j] - sum(sf.A[i][j] * y[i] for i in range(m))
        if j in up_set:
            if s > 0:
                dual = False
                break
        elif s < 0:
            dual = False
            break
    return primal, dual


def float_bounded_certificate(sf: StandardForm, basis, at_upper,
                              tol: float = 1e-7) -> Tuple[bool, bool]:
    """f64 version of ``bounded_basis_certificate`` for instances too large
    to verify in rationals (tolerance-based: can only REJECT confidently)."""
    c64, A64, b64 = sf.to_dense(np.float64)
    m = sf.m
    _, ups = _bounded_sets(sf, basis, at_upper)
    for j, u in ups:
        b64 = b64 - float(u) * A64[:, j]
    art_rows = _artificial_row_map(sf)
    B = np.zeros((m, m))
    cb = np.zeros(m)
    for k, j in enumerate(basis):
        j = int(j)
        if j < sf.n:
            B[:, k] = A64[:, j]
            cb[k] = c64[j]
        else:
            B[art_rows[j - sf.n], k] = 1.0
    xb = np.linalg.solve(B, b64)
    scale = max(float(np.abs(b64).max()), 1.0)
    primal = bool((xb >= -tol * scale).all())
    for k, j in enumerate(basis):
        j = int(j)
        if j >= sf.n:
            if abs(xb[k]) > tol * scale:
                primal = False
        elif sf.upper is not None and sf.upper[j] is not None:
            if xb[k] > float(sf.upper[j]) + tol * scale:
                primal = False
    y = np.linalg.solve(B.T, cb)
    s = c64 - A64.T @ y
    cscale = max(float(np.abs(c64).max()), 1.0)
    up_set = {j for j, _ in ups}
    bset = {int(j) for j in basis}
    dual = True
    for j in range(sf.n):
        if j in bset:
            continue
        if j in up_set:
            if s[j] > tol * cscale:
                dual = False
                break
        elif s[j] < -tol * cscale:
            dual = False
            break
    return primal, dual


def original_sensitivity(prog, sf: StandardForm, y_std):
    """Map standard-form row duals back to the USER's program.

    Returns ``(duals, reduced_costs)``:

    * ``duals`` — {constraint index: shadow price} in the ORIGINAL objective
      sense, keyed additionally by constraint name for named constraints
      (``LinProg.addConstraint(..., name=...)`` / MPS row names). The value
      is d(objective)/d(rhs) of the constraint's canonical form
      ``vars comp const`` (``LinCon.simplify``), the standard modeling-system
      convention. Sense corrections applied: a max objective negates the
      minimization duals; rows the lowering negated to make b >= 0 negate
      back (``StandardForm.row_provenance``).
    * ``reduced_costs`` — {variable name: original-sense reduced cost
      ``c_j - y . A_j`` over the ORIGINAL data}; at optimality basic
      variables get 0 and nonbasic ones price out AT THE BOUND THEY SIT ON:
      for a min problem, >= 0 when nonbasic at a lower bound and <= 0 when
      nonbasic at an upper bound (a variable lowered via the ub-only negated
      substitution lands in the second class); signs reverse for max. A
      consumer that assumes one global sign will misread optimal output for
      at-upper-bound variables. Exact Fractions when ``y_std`` is exact.

    The reference exposed no sensitivity output at all; this is the layer
    VERDICT r2 item 8 asked to finish.
    """
    from ..model.prog import MAX as _MAX

    sense_sign = -1 if sf.sense == _MAX else 1
    duals: Dict = {}
    by_index: Dict[int, object] = {}
    for i, (kind, ref, sign) in enumerate(sf.row_provenance):
        if kind != "con" or i >= len(y_std):
            continue
        by_index[ref] = sense_sign * sign * y_std[i]
    # constraints whose rows were dropped (constant rows) or never produced
    # a standard row have shadow price 0
    for ci in range(len(prog.constraints)):
        duals[ci] = by_index.get(ci, Fraction(0))
    names = getattr(prog, "con_names", None) or []
    for ci, nm in enumerate(names):
        if nm is not None and ci in duals:
            duals[nm] = duals[ci]

    # reduced costs from the ORIGINAL data: d = c - A^T y in the original
    # sense (independent of how the lowering shifted/split variables)
    reduced: Dict[str, object] = {}
    canon = [con.simplify() for con in prog.constraints]
    obj = prog.objective.expr
    for name in prog.allVarNames():
        d = obj.getCoefficient(name)
        for ci, c in enumerate(canon):
            a = c.left.getCoefficient(name)
            if a:
                d = d - a * by_index.get(ci, Fraction(0))
        reduced[name] = d
    return duals, reduced


def exact_basis_certificate(sf: StandardForm, basis: Sequence[int]
                            ) -> Tuple[bool, bool]:
    """(primal_feasible, dual_feasible) of a basis, verified EXACTLY.

    The float iterates only *propose* a basis; a wrongly-converged f32 run
    (observed on the ill-scaled corpus case) proposes a feasible but
    SUBOPTIMAL basis, which exact-objective refinement alone cannot catch.
    Strong duality closes the loop: if ``B x_B = b`` has x_B >= 0 (primal)
    and ``y = B^-T c_B`` prices every column nonnegatively
    (``c_j - y . A_j >= 0``, dual), the basis is exactly optimal — the same
    certificate the reference's ``isOptimal`` checks in rational arithmetic
    (/root/reference/lpsol/tableau.py:500-502), applied once at the end
    instead of every pivot.

    Raises ZeroDivisionError if the basis matrix is singular. An artificial
    column in the basis at value 0 is allowed (degenerate phase-1 leftovers);
    at nonzero value it is primal-infeasible."""
    m = sf.m
    cols = _basis_columns_exact(sf, basis)
    xb = _exact_gauss_solve(cols, list(sf.b))
    primal = all(v >= 0 for v in xb)
    # artificial basics must sit at exactly 0
    for k, j in enumerate(basis):
        if int(j) >= sf.n and xb[k] != 0:
            primal = False
    # dual: solve B^T y = c_B exactly (rows of B become columns of B^T)
    art_rows = _artificial_row_map(sf)
    cb = []
    for j in basis:
        j = int(j)
        cb.append(sf.c[j] if j < sf.n else ZERO)
    bt_cols = [[cols[k][i] for k in range(m)] for i in range(m)]
    y = _exact_gauss_solve(bt_cols, cb)
    del art_rows
    dual = True
    for j in range(sf.n):
        s = sf.c[j] - sum(sf.A[i][j] * y[i] for i in range(m))
        if s < 0:
            dual = False
            break
    return primal, dual


def float_basis_certificate(sf: StandardForm, basis: Sequence[int],
                            tol: float = 1e-7) -> Tuple[bool, bool]:
    """f64 version of ``exact_basis_certificate`` for instances too large to
    verify in rationals; tolerance-based, so it can only REJECT confidently
    (a pass within tol is 'not disproven', the best f64 can say)."""
    c64, A64, b64 = sf.to_dense(np.float64)
    m = sf.m
    art_rows = _artificial_row_map(sf)
    B = np.zeros((m, m))
    cb = np.zeros(m)
    for k, j in enumerate(basis):
        j = int(j)
        if j < sf.n:
            B[:, k] = A64[:, j]
            cb[k] = c64[j]
        else:
            B[art_rows[j - sf.n], k] = 1.0
    xb = np.linalg.solve(B, b64)
    scale = max(float(np.abs(b64).max()), 1.0)
    primal = bool((xb >= -tol * scale).all())
    for k, j in enumerate(basis):
        if int(j) >= sf.n and abs(xb[k]) > tol * scale:
            primal = False
    y = np.linalg.solve(B.T, cb)
    s = c64 - A64.T @ y
    cscale = max(float(np.abs(c64).max()), 1.0)
    dual = bool((s >= -tol * cscale).all())
    return primal, dual


def refine_basis_solution(
    sf: StandardForm,
    basis: Sequence[int],
    mode: str = "auto",
    exact_max_m: int = 192,
):
    """({col: value}, z_min) from the final basis.

    mode: 'exact' (rational Gauss), 'float64' (numpy solve on original f64
    data), 'auto' (exact for m <= exact_max_m else float64)."""
    if mode == "auto":
        mode = "exact" if sf.m <= exact_max_m else "float64"
    if mode == "exact":
        return exact_basis_solve(sf, basis)
    if mode != "float64":
        raise ValueError(f"unknown refine mode {mode!r}")
    c64, A64, b64 = sf.to_dense(np.float64)
    m = sf.m
    art_rows = _artificial_row_map(sf)
    B = np.zeros((m, m))
    for k, j in enumerate(basis):
        j = int(j)
        if j < sf.n:
            B[:, k] = A64[:, j]
        else:
            B[art_rows[j - sf.n], k] = 1.0
    xb = np.linalg.solve(B, b64)
    values = {}
    z = float(sf.obj_const)
    for k, j in enumerate(basis):
        j = int(j)
        if j < sf.n:
            values[j] = float(xb[k])
            z += float(c64[j]) * float(xb[k])
    return values, z
