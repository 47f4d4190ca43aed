"""Exact-rational two-phase primal simplex (host side).

Capability parity with the reference ``Simplex`` (simplex.py:16-379): Phase-1
method of artificial variables (artificials only for rows missing a basic
column), Phase-2 pivot loop with Dantzig pricing and a Bland anti-cycling
fallback, checked teaching pivot, the four pivot-rule entry points
(findPivotStandard / findPivotMinIndex / findPivotMaxIncrease / findPivotAll),
and basis/BFS accessors.

This class doubles as the exact correctness oracle for the device solver
(``tpulp.solve``): tests compare f64 device objectives against its rational
results.

Fixes over the reference (SURVEY.md §2.7 — behaviors verified as bugs):
1. Redundant (linearly dependent) constraint rows are removed via
   ``Tableau.removeRows`` instead of field surgery that corrupted the row
   count (reference simplex.py:86-100).
2. Stall detection compares against the CURRENT objective value, so cycling
   entered after an improvement still triggers the Bland switch (reference
   compared against the initial value forever, simplex.py:118,134-137).
3. ``solve()`` returns a ``SolveStatus`` and never asserts on unbounded input
   (reference crashed with AssertionError, simplex.py:125-126,140-141).
4. ``Simplex(tab, on_infeasible='status')`` offers a non-raising construction
   path; the default keeps reference-compatible ValueError behavior.
"""

from __future__ import annotations

import enum
from fractions import Fraction
from typing import List, Optional, Tuple, Union

from .tableau import Tableau

__all__ = ["Simplex", "SolveStatus"]

ZERO = Fraction(0)

PivotResult = Union[Tuple[int, int], str]  # (row, col) | 'optimal' | 'unbounded'


class SolveStatus(enum.Enum):
    OPTIMAL = "optimal"
    UNBOUNDED = "unbounded"
    INFEASIBLE = "infeasible"
    ITERATION_LIMIT = "iteration_limit"


class Simplex:
    """Two-phase primal simplex over a ``Tableau`` (minimization).

    Holds the tableau by reference (no copy, like the reference simplex.py:26-31;
    pass ``copy=True`` to detach). Construction runs Phase 1 and raises
    ``ValueError`` on infeasibility unless ``on_infeasible='status'``.
    """

    def __init__(
        self,
        tab: Tableau,
        copy: bool = False,
        on_infeasible: str = "raise",
    ):
        self._tab = tab.copy() if copy else tab
        self._bfs: List[int] = [-1] * self._tab.getNumCons()
        self._status: Optional[SolveStatus] = None
        self.num_pivots: int = 0
        feasible = self._find_bfs()
        # phase 1 ran solve() internally; a fresh instance has no Phase-2
        # status yet
        self._status = None
        if not feasible:
            self._status = SolveStatus.INFEASIBLE
            if on_infeasible == "raise":
                raise ValueError(
                    f"infeasible problem, artificial optimum = {self._phase1_opt}")

    # -- phase 1 -------------------------------------------------------------

    def _find_bfs(self) -> bool:
        """Bring the tableau to canonical form; returns False if infeasible.

        Adds artificial variables only for rows that lack a ready basic
        column, minimizes their sum, then drives surviving artificials out of
        the basis; all-zero rows at that point are linearly dependent and get
        removed (correctly — fix #1)."""
        tab = self._tab
        m = tab.getNumCons()
        self._phase1_opt = ZERO

        # sign-normalize RHS
        for i in range(m):
            if tab.getBi(i) < 0:
                tab.rowMult(i, -1)

        # fast path: already canonical (fills the basis in one scan)
        if tab.isCanonical(self._bfs):
            self._mark_basis()
            return True

        n_orig = tab.getNumVars()
        saved_c = tab.getC()
        saved_z = tab.getZ()

        # which rows already own a basic column?
        have = list(self._bfs)  # isCanonical filled candidates (or -1)

        # phase-1 objective: minimize sum of artificials
        tab.setZ(0)
        tab.setC([0] * n_orig)
        art_rows: List[int] = [i for i in range(m) if have[i] < 0]
        art_cols: List[int] = []
        for i in art_rows:
            tab.addVar(f"$a{i}")  # '$' prefix cannot collide with model names
            j = tab.getNumVars() - 1
            tab.setAij(i, j, 1)
            tab.setCj(j, 1)
            tab.rowSubFromObj(i)  # reduce the new unit cost over row i
            self._bfs[i] = j
            art_cols.append(j)

        status = self.solve()
        if status is not SolveStatus.OPTIMAL:
            raise RuntimeError(
                f"phase-1 problem must be bounded, got {status}")
        self._phase1_opt = tab.getZ()
        if self._phase1_opt != 0:
            return False

        # drive artificials out of the basis; detect dependent rows
        art_set = set(art_cols)
        dead_rows: List[int] = []
        for i in range(m):
            if self._bfs[i] not in art_set:
                continue
            entering = -1
            for j in range(n_orig):
                if tab.getAij(i, j) != 0:
                    entering = j
                    break
            if entering >= 0:
                self._pivot(i, entering)
            else:
                dead_rows.append(i)  # linearly dependent constraint

        if dead_rows:
            tab.removeRows(dead_rows)
            self._bfs = [
                self._bfs[i] for i in range(m) if i not in set(dead_rows)
            ]
            m = tab.getNumCons()

        # remove artificial columns (trailing, so basis indices survive)
        tab.removeCols(art_cols)

        # restore the original objective, re-reduced over the final basis
        tab.setZ(saved_z)
        tab.setC(saved_c)
        for i in range(m):
            cj = saved_c[self._bfs[i]]
            if cj != 0:
                tab.rowSubFromObj(i, cj)

        check: List[int] = []
        if not tab.isCanonical(check):
            raise RuntimeError("phase 1 failed to reach canonical form")
        self._mark_basis()
        return True

    def _mark_basis(self) -> None:
        self._tab.setVarMarks([False] * self._tab.getNumVars())
        for j in self._bfs:
            if j >= 0:
                self._tab.setVarMark(j, True)

    # -- phase 2 -------------------------------------------------------------

    def solve(
        self,
        rule: str = "dantzig",
        max_pivots: Optional[int] = None,
    ) -> SolveStatus:
        """Pivot to optimality. Dantzig pricing with a permanent switch to
        Bland's rule after ``m+n`` consecutive pivots at an unchanged
        objective value (fix #2: the stall reference is the CURRENT value).
        Returns a status instead of asserting (fix #3)."""
        tab = self._tab
        m, n = tab.getTableauSize()
        stall_limit = m + n
        stalled = 0
        last_z = tab.getZ()
        use_bland = rule == "bland"
        finders = {
            "dantzig": self.findPivotStandard,
            "bland": self.findPivotMinIndex,
            "max_increase": self.findPivotMaxIncrease,
        }
        if rule not in finders:
            raise ValueError(f"unknown pivot rule {rule!r}")

        while True:
            if max_pivots is not None and self.num_pivots >= max_pivots:
                self._status = SolveStatus.ITERATION_LIMIT
                return self._status
            finder = self.findPivotMinIndex if use_bland else finders[rule]
            res = finder(do_pivot=True)
            if res == "optimal":
                self._status = SolveStatus.OPTIMAL
                return self._status
            if res == "unbounded":
                self._status = SolveStatus.UNBOUNDED
                return self._status
            z = tab.getZ()
            if z > last_z:
                raise RuntimeError("objective increased during minimization")
            if z == last_z:
                stalled += 1
                if stalled >= stall_limit:
                    use_bland = True  # Bland guarantees termination
            else:
                stalled = 0
                last_z = z

    # -- pivoting ------------------------------------------------------------

    def _pivot(self, r: int, c: int) -> None:
        old = self._bfs[r]
        self._tab.pivot(r, c)
        if old >= 0:
            self._tab.setVarMark(old, False)
        self._bfs[r] = c
        self._tab.setVarMark(c, True)
        self.num_pivots += 1

    def pivot(self, r: int, c: int) -> None:
        """Checked teaching pivot: refuses (ValueError) any pivot that fails
        the min-ratio test and would destroy feasibility
        (reference simplex.py:199-216)."""
        tab = self._tab
        m = tab.getNumCons()
        a_rc = tab.getAij(r, c)
        if a_rc <= 0:
            raise ValueError("bad pivot by min ratio test")
        best: Optional[Fraction] = None
        for i in range(m):
            a_ic = tab.getAij(i, c)
            if a_ic > 0:
                ratio = tab.getBi(i) / a_ic
                if best is None or ratio < best:
                    best = ratio
        if best is None or tab.getBi(r) / a_rc != best:
            raise ValueError("bad pivot by min ratio test")
        self._pivot(r, c)

    # -- pivot rules ---------------------------------------------------------
    # All return (row, col), 'optimal', or 'unbounded'; with do_pivot=True the
    # pivot is applied before returning (same contract as the reference).

    def _ratio_rows(self, c: int) -> Tuple[Optional[Fraction], List[int]]:
        """Min ratio over rows with positive column entry + the tie set."""
        tab = self._tab
        best: Optional[Fraction] = None
        ties: List[int] = []
        for i in range(tab.getNumCons()):
            a_ic = tab.getAij(i, c)
            if a_ic <= 0:
                continue
            ratio = tab.getBi(i) / a_ic
            if best is None or ratio < best:
                best = ratio
                ties = [i]
            elif ratio == best:
                ties.append(i)
        return best, ties

    def findPivotStandard(self, do_pivot: bool = False) -> PivotResult:
        """Dantzig rule: most-negative reduced cost (first on ties), then
        first row achieving the min ratio."""
        tab = self._tab
        c_best: Optional[Fraction] = None
        col = -1
        for j in range(tab.getNumVars()):
            cj = tab.getCj(j)
            if cj < 0 and (c_best is None or cj < c_best):
                c_best = cj
                col = j
        if col < 0:
            return "optimal"
        best, ties = self._ratio_rows(col)
        if best is None:
            return "unbounded"
        row = ties[0]
        if do_pivot:
            self._pivot(row, col)
        return (row, col)

    def findPivotMinIndex(self, do_pivot: bool = False) -> PivotResult:
        """Bland's rule: first improving column, first min-ratio row —
        guarantees no cycling."""
        tab = self._tab
        col = -1
        for j in range(tab.getNumVars()):
            if tab.getCj(j) < 0:
                col = j
                break
        if col < 0:
            return "optimal"
        best, ties = self._ratio_rows(col)
        if best is None:
            return "unbounded"
        row = ties[0]
        if do_pivot:
            self._pivot(row, col)
        return (row, col)

    def findPivotMaxIncrease(self, do_pivot: bool = False) -> PivotResult:
        """Greatest-improvement rule: over all improving columns, pick the
        pivot with the largest objective decrease |c_j| * min_ratio. Scans the
        whole tableau (reference simplex.py:286-328)."""
        tab = self._tab
        best_dec: Optional[Fraction] = None
        choice: Optional[Tuple[int, int]] = None
        any_improving = False
        for j in range(tab.getNumVars()):
            cj = tab.getCj(j)
            if cj >= 0:
                continue
            any_improving = True
            ratio, ties = self._ratio_rows(j)
            if ratio is None:
                continue
            dec = -cj * ratio
            if best_dec is None or dec > best_dec:
                best_dec = dec
                choice = (ties[0], j)
        if not any_improving:
            return "optimal"
        if choice is None:
            return "unbounded"
        if do_pivot:
            self._pivot(*choice)
        return choice

    def findPivotAll(self) -> List[Tuple[int, int]]:
        """Every feasibility-preserving pivot: for each improving-or-not
        column, the full min-ratio tie set (teaching / degeneracy-exploration
        tool, reference simplex.py:330-360)."""
        out: List[Tuple[int, int]] = []
        for j in range(self._tab.getNumVars()):
            _, ties = self._ratio_rows(j)
            out.extend((i, j) for i in ties)
        return out

    # -- accessors -----------------------------------------------------------

    def getStatus(self) -> Optional[SolveStatus]:
        return self._status

    def getTableau(self) -> Tableau:
        return self._tab

    def getBasicSequence(self) -> List[int]:
        """Basic column per row (a copy — the reference leaked the live
        list, simplex.py:150-155)."""
        return list(self._bfs)

    def getBasicSequenceNames(self) -> List[str]:
        return [self._tab.getVarName(j) for j in self._bfs]

    def getBFS(self) -> dict:
        """{basic column index: value}; nonbasic variables are 0."""
        return {
            self._bfs[i]: self._tab.getBi(i)
            for i in range(self._tab.getNumCons())
        }

    def getBFSNames(self) -> dict:
        """{basic variable name: value} (assumes unique names)."""
        return {
            self._tab.getVarName(self._bfs[i]): self._tab.getBi(i)
            for i in range(self._tab.getNumCons())
        }

    def getObjValue(self) -> Fraction:
        """Objective value (minimization convention)."""
        return self._tab.getZ()

    def __str__(self) -> str:
        names = ",".join(self.getBasicSequenceNames())
        vals = ",".join(str(v) for v in self.getBFS().values())
        return f"{self._tab}\nBFS: ({names}) = ({vals})"

    def __repr__(self) -> str:
        m, n = self._tab.getTableauSize()
        return f"<Simplex {m}x{n} z={self._tab.getZ()} status={self._status}>"
