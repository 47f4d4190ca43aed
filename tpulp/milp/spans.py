"""Span-encoded B&B nodes: branch by rewriting bound VECTORS, not rows.

The default B&B encoding (``tpulp.milp.bnb``) gives every integer variable
a dedicated <=/>= tableau row pair so a node is a b-rewrite — which enables
the device dual-simplex warm starts, but costs two dense rows per integer
variable in EVERY node's tableau. This module is the complementary
encoding the round-4 batched bounded driver unlocked (BENCH.md "Batched
bounded-variable waves"): the root is lowered with ``simple_bounds=True``
(zero bound rows), and a node differs from the root in

* the per-column SPAN vector ``u_j = ub_j - lb_j`` (upper-branch moves), and
* the RHS ``b = b0 - A_J (lb - lb0)`` plus per-variable recover shifts
  (lower-branch moves re-shift the column to its new lower bound),

so a knapsack node's tableau is 1 row instead of 29. Waves run COLD through
the vmapped bounded-variable driver (no dual warm start exists for bounded
states yet); incumbents come from the batched extractor's exact refinement
+ bounded KKT certificate, so the reported optimum is exact, as in the rows
encoding.

Select with ``solve_milp(node_encoding='spans')``. Requirements: every
integer variable needs a finite lower bound and a plain shifted column
(free-split integer variables cannot be span-branched — the rows encoding
handles those).
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

import jax.numpy as jnp

from ..model.lower import StandardForm, lower_to_standard_form
from ..solve.api import Solution

__all__ = ["solve_milp_spans"]


def _int_columns(sf: StandardForm, names) -> Dict[str, int]:
    """Column index of each integer variable; raises if any is not a plain
    shifted column (terms == [(j, 1)])."""
    cols: Dict[str, int] = {}
    for name in names:
        terms, _ = sf.recover[name]
        if len(terms) != 1 or terms[0][1] != 1:
            raise ValueError(
                f"integer variable {name!r} is not a plain shifted column "
                "(free-split?); use node_encoding='rows'")
        cols[name] = terms[0][0]
    return cols


def _node_sf(root: StandardForm, cols: Dict[str, int],
             root_bounds, bounds) -> StandardForm:
    """The node's StandardForm: spans + RHS shift + recover consts."""
    b = list(root.b)
    upper = list(root.upper) if root.upper is not None \
        else [None] * root.n
    recover = dict(root.recover)
    obj_const = root.obj_const
    for name, (lb, ub) in bounds.items():
        lb0, _ = root_bounds[name]
        j = cols[name]
        if lb != lb0:
            # re-shift the column to its new lower bound: x = x' + lb moves
            # A_j lb into b AND c_j lb into the objective constant
            d = lb - lb0
            for i in range(root.m):
                a = root.A[i][j]
                if a:
                    b[i] = b[i] - a * d
            obj_const = obj_const + root.c[j] * d
            recover[name] = ([(j, Fraction(1))], lb)
        upper[j] = None if ub is None else ub - lb
    # a lower-bound shift can push b negative; standard form needs b >= 0,
    # so such rows are negated (copy-on-write A clone — the rare path) and
    # lose their ready slack basis column (the slack coefficient flips to
    # -1), falling back to a phase-1 artificial for that row
    neg_rows = [i for i in range(root.m) if b[i] < 0]
    if neg_rows:
        A = [list(row) for row in root.A]
        hint = list(root.basis_hint)
        for i in neg_rows:
            b[i] = -b[i]
            A[i] = [-a for a in A[i]]
            hint[i] = -1
        return dataclasses.replace(root, A=A, b=b, upper=upper,
                                   recover=recover, basis_hint=hint,
                                   obj_const=obj_const)
    return dataclasses.replace(root, b=b, upper=upper, recover=recover,
                               obj_const=obj_const)


def solve_milp_spans(
    prog,
    options=None,
    dtype=jnp.float64,
    batch_size: int = 64,
    max_nodes: int = 100_000,
    refine: str = "auto",
    int_tol: float = 1e-6,
    return_stats: bool = False,
):
    """Branch-and-bound with span-encoded nodes (see module doc).

    The public entry is ``solve_milp(..., node_encoding='spans')`` — that
    wrapper owns presolve and argument plumbing; this function assumes a
    presolved LinProg."""
    from .bnb import BnbStats, _most_fractional
    from ..batch.vmap_driver import (extract_batch_bounded_solutions,
                                     make_batched_bounded_states)
    from ..solve.bounded import run_simplex_bounded_batch
    from ..core.state import SolverOptions

    if options is None:
        options = SolverOptions.for_dtype(dtype)
    int_vars = {name: v for name, v in prog.vars.items() if v.isint}
    stats = BnbStats()
    if not int_vars:
        from ..solve.api import solve_lp

        sol = solve_lp(prog, options=options, dtype=dtype, refine="exact")
        return (sol, stats) if return_stats else sol
    for name, v in int_vars.items():
        if v.lb is None:
            raise ValueError(
                f"integer variable {name!r} has no finite lower bound; "
                "node_encoding='spans' needs one (use 'rows')")

    root_sf = lower_to_standard_form(prog, simple_bounds=True)
    if root_sf.trivially_infeasible:
        sol = Solution(status="infeasible")
        return (sol, stats) if return_stats else sol
    root_bounds: Dict[str, Tuple[Fraction, Optional[Fraction]]] = {
        name: (v.lb, v.ub) for name, v in int_vars.items()}
    cols = _int_columns(root_sf, root_bounds)
    branch_names = list(root_bounds)

    counter = itertools.count()
    frontier: List[Tuple] = []
    heapq.heappush(frontier,
                   (-1e18, next(counter), Fraction(-10**18), root_bounds))
    incumbent: Optional[Solution] = None
    incumbent_z: Optional[Fraction] = None

    def cannot_improve(bound) -> bool:
        return incumbent_z is not None and bound >= incumbent_z

    while frontier and stats.nodes_solved < max_nodes:
        wave = []
        while frontier and len(wave) < batch_size:
            _, _, bound, bounds = heapq.heappop(frontier)
            if cannot_improve(bound):
                stats.nodes_pruned_bound += 1
                continue
            wave.append(bounds)
        if not wave:
            break
        sfs = [_node_sf(root_sf, cols, root_bounds, bounds)
               for bounds in wave]
        bstate = make_batched_bounded_states(sfs, dtype=dtype)
        bout = run_simplex_bounded_batch(bstate, options)
        sols = extract_batch_bounded_solutions(sfs, bout, refine)
        stats.nodes_solved += len(wave)
        stats.waves += 1

        for bounds, sol in zip(wave, sols):
            if sol.status in ("numerical_error", "iteration_limit"):
                # re-solve solo through the full ladder (bounded path)
                from ..solve.api import solve_standard_form

                stats.solo_resolves += 1
                sf1 = _node_sf(root_sf, cols, root_bounds, bounds)
                sol = solve_standard_form(sf1, options=options, dtype=dtype,
                                          refine="exact")
            if sol.status == "infeasible":
                stats.nodes_pruned_infeasible += 1
                continue
            if sol.status == "unbounded":
                out = Solution(status="unbounded")
                return (out, stats) if return_stats else out
            if sol.status != "optimal":
                continue
            z = sol.objective_min
            if cannot_improve(z):
                stats.nodes_pruned_bound += 1
                continue
            vals = {name: Fraction(sol.x[name]) for name in branch_names}
            fractional = {n: v for n, v in vals.items()
                          if v.denominator != 1}
            if not fractional:
                if incumbent_z is None or z < incumbent_z:
                    incumbent, incumbent_z = sol, z
                    stats.incumbent_updates += 1
                continue
            frac_name = _most_fractional(fractional)
            val = vals[frac_name]
            lb, ub = bounds[frac_name]
            lo = Fraction(math.floor(val))
            hi = lo + 1
            zf = float(z)
            for child_lb, child_ub in ((lb, lo), (hi, ub)):
                if child_ub is not None and child_lb > child_ub:
                    continue
                child = dict(bounds)
                child[frac_name] = (child_lb, child_ub)
                heapq.heappush(frontier, (zf, next(counter), z, child))

    if incumbent is not None:
        status = "node_limit" if frontier else "optimal"
        gap = 0.0
        if frontier:
            best_open = min(zf for zf, *_ in frontier)
            inc_f = float(incumbent_z)
            gap = max(0.0, (inc_f - best_open) / max(abs(inc_f), 1.0))
        sol = dataclasses.replace(incumbent, status=status, mip_gap=gap)
    elif stats.nodes_solved >= max_nodes:
        sol = Solution(status="node_limit")
    else:
        sol = Solution(status="infeasible")
    return (sol, stats) if return_stats else sol
