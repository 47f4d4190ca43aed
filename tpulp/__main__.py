"""Command-line interface: solve and render LP/MILP problems.

    python -m tpulp solve model.json [--exact] [--rule dantzig|bland]
    python -m tpulp solve-tableau tableau.json [--device]
    python -m tpulp render tableau.json [--format text|latex|csv|grid]

``model.json`` uses the tpulp model schema (tpulp.model.serialize);
``tableau.json`` uses the reference-compatible tableau schema.
"""

from __future__ import annotations

import argparse
import json
import sys


def _cmd_solve(args) -> int:
    is_mps = args.file.lower().endswith(".mps")
    if is_mps:
        from .io.mps import read_mps

        prog = read_mps(args.file)
    else:
        from .model.serialize import load_prog

        prog = load_prog(args.file)
    # presolve defaults ON for MPS input (real-world files carry the
    # redundancy presolve pays for); --no-presolve opts out
    if args.no_presolve:
        args.presolve = False
    elif is_mps:
        args.presolve = True
    if args.exact and not prog.isMixedInteger():
        from .simplex import Simplex
        from .tableau import Tableau

        res = None
        if args.presolve:
            # presolve is exact Fraction arithmetic, so it composes with the
            # exact host simplex (advisor finding: it used to be silently
            # ignored on this path)
            from .model.presolve import presolve

            res = presolve(prog)
            if res.status is not None:
                print(json.dumps({"status": res.status}))
                return 0
            prog = res.prog
            if res.unbounded_if_feasible and not prog.allVarNames():
                print(json.dumps({"status": "unbounded"}))
                return 0

        sf = prog.lower()
        tab = Tableau.fromArrays(sf.c, sf.A, sf.b, names=sf.col_names)
        sx = Simplex(tab, on_infeasible="status")
        if sx.getStatus() is not None:
            print(json.dumps({"status": "infeasible"}))
            return 0
        status = sx.solve(rule=args.rule)
        if res is not None and res.unbounded_if_feasible:
            # the reduced program is feasible, so the dangling improving
            # column makes the original unbounded
            print(json.dumps({"status": "unbounded"}))
            return 0
        from fractions import Fraction

        xc = [sx.getBFS().get(j, Fraction(0)) for j in range(sf.n)]
        x = sf.recover_solution(xc)
        if res is not None:
            x = res.recover(x)
        out = {
            "status": status.value,
            "objective": str(sf.objective_value(xc)),
            "x": {k: str(v) for k, v in x.items()},
            "pivots": sx.num_pivots,
        }
        print(json.dumps(out))
        return 0

    kwargs = {}
    if getattr(args, "warm_basis", None) and not prog.isMixedInteger():
        # a basis saved by --save-basis warm-starts this re-solve
        # (tpulp.solve.api warm_basis; presolve would change the
        # column space, so the two options are mutually exclusive)
        from .solve.api import Solution as _Sol

        if args.presolve:
            print("error: --warm-basis does not compose with --presolve "
                  "(presolve changes the basis column space)",
                  file=sys.stderr)
            return 2
        with open(args.warm_basis) as fh:
            wb = json.load(fh)["basis"]
        kwargs["warm_start"] = _Sol(status="optimal", basis=wb)
    if getattr(args, "ranging", False):
        if prog.isMixedInteger():
            print("error: --ranging applies to LPs only (a MILP optimum "
                  "has no basis whose optimality an interval could "
                  "preserve)", file=sys.stderr)
            return 2
        if args.presolve:
            print("error: --ranging does not compose with --presolve "
                  "(presolve reductions change the coefficients the "
                  "intervals would describe)", file=sys.stderr)
            return 2
        kwargs["ranging"] = True
    if getattr(args, "certificates", False):
        if prog.isMixedInteger():
            print("error: --certificates applies to LPs only (MILP "
                  "infeasibility/unboundedness is a lattice statement the "
                  "LP certificates do not prove)", file=sys.stderr)
            return 2
        if args.presolve:
            print("error: --certificates does not compose with --presolve "
                  "(the vectors live on the UNREDUCED standard-form rows; "
                  "use --no-presolve)", file=sys.stderr)
            return 2
        kwargs["certificates"] = True
    if getattr(args, "pricing", "default") != "default" \
            and not prog.isMixedInteger():
        kwargs["pricing"] = args.pricing
    if getattr(args, "scale", "auto") != "auto" \
            and not prog.isMixedInteger():
        kwargs["scale"] = args.scale
    if prog.isMixedInteger():
        if getattr(args, "branching", "most_fractional") != "most_fractional":
            kwargs["branching"] = args.branching
        if getattr(args, "node_encoding", "rows") != "rows":
            kwargs["node_encoding"] = args.node_encoding
        dg = getattr(args, "device_generations", None)
        if dg is not None:
            kwargs["device_generations"] = dg
        if getattr(args, "time_limit", None) is not None:
            kwargs["time_limit"] = args.time_limit
        if getattr(args, "gap_tol", 0.0):
            kwargs["gap_tol"] = args.gap_tol
    sol = prog.solve(presolve=args.presolve, **kwargs)
    out = {"status": sol.status}
    if sol.is_optimal or sol.x is not None:
        # early-stopped MILP solves (time_limit/gap_limit/node_limit)
        # still carry their best exact-verified incumbent
        out["objective"] = str(sol.objective)
        out["x"] = {k: str(v) for k, v in (sol.x or {}).items()}
        out["iterations"] = sol.niter
    if sol.mip_gap is not None and sol.mip_gap > 0:
        out["mip_gap"] = sol.mip_gap
    if getattr(sol, "farkas", None) is not None:
        out["farkas"] = [str(v) for v in sol.farkas]
    if getattr(sol, "ray", None) is not None:
        out["ray"] = [str(v) for v in sol.ray]
    if getattr(args, "iis", False) and sol.status == "infeasible":
        from .solve.iis import find_iis

        try:
            out["iis"] = find_iis(prog)
        except ValueError as e:
            # integer-infeasible with a feasible LP relaxation: an IIS
            # (an LP notion) does not exist — report why, don't crash
            out["iis"] = None
            out["iis_note"] = str(e)
    if sol.cost_ranging is not None:
        def _iv(rng):
            if rng is None:
                return None
            return [None if v is None else str(v) for v in rng]

        out["cost_ranging"] = {k: _iv(v)
                               for k, v in sol.cost_ranging.items()}
        out["rhs_ranging"] = {str(k): _iv(v)
                              for k, v in sol.rhs_ranging.items()}
    if getattr(args, "save_basis", None) and sol.basis is not None:
        with open(args.save_basis, "w") as fh:
            json.dump({"basis": list(map(int, sol.basis))}, fh)
    print(json.dumps(out))
    return 0


def _cmd_solve_tableau(args) -> int:
    from .tableau import Tableau

    tab = Tableau(1, 1)
    tab.loadFile(args.file)
    if args.device:
        import numpy as np

        from .core import make_state
        from .solve import run_simplex, extract_solution

        hints = [-1] * tab.getNumCons()
        tab2 = tab.copy()
        # sign-normalize for the device path (expects b >= 0)
        for i in range(tab2.getNumCons()):
            if tab2.getBi(i) < 0:
                tab2.rowMult(i, -1)
        bcols = []
        tab2.isCanonical(bcols)
        hints = bcols
        state = make_state(
            [float(v) for v in tab2.getC()],
            [[float(v) for v in row] for row in tab2.getA()],
            [float(v) for v in tab2.getB()],
            hints,
        )
        out_state = run_simplex(state)
        from .core.state import Status

        x, z = extract_solution(out_state)
        # make_state drops the tableau's initial corner: add the initial z
        # offset back to report the absolute objective
        print(json.dumps({
            "status": Status.NAMES.get(int(out_state.status), "unknown"),
            "objective": float(z) + float(tab2.getZ()),
            "iterations": int(out_state.niter),
        }))
        return 0

    from .simplex import Simplex

    sx = Simplex(tab, on_infeasible="status")
    if sx.getStatus() is not None:
        print(json.dumps({"status": "infeasible"}))
        return 0
    status = sx.solve(rule=args.rule)
    print(json.dumps({
        "status": status.value,
        "objective": str(sx.getObjValue()),
        "bfs": {k: str(v) for k, v in sx.getBFSNames().items()},
        "pivots": sx.num_pivots,
    }))
    return 0


def _cmd_render(args) -> int:
    from .tableau import Tableau

    tab = Tableau(1, 1)
    tab.loadFile(args.file)
    if args.format == "text":
        print(tab.printText())
    elif args.format == "latex":
        print(tab.printLatex())
    elif args.format == "csv":
        print(tab.printCSV(), end="")
    else:
        from .io.grid import format_grid

        print(format_grid(tab))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpulp")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p1 = sub.add_parser("solve", help="solve a model-schema LP/MILP json")
    p1.add_argument("file")
    p1.add_argument("--exact", action="store_true",
                    help="use the exact-rational host simplex (LP only)")
    p1.add_argument("--rule", default="dantzig",
                    choices=["dantzig", "bland", "max_increase"])
    p1.add_argument("--presolve", action="store_true",
                    help="exact presolve (fixings, singleton/duplicate "
                         "rows, empty columns) before the device solve; "
                         "DEFAULT for .mps input")
    p1.add_argument("--no-presolve", action="store_true",
                    help="disable presolve (overrides the .mps default)")
    p1.add_argument("--branching", default="most_fractional",
                    choices=["most_fractional", "pseudocost"],
                    help="MILP branch-variable rule")
    p1.add_argument("--node-encoding", default="rows",
                    choices=["rows", "spans"], dest="node_encoding",
                    help="MILP node encoding. 'spans' (bound-free tableaus) "
                         "is EXPERIMENTAL and slower than 'rows' on set "
                         "cover (cold waves only): its win condition needs a bounded-state dual simplex with "
                         "device node templates, which is not built. Keep "
                         "the default unless reproducing that analysis")
    p1.add_argument("--certificates", action="store_true",
                    help="attach an exact PROOF to a terminal LP verdict: "
                         "infeasible -> Farkas vector (y.A <= 0, y.b > 0), "
                         "unbounded -> improving ray (A d = 0, d >= 0, "
                         "c.d = -1), both exact rationals over the "
                         "standard-form rows/columns (LP only)")
    p1.add_argument("--iis", action="store_true",
                    help="on an infeasible model, also report an "
                         "Irreducible Infeasible Subsystem: a minimal set "
                         "of constraints (names where named, else indices) "
                         "that conflict — removing any one member makes "
                         "the rest feasible (deletion filter, exact host "
                         "oracle up to 192 rows)")
    p1.add_argument("--ranging", action="store_true",
                    help="report post-optimal sensitivity ranging: the "
                         "interval of each objective coefficient and each "
                         "constraint rhs over which the optimal basis "
                         "stays optimal (LP only; not with --presolve, "
                         "whose reductions change the data the intervals "
                         "would describe)")
    p1.add_argument("--save-basis", default=None, dest="save_basis",
                    help="write the terminal basis (augmented-column "
                         "indices, JSON) for later --warm-basis re-solves")
    p1.add_argument("--warm-basis", default=None, dest="warm_basis",
                    help="warm-start an LP re-solve from a basis saved by "
                         "--save-basis on a SAME-STRUCTURE model (RHS/"
                         "objective edits); not compatible with --presolve")
    p1.add_argument("--time-limit", type=float, default=None,
                    dest="time_limit",
                    help="MILP wall-clock budget in seconds (checked at "
                         "wave boundaries); returns the best incumbent "
                         "with status 'time_limit' and its proven mip_gap")
    p1.add_argument("--gap", type=float, default=0.0, dest="gap_tol",
                    help="MILP relative optimality-gap stop: end the "
                         "search once the proven gap between the exact "
                         "incumbent and the best open bound is <= this "
                         "(status 'gap_limit'; 'optimal' stays gap-zero)")
    p1.add_argument("--pricing", default="default",
                    choices=["default", "devex"],
                    help="device pricing rule for LP solves (devex: far "
                         "fewer pivots on equality-heavy instances)")
    p1.add_argument("--scale", default="auto",
                    choices=["auto", "force", "none"],
                    help="geometric-mean power-of-two equilibration of the "
                         "device data (LP solves; auto = when material)")
    p1.add_argument("--device-generations", type=int, default=None,
                    dest="device_generations",
                    help="MILP: B&B generations expanded on device per "
                         "host round trip (default 6; 0/1 disables)")
    p1.set_defaults(fn=_cmd_solve)

    p2 = sub.add_parser("solve-tableau",
                        help="solve a reference-schema tableau json")
    p2.add_argument("file")
    p2.add_argument("--device", action="store_true",
                    help="solve on the JAX device path instead of exactly")
    p2.add_argument("--rule", default="dantzig",
                    choices=["dantzig", "bland", "max_increase"])
    p2.set_defaults(fn=_cmd_solve_tableau)

    p3 = sub.add_parser("render", help="pretty-print a tableau json")
    p3.add_argument("file")
    p3.add_argument("--format", default="text",
                    choices=["text", "latex", "csv", "grid"])
    p3.set_defaults(fn=_cmd_render)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    sys.exit(main())
