"""tpulp — a device-native linear & mixed-integer programming framework.

Built from scratch on JAX/XLA with the capability surface of the
reference ``lpsol`` package (tkoz0/linear-program-solver) plus the layers it
promised but never implemented (LinProg lowering, MILP branch-and-bound), and
new accelerator layers: a jitted device simplex, batched (vmapped) solving, and
a column-sharded multi-chip mode. See SURVEY.md for the full blueprint.

Public API (reference parity, ``lpsol/__init__.py``): Tableau, Simplex,
LinExpr, LinCon, LinVar, LinProg — plus the new solver entry points.
"""

__version__ = "0.1.0"

from .model import (
    LinExpr,
    LinCon,
    LinVar,
    LinProg,
    StandardForm,
    lower_to_standard_form,
    MIN,
    MAX,
)
from .tableau import Tableau
from .simplex import Simplex, SolveStatus

__all__ = [
    "Tableau",
    "Simplex",
    "SolveStatus",
    "LinExpr",
    "LinCon",
    "LinVar",
    "LinProg",
    "StandardForm",
    "lower_to_standard_form",
    "MIN",
    "MAX",
    "solve_lp",
    "solve_milp",
    "Solution",
    "read_mps",
    "write_mps",
]


def __getattr__(name):
    # lazy imports so the exact host layer works without JAX present/initialized
    if name == "solve_lp":
        from .solve import solve_lp

        return solve_lp
    if name == "solve_milp":
        from .milp import solve_milp

        return solve_milp
    if name == "Solution":
        from .solve import Solution

        return Solution
    if name == "read_mps":
        from .io.mps import read_mps

        return read_mps
    if name == "write_mps":
        from .io.mps import write_mps

        return write_mps
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
