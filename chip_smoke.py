#!/usr/bin/env python
"""Bring-up check: tpulp's main solve paths on the GPU, end to end.

    python chip_smoke.py             # phases a-h on one card
    python chip_smoke.py --cards 4   # the multi-card phase only, four cards

Every phase goes through the user entry points (``LinProg.solve``,
``solve_lp``, ``solve_lp_batch``, ``solve_milp``, the CLI's ``main``) and
prints one line per check: what it checked, against which reference, the
tolerance and the measured error. Any failure raises and the script exits
non-zero. The last line of standard output is the JSON contract
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it is ``nvidia-smi``'s name and power limit of the card.
On anything but a GPU the script exits non-zero and prints no result.

Phases: a device; b user surface (README LP/MILP, Beale, CLI on AFIRO);
c certified 512x1024 equality-heavy LP + the parity corpus; d the blocked
driver at 4096x8192 f32 for 1024 pivots; e a 64-lane batch against solo
solves; f the knapsack MILP against its DP optimum; g f32 products of the
warm frame and the integrality check against numpy f64; h the tests
marked ``gpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time
from fractions import Fraction

ROOT = os.path.dirname(os.path.abspath(__file__))
PARITY_GAP = 1e-9          # the repo's parity bar (BASELINE.md)
PRECISION_TOL = 1e-4       # full-f32 products pass; TF32 (~5e-4) does not
AFIRO_OPT = -464.75314285714285   # published, data/netlib/README.md


def contract_line(platform: str, kind: str, count: int) -> str:
    """The JSON object the last line of standard output must be."""
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def _exact(v) -> Fraction:
    return Fraction(v) if isinstance(v, (int, Fraction, str)) \
        else Fraction(float(v))


def rel_gap(value, reference) -> float:
    """|value - reference| / max(|reference|, 1), computed exactly."""
    ref = _exact(reference)
    return float(abs(_exact(value) - ref) / max(abs(ref), 1))


def report(phase: str, what: str, reference: str, tol, err) -> None:
    """One line per check; raises (so the script exits non-zero) when the
    measured error exceeds the tolerance."""
    ok = err <= tol
    print(f"[{phase}] {'PASS' if ok else 'FAIL'} {what} | reference: "
          f"{reference} | tolerance {tol:g} | measured {err:.3e}",
          flush=True)
    if not ok:
        raise AssertionError(f"phase {phase}: {what}: error {err} > {tol}")


def require(phase: str, cond: bool, what: str) -> None:
    print(f"[{phase}] {'PASS' if cond else 'FAIL'} {what}", flush=True)
    if not cond:
        raise AssertionError(f"phase {phase}: {what}")


# ---------------------------------------------------------------- phases

def phase_device(card_report) -> str:
    """a. The device as JAX sees it, and the card as nvidia-smi does."""
    import jax

    from tpulp.utils.compile_cache import compile_cache_dir

    devs = jax.devices()
    print(f"[a] platform={devs[0].platform} kind={devs[0].device_kind!r} "
          f"count={len(devs)} jax={jax.__version__} "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
          f"compile_cache={compile_cache_dir()}", flush=True)
    cards = card_report()
    for name, limit in cards:
        print(f"[a] card: {name}, {limit}", flush=True)
    return f"{cards[0][0]}, {cards[0][1]}"


def phase_user_surface() -> None:
    """b. README LP and MILP, Beale's LP, the CLI on netlib AFIRO."""
    from tpulp import LinExpr, LinProg
    from tpulp.__main__ import main as cli_main
    from tpulp.corpus import get_case
    from tpulp.solve import solve_lp

    lp = LinProg()
    lp.addVar("x1")
    lp.addVar("x2")
    lp.maximize(LinExpr(40, "x1", 30, "x2"))
    lp.addConstraint(LinExpr(1, "x1", 1, "x2").constraintLeq(12))
    lp.addConstraint(LinExpr(2, "x1", 1, "x2").constraintLeq(16))
    sol = lp.solve()
    require("b", sol.status == "optimal" and sol.x == {"x1": 4, "x2": 8},
            f"README LP: status {sol.status}, x {sol.x} == (4, 8)")
    report("b", "README LP objective", "exact 400", 0.0,
           rel_gap(sol.objective, 400))

    mp = LinProg()
    mp.addVar("n", integral=True, lb=0, ub=9)
    mp.addVar("x")
    mp.maximize(LinExpr(3, "n", 2, "x"))
    mp.addConstraint(LinExpr(1, "n", 1, "x").constraintLeq("7/2"))
    msol = mp.solve()
    # brute force over the integer n: x takes the rest of the 7/2 budget
    best = max(3 * n + 2 * (Fraction(7, 2) - n) for n in range(0, 4))
    require("b", msol.status == "optimal", "README MILP solves")
    report("b", "README MILP objective", f"brute force over n: {best}", 0.0,
           rel_gap(msol.objective, best))

    beale = solve_lp(get_case("beale").lp())
    report("b", "Beale's LP objective", "exact -1/20", 0.0,
           rel_gap(beale.objective, Fraction(-1, 20)))

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["solve", os.path.join(ROOT, "data", "netlib",
                                             "afiro.mps")])
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    require("b", rc == 0 and out["status"] == "optimal",
            f"CLI solve afiro.mps: rc {rc}, status {out['status']}")
    report("b", "CLI AFIRO objective", f"published {AFIRO_OPT}", PARITY_GAP,
           rel_gap(Fraction(out["objective"]), AFIRO_OPT))


def phase_certified(m=512, n=1024, seed=3, corpus=True) -> None:
    """c. The equality-heavy family at m x n through ``solve_lp`` defaults
    with f32 iterates and the full ladder, against the exact optimum by
    strong duality; then the whole parity corpus."""
    import jax.numpy as jnp

    import bench
    from tpulp.corpus import _dual_certificate_eq, _equality_heavy
    from tpulp.solve import solve_lp

    zopt = _dual_certificate_eq(m, n, seed)[4]
    lp = _equality_heavy(m, n, seed, f"eq{m}")()
    t0 = time.perf_counter()
    sol = solve_lp(lp, dtype=jnp.float32)
    dt = time.perf_counter() - t0
    require("c", sol.status == "optimal",
            f"equality-heavy {m}x{n}: status {sol.status}, rung {sol.rung}, "
            f"niter {sol.niter}, {dt:.3f} s")
    report("c", f"equality-heavy {m}x{n} objective",
           f"exact y.b = {zopt} by strong duality", PARITY_GAP,
           rel_gap(sol.objective, zopt))
    if not corpus:
        return
    n_ok, n_total, rows, rungs = bench.run_bench_corpus("float32")
    for name, status, niter, _, gap, secs, rung in rows:
        print(f"[c]   {name:24s} {status:10s} niter={niter:6d} "
              f"gap={'-' if gap is None else f'{gap:.2e}'} rung={rung} "
              f"{secs:.3f} s", flush=True)
    print(f"[c] rung table: {rungs}", flush=True)
    require("c", n_ok == n_total,
            f"corpus: {n_ok}/{n_total} at rel gap <= {PARITY_GAP:g} "
            "against exact oracles")


def phase_hot_path(m=4096, n=4096, pivots=1024, block=None,
                   card="not read", expect_engine="blocked") -> None:
    """d. The blocked driver on the dense bench instance for a fixed pivot
    budget: terminal basis against an f64 host solve of the original
    data, the engine chooser's verdict, compile time, memory, one warm
    time per pivot."""
    import jax
    import jax.numpy as jnp

    import bench
    from tpulp.core import SolverOptions
    from tpulp.solve.api import choose_engine
    from tpulp.solve.blocked import blocked_driver

    block = bench.DEFAULT_BLOCK if block is None else block
    eng = choose_engine(m, m + n)
    require("d", eng == expect_engine,
            f"choose_engine({m}, {m + n}) = {eng!r} (expected "
            f"{expect_engine!r})")
    state = jax.block_until_ready(
        bench.make_bench_state(m, n, jnp.float32, seed=0))
    fn, args = blocked_driver(
        state, SolverOptions.for_dtype(jnp.float32, max_iters=pivots), block)
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    t_compile = time.perf_counter() - t0
    print(f"[d] compiled blocked driver {m}x{m + n} f32 K={block} in "
          f"{t_compile:.3f} s; memory_analysis: "
          f"{compiled.memory_analysis()}", flush=True)
    out = jax.block_until_ready(compiled(*args))
    require("d", int(out.niter) == pivots,
            f"{int(out.niter)} of {pivots} pivots run (status "
            f"{int(out.status)})")
    gate = bench.verify_terminal_basis(out, m, n, 0, "float32")
    report("d", "terminal basis primal feasible on the original data",
           "f64 host solve of B x = b", gate["feas_gate"],
           max(0.0, -gate["min_xb"]))
    report("d", "tableau corner vs f64 basis objective",
           "f64 host solve of B x = b", gate["corner_gate"],
           abs(gate["corner_z"] - gate["basis_z64"]))
    t0 = time.perf_counter()
    jax.block_until_ready(compiled(*args))
    dt = time.perf_counter() - t0
    print(f"[d] warm call: {dt:.6f} s = {1e6 * dt / pivots:.3f} us/pivot "
          f"({pivots / dt:.1f} pivots/s) on {card}; printed, not claimed",
          flush=True)


def phase_batch(lanes=64, m=256, n=256, mesh=None, phase="e") -> None:
    """e. ``solve_lp_batch`` over the bench's bounded family against solo
    ``solve_lp`` on each lane's LP."""
    import bench
    from tpulp.batch import solve_lp_batch
    from tpulp.solve import solve_lp

    sfs = [bench.bench_standard_form(m, n, seed=i) for i in range(lanes)]
    t0 = time.perf_counter()
    sols = solve_lp_batch(sfs, mesh=mesh)
    dt = time.perf_counter() - t0
    statuses = [s.status for s in sols]
    require(phase, all(s == "optimal" for s in statuses),
            f"batch of {lanes} LPs {m}x{m + n}: "
            f"{statuses.count('optimal')}/{lanes} optimal in {dt:.3f} s"
            + ("" if mesh is None else f" on mesh {dict(mesh.shape)}"))
    worst = max(rel_gap(b.objective, solve_lp(sf).objective)
                for b, sf in zip(sols, sfs))
    report(phase, f"batch lane objectives ({lanes} lanes)",
           "solo solve_lp of each lane", PARITY_GAP, worst)


def phase_milp(n_items=28, batch_size=128, mesh=None, phase="f") -> None:
    """f. ``solve_milp`` on the bench knapsack against its DP optimum."""
    import bench

    rate, stats, obj, best = bench.run_bench_milp(
        n_items=n_items, batch_size=batch_size, mesh=mesh)
    print(f"[{phase}] BnbStats: waves={stats.waves} "
          f"nodes={stats.nodes_solved} t_assemble={stats.t_assemble:.4f} "
          f"t_device={stats.t_device:.4f} t_process={stats.t_process:.4f} "
          f"t_verify={stats.t_verify:.4f} ({rate:.1f} nodes/s)", flush=True)
    report(phase, f"knapsack-{n_items} MILP objective",
           f"dynamic-programming optimum {best}", 0.0, rel_gap(obj, best))


def phase_precision(m=512, n_struct=1024, lanes=8, n_int=256,
                    seed=0) -> None:
    """g. The warm-frame reconstruction and the B&B integrality check in
    f32 on the device, against numpy float64 on the same f32 inputs."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpulp.core import SimplexState, Status
    from tpulp.solve.dual import pack_wave_summary, warm_state_from_basis

    rng = np.random.default_rng(seed)
    # a well-conditioned basis (first m structural columns ~ I + noise), so
    # the error measured is the products', not the linear solve's
    D = rng.normal(size=(m, n_struct))
    D[:, :m] = np.eye(m) + 0.3 * rng.normal(size=(m, m)) / np.sqrt(m)
    A = np.concatenate([D, np.eye(m)], axis=1).astype(np.float32)
    n = A.shape[1]
    c = rng.normal(size=n).astype(np.float32)
    b = rng.normal(size=m).astype(np.float32)
    basis = rng.permutation(m).astype(np.int32)
    active = np.ones(n, bool)
    art = np.zeros(n, bool)
    frame = jax.block_until_ready(warm_state_from_basis(
        jnp.asarray(A), jnp.asarray(c), jnp.asarray(active),
        jnp.asarray(art), jnp.asarray(basis), jnp.asarray(b)))
    A64, c64, b64 = (x.astype(np.float64) for x in (A, c, b))
    rows = np.linalg.solve(A64[:, basis], np.concatenate(
        [A64, b64[:, None]], axis=1))
    red = np.concatenate([c64, [0.0]]) - c64[basis] @ rows
    red[basis] = 0.0
    T = np.asarray(frame.T, np.float64)
    nb = np.ones(n + 1, bool)
    nb[basis] = False
    err_rows = np.abs(T[2:, nb] - rows[:, nb]).max() / np.abs(rows).max()
    err_red = np.abs(T[0, nb] - red[nb]).max() / np.abs(red[nb]).max()
    report("g", f"warm frame B^-1 [A | b], m={m} f32",
           "numpy float64 on the same inputs", PRECISION_TOL, err_rows)
    report("g", f"warm frame reduced costs c - c_B B^-1 A, m={m} f32",
           "numpy float64 on the same inputs", PRECISION_TOL, err_red)

    Tl = rng.normal(size=(lanes, m + 2, n + 1)).astype(np.float32)
    bl = np.stack([rng.choice(n, m, replace=False)
                   for _ in range(lanes)]).astype(np.int32)
    R = rng.normal(size=(n_int, n)).astype(np.float32)
    const = rng.normal(size=n_int).astype(np.float32)
    out = SimplexState(
        T=jnp.asarray(Tl), basis=jnp.asarray(bl),
        col_active=jnp.ones((lanes, n), bool),
        art_cols=jnp.zeros((lanes, n), bool),
        phase=jnp.full((lanes,), 2, jnp.int32),
        status=jnp.full((lanes,), Status.OPTIMAL, jnp.int32),
        niter=jnp.zeros((lanes,), jnp.int32),
        stuck=jnp.zeros((lanes,), jnp.int32),
        bland=jnp.zeros((lanes,), bool),
        last_z=jnp.zeros((lanes,), jnp.float32))
    summ = np.asarray(jax.block_until_ready(pack_wave_summary(
        out, jnp.asarray(R), jnp.asarray(const))), np.float64)
    vals = summ[:, 6 + m:]
    errs = []
    for k in range(lanes):
        x = np.zeros(n)
        x[bl[k]] = Tl[k, 2:, -1]
        ref = R.astype(np.float64) @ x + const
        errs.append(np.abs(vals[k] - ref).max() / np.abs(ref).max())
    report("g", f"integrality check R @ x + const, {n_int}x{n} f32",
           "numpy float64 on the same inputs", PRECISION_TOL, max(errs))


def phase_gpu_tests() -> None:
    """h. The tests marked ``gpu``, in this process, on the card."""
    import pytest

    class Count:
        passed = failed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1
            elif report.failed:
                self.failed += 1

    counter = Count()
    os.environ["TPULP_TEST_DEVICE"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "--rootdir", ROOT, os.path.join(ROOT, "tests")],
                     plugins=[counter])
    require("h", rc == 0 and counter.passed > 0 and counter.failed == 0,
            f"pytest -m gpu: rc {int(rc)}, {counter.passed} passed, "
            f"{counter.failed} failed")


def phase_multicard(cards=4, m_eq=512, n_eq=1024, m=4096, n=4096,
                    pivots=1024, lanes=64, m_b=256, n_b=256,
                    n_items=28, batch_size=128) -> None:
    """The four-card phase: each mesh is 1D over ``cards`` devices."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    import bench
    from tpulp.core import SolverOptions
    from tpulp.corpus import _dual_certificate_eq, _equality_heavy
    from tpulp.shard import (from_sharded_state, make_mesh,
                             run_simplex_sharded_blocked, to_sharded_state)
    from tpulp.solve import solve_lp

    mesh = make_mesh(cards)
    zopt = _dual_certificate_eq(m_eq, n_eq, 3)[4]
    lp = _equality_heavy(m_eq, n_eq, 3, f"eq{m_eq}")()
    t0 = time.perf_counter()
    sol = solve_lp(lp, dtype=jnp.float32, mesh=mesh)
    dt = time.perf_counter() - t0
    solo = solve_lp(lp, dtype=jnp.float32)
    require("4", sol.status == "optimal",
            f"mesh solve_lp {m_eq}x{n_eq} on {cards} cards: {sol.status}, "
            f"rung {sol.rung}, niter {sol.niter}, {dt:.3f} s")
    report("4", f"mesh equality-heavy {m_eq}x{n_eq} objective",
           f"exact {zopt}", PARITY_GAP, rel_gap(sol.objective, zopt))
    report("4", f"mesh equality-heavy {m_eq}x{n_eq} objective",
           "solo solve_lp", PARITY_GAP, rel_gap(sol.objective, solo.objective))

    st = bench.make_bench_state(m, n, jnp.float32, seed=0)
    opts = SolverOptions.for_dtype(jnp.float32, max_iters=pivots)
    sh = to_sharded_state(st, mesh)
    for attempt in ("compile", "warm"):
        t0 = time.perf_counter()
        out_sh = jax.block_until_ready(run_simplex_sharded_blocked(
            sh, mesh, opts, block=bench.DEFAULT_BLOCK))
        dt = time.perf_counter() - t0
        print(f"[4] sharded blocked {m}x{m + n} f32 K={bench.DEFAULT_BLOCK} "
              f"{attempt} call: {dt:.6f} s", flush=True)
    out = from_sharded_state(out_sh, st.n)
    require("4", int(out.niter) == pivots,
            f"sharded blocked: {int(out.niter)} of {pivots} pivots; "
            f"{1e6 * dt / pivots:.3f} us/pivot warm (printed, not claimed)")
    gate = bench.verify_terminal_basis(out, m, n, 0, "float32")
    report("4", "sharded terminal basis primal feasible",
           "f64 host solve of B x = b", gate["feas_gate"],
           max(0.0, -gate["min_xb"]))
    report("4", "sharded tableau corner vs f64 basis objective",
           "f64 host solve of B x = b", gate["corner_gate"],
           abs(gate["corner_z"] - gate["basis_z64"]))

    bmesh = Mesh(np.array(jax.devices()[:cards]), ("batch",))
    phase_batch(lanes, m_b, n_b, mesh=bmesh, phase="4")
    phase_milp(n_items, batch_size, mesh=bmesh, phase="4")


# ------------------------------------------------------------------ main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=[1, 4],
                    help="4: run only the multi-card phase, over 4 cards")
    args = ap.parse_args(argv)

    import jax

    # before any array exists, so the precision ladder's f64 rung exists
    jax.config.update("jax_enable_x64", True)
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {devs[0].platform!r}",
              file=sys.stderr)
        return 2
    if len(devs) < args.cards:
        print(f"chip_smoke.py --cards {args.cards}: JAX sees {len(devs)} "
              "devices", file=sys.stderr)
        return 2

    sys.path.insert(0, ROOT)
    import bench
    from tpulp.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    card = phase_device(bench.card_report)
    if args.cards == 4:
        phase_multicard(cards=4)
    else:
        phase_user_surface()
        phase_certified()
        phase_hot_path(card=card)
        phase_batch()
        phase_milp()
        phase_precision()
        phase_gpu_tests()
    print(card)
    print(contract_line(devs[0].platform, devs[0].device_kind, len(devs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
