#!/usr/bin/env python
"""Benchmark: simplex pivot throughput and the solve modes, on one GPU.

Modes (``--mode``):

* ``single`` times the rank-K blocked driver (or rank-1) on a dense
  4096x8192 canonical-form tableau (A = [D | I], D 4096x4096 dense) for a
  fixed pivot budget; ``--block 32,64,128,256`` sweeps the block size;
* ``batch`` times one vmapped device call over many independent LPs;
* ``milp`` solves a 28-item 0/1 knapsack to proven optimality;
* ``corpus`` runs the exact-parity corpus through the precision ladder.

Every call is timed to ``jax.block_until_ready``. Each JSON line names the
device as JAX reports it (platform, ``device_kind``, count) and the card
as ``nvidia-smi`` does (name, power limit). The bench refuses to run
anywhere but a GPU.

    python bench.py --mode single --block 32,64,128,256 [--profile]
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

# Published peaks by ``device_kind``: dense rates without sparsity, at the
# card's full 700 W power limit. A device that is not listed is an error,
# never a default.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "f32_flops_per_s": 67e12,     # outside the tensor cores
        "f64_flops_per_s": 34e12,     # outside the tensor cores
        "tf32_flops_per_s": 495e12,
        "source": "NVIDIA H100 Tensor Core GPU data sheet, SXM",
    },
}


# rank-K block of the blocked driver: the fastest of the K sweep
# {32, 64, 128, 256} at 4096x8192 f32 on an H100 at 700 W (PERF.md)
DEFAULT_BLOCK = 128


def device_peaks(kind: str) -> dict:
    """Published peaks of the device ``kind`` (``jax.Device.device_kind``)."""
    try:
        return DEVICE_PEAKS[kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device_kind {kind!r}; add them to "
            "bench.DEVICE_PEAKS with their source") from None


def card_report() -> list:
    """``[name, power_limit]`` of each card, read by ``nvidia-smi`` in a
    child process that never imports JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [[f.strip() for f in ln.split(",", 1)]
            for ln in out.stdout.strip().splitlines()]


def device_report() -> dict:
    """The device as JAX reports it, and the card as nvidia-smi does."""
    import jax

    devs = jax.devices()
    rep = {"device": {"platform": devs[0].platform,
                      "kind": devs[0].device_kind, "count": len(devs)}}
    if devs[0].platform == "gpu":
        name, limit = card_report()[0]
        rep["card"] = {"name": name, "power_limit": limit}
    return rep


def require_gpu() -> None:
    """Exit non-zero unless JAX's first device is a GPU: a number taken
    anywhere else is not a device measurement."""
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(f"bench.py measures the GPU; JAX found {platform!r}",
              file=sys.stderr)
        raise SystemExit(2)


def bench_data(m, n_struct, seed=0, bounded=False):
    """(c, A, b) of the dense bench family: A = [D | I] over ``m`` rows and
    ``n_struct`` dense structural columns, b >= 0 so the slack basis is a
    primal-feasible canonical start. ``bounded`` replaces the last row with
    sum(x) <= 2 sum(x0), so every instance has a finite optimum (with a
    free-sign c about half of the unmodified ones are unbounded)."""
    rng = np.random.default_rng(seed)
    D = rng.normal(size=(m, n_struct))
    x0 = np.abs(rng.normal(size=n_struct))
    b = np.abs(D @ x0) + np.abs(rng.normal(size=m))
    c = rng.normal(size=n_struct)
    if bounded:
        D[-1] = 1.0
        b[-1] = 2.0 * x0.sum()
    A = np.concatenate([D, np.eye(m)], axis=1)
    cfull = np.concatenate([c, np.zeros(m)])
    return cfull, A, b


def make_bench_state(m, n_struct, dtype, seed=0, bounded=False,
                     _numpy=False):
    from tpulp.core import make_state

    cfull, A, b = bench_data(m, n_struct, seed, bounded)
    hint = list(range(n_struct, n_struct + m))
    return make_state(cfull, A, b, hint, dtype=dtype, _numpy=_numpy)


def bench_standard_form(m, n_struct, seed=0, bounded=True):
    """The bench instance as a ``StandardForm`` (exact rationals of the
    same float data), for the user entry points ``solve_lp`` and
    ``solve_lp_batch``."""
    from fractions import Fraction

    from tpulp.model.lower import StandardForm

    cfull, A, b = bench_data(m, n_struct, seed, bounded)
    names = [f"x{j}" for j in range(n_struct)] + [f"_s{i}" for i in range(m)]
    return StandardForm(
        c=[Fraction(float(v)) for v in cfull],
        A=[[Fraction(float(v)) for v in row] for row in A],
        b=[Fraction(float(v)) for v in b],
        col_names=names,
        obj_const=Fraction(0),
        sense="min",
        basis_hint=list(range(n_struct, n_struct + m)),
        recover={f"x{j}": ([(j, Fraction(1))], Fraction(0))
                 for j in range(n_struct)},
        n_struct=n_struct,
        row_provenance=[("con", i, 1) for i in range(m)],
    )


def parity_check():
    """Device objective must match the reference's exact value on its
    textbook LP (rel gap <= 1e-9; here it is exact by refinement)."""
    from fractions import Fraction

    from tpulp import LinExpr, LinProg
    from tpulp.solve import solve_lp

    lp = LinProg()
    lp.addVar("x1")
    lp.addVar("x2")
    lp.maximize(LinExpr(40, "x1", 30, "x2"))
    lp.addConstraint(LinExpr(1, "x1", 1, "x2").constraintLeq(12))
    lp.addConstraint(LinExpr(2, "x1", 1, "x2").constraintLeq(16))
    sol = solve_lp(lp)
    assert sol.status == "optimal" and sol.objective == 400, (
        sol.status, sol.objective)


def _basis_certificate(basis, Afull, b, cfull, exclude=None):
    """f64 primal/dual verification of a terminal basis on the ORIGINAL
    data: returns (z64, min_xb, min_reduced_cost). A basis with min_xb >= 0
    and min_reduced_cost >= 0 is PROVEN optimal (strong duality) — a far
    stronger in-bench check than comparing one float objective. ``exclude``
    masks columns (phase-1 artificials) out of the dual check: they are not
    part of the real LP, so their prices carry no meaning."""
    basis = [int(j) for j in np.asarray(basis)]
    B = Afull[:, basis]
    xb = np.linalg.solve(B, b.astype(np.float64))
    z64 = float(cfull[basis] @ xb)
    y = np.linalg.solve(B.T, cfull[basis])
    s = cfull - Afull.T @ y
    nb = np.ones(Afull.shape[1], dtype=bool)
    nb[basis] = False
    if exclude is not None:
        nb &= ~np.asarray(exclude, dtype=bool)
    return z64, float(xb.min()), float(s[nb].min())


def _pin_instances():
    """The compiled-pin instance set (VERDICT r3 weak #2 / item 9): each
    entry is (name, state-builder(dtype), rule, block, expect_deep_phase1).
    Instances are chosen to exercise distinct compiled code paths:

    * random64_dantzig — the original r2 pin: tame dense slack-start LP,
      ~200 Dantzig pivots, no phase 1 (caught the Tt-transpose drift bug).
    * random24_bland   — a shorter instance under forced RULE_BLAND: the
      first-index pricing/row rules are the compiled path Dantzig skips.
    * random64_devex   — same instance under RULE_DEVEX: the round-4 weight
      carry in the kernel.
    * eqheavy_phase1   — integer-data equality system: EVERY row needs an
      artificial, so the compiled kernel runs a deep phase 1, the in-block
      phase transition, and artificial cleanup; K=8 forces the transition
      to cross flush boundaries.
    * degenerate_ties  — several b entries are 0: ratio-test ties at zero
      exercise the first-index tie-break and stall/Bland machinery.

    Every pin is judged by the f64 primal/dual certificate on its terminal
    basis (optimality proven outright, no golden constants), plus an exact
    rational host-oracle objective computed at bench time for the Dantzig
    pins (regeneration recipe = this code; the oracle is
    tpulp.simplex.Simplex on the same arrays)."""
    from tpulp.core import RULE_BLAND, RULE_DANTZIG, RULE_DEVEX

    def _random_dense(dtype, m, n, seed=0):
        from tpulp.core import make_state

        rng = np.random.default_rng(seed)
        A = rng.integers(-3, 4, size=(m, n)).astype(float)
        x0 = rng.integers(1, 4, size=n).astype(float)
        b = A @ x0 + rng.integers(1, 5, size=m)
        c = rng.integers(-5, 6, size=n).astype(float)
        Afull = np.concatenate([A, np.eye(m)], axis=1)
        cfull = np.concatenate([c, np.zeros(m)])
        st = make_state(cfull, Afull, b, list(range(n, n + m)), dtype=dtype)
        return st, Afull, b.astype(float), cfull

    def random64(dtype):
        return _random_dense(dtype, 64, 64, seed=0)

    def random24(dtype):
        # Bland runs the FULL walk under the first-index rule, which at f32
        # accumulates drift much faster than Dantzig (small improvements,
        # near-tolerance pivot elements) — a short walk keeps the pin about
        # code-path correctness instead of float endurance
        return _random_dense(dtype, 24, 24, seed=1)

    def degenerate(dtype):
        from tpulp.core import make_state

        rng = np.random.default_rng(3)
        m, n = 64, 64
        A = rng.integers(-2, 3, size=(m, n)).astype(float)
        x0 = rng.integers(0, 3, size=n).astype(float)
        b = np.abs(A @ x0) + rng.integers(0, 3, size=m)
        b[::5] = 0.0                    # forced zero RHS: degenerate start
        c = rng.integers(-4, 5, size=n).astype(float)
        A[-1] = 1.0                     # sum(x) <= b[-1]: polytope bounded
        b[-1] = max(float(b.max()) * 2, 10.0)
        Afull = np.concatenate([A, np.eye(m)], axis=1)
        cfull = np.concatenate([c, np.zeros(m)])
        st = make_state(cfull, Afull, b, list(range(n, n + m)), dtype=dtype)
        return st, Afull, b, cfull

    def eqheavy(dtype):
        from tpulp.solve.api import state_from_standard_form
        from tpulp import LinExpr, LinProg

        rng = np.random.default_rng(11)
        m, n = 32, 64
        A = rng.integers(-2, 3, size=(m, n)).astype(int)
        x0 = rng.integers(1, 3, size=n).astype(int)
        b = A @ x0
        c = rng.integers(-4, 5, size=n).astype(int)
        lp = LinProg()
        for j in range(n):
            lp.addVar(f"x{j}")
        obj = LinExpr()
        for j in range(n):
            obj += LinExpr(int(c[j]), f"x{j}")
        lp.minimize(obj)
        for i in range(m):
            e = LinExpr()
            for j in range(n):
                if A[i, j]:
                    e += LinExpr(int(A[i, j]), f"x{j}")
            lp.addConstraint(e.constraintEq(int(b[i])))
        sf = lp.lower()
        st = state_from_standard_form(sf, dtype=dtype)
        # reconstruct full arrays (incl. artificials as unit columns) for
        # the f64 certificate; at setup row 0 holds the raw phase-2 costs
        # (the all-artificial start basis has zero cost, so nothing was
        # reduced) and artificial columns are masked out of the dual check
        T = np.asarray(st.T, dtype=np.float64)
        Afull = T[2:, :-1].copy()
        bfull = T[2:, -1].copy()
        cfull = T[0, :-1].copy()
        return st, Afull, bfull, cfull

    return [
        ("random64_dantzig", random64, RULE_DANTZIG, 8, False),
        ("random24_bland", random24, RULE_BLAND, 8, False),
        ("random64_devex", random64, RULE_DEVEX, 8, False),
        ("eqheavy_phase1", eqheavy, RULE_DANTZIG, 8, True),
        ("degenerate_ties", degenerate, RULE_DANTZIG, 8, False),
    ]


def compiled_pin_suite(names=None):
    """Run the correctness pins on the compiled blocked driver; returns a
    list of per-pin evidence dicts for the bench JSON line. The bench dies
    loudly (no JSON line) on any pin failure — a fast-but-wrong compiled
    binary must not produce a number."""
    import dataclasses as _dc

    import jax.numpy as jnp

    from tpulp.core import SolverOptions
    from tpulp.solve.blocked import run_simplex_blocked

    results = []
    for name, build, rule, block, deep_p1 in _pin_instances():
        if names is not None and name not in names:
            continue
        st, Afull, b, cfull = build(jnp.float32)
        opts = _dc.replace(
            SolverOptions.for_dtype(jnp.float32, max_iters=4000), rule=rule)
        out = run_simplex_blocked(st, opts, block=block)
        s, niter = int(out.status), int(out.niter)
        z_corner = float(out.objective())
        ok = s == 1 and niter > 20
        z64 = min_xb = min_rc = None
        if ok:
            art = np.asarray(st.art_cols)
            exclude = np.zeros(Afull.shape[1], dtype=bool)
            exclude[:art.shape[0]] = art
            z64, min_xb, min_rc = _basis_certificate(
                out.basis, Afull, b, cfull, exclude=exclude)
            # strong-duality certificate: terminal basis proven optimal
            ok = min_xb >= -1e-7 and min_rc >= -1e-6
        rec = {"pin": name, "block": block,
               "status": s, "niter": niter, "corner_z": round(z_corner, 6),
               "basis_z64": None if z64 is None else round(z64, 9),
               "min_xb": min_xb, "min_reduced_cost": min_rc,
               "ok": bool(ok)}
        results.append(rec)
        print(f"# compiled-pin[{name} blocked K={block}]: "
              f"{'OK' if ok else 'FAIL'} status={s} niter={niter} "
              f"corner={z_corner:.4f} basis_z64="
              f"{z64 if z64 is not None else float('nan'):.6f}",
              file=sys.stderr)
        assert ok, f"compiled pin {name} failed: {rec}"
        if deep_p1:
            # deep phase 1 actually happened: pivots exceed one K-block
            assert niter > block, (name, niter, block)
    return results


def verify_terminal_basis(state_out, m, n_struct, seed, dtype_name,
                          bounded=False):
    """Free mid-path correctness check of the timed big instance: the
    terminal basis must be primal feasible on the ORIGINAL f64 data and the
    tableau's objective corner must agree with the f64 basis objective.
    Costs one host linear solve — no extra device compile.

    Gates (VERDICT r3 weak #7 — tightened from the fixed -1e-3/-1e-2 pair,
    and RECORDED in the JSON artifact):
    * feasibility: min(xb) >= -10x the dtype ladder's feas_tol x scale
      (1e-4 x scale at f32, 1e-8 at f64);
    * corner agreement: |corner - z64| <= max(32 eps niter, 1e-5) |z64| —
      corner drift grows with walk length (measured ~1.4% after 272 f32
      devex pivots on a CORRECT basis), so a fixed tolerance either admits
      garbage on short walks or rejects correct long ones."""
    cfull, A, b = bench_data(m, n_struct, seed, bounded)
    basis = np.asarray(state_out.basis)
    niter = int(state_out.niter)
    corner = float(-np.asarray(state_out.T[0, -1]))
    n_tot = A.shape[1]
    Bmat = np.zeros((m, m))
    cb = np.zeros(m)
    for k, j in enumerate(basis):
        j = int(j)
        if j < n_tot:
            Bmat[:, k] = A[:, j]
            cb[k] = cfull[j]
        else:  # artificial: unit column (bench instances have none)
            Bmat[j - n_tot, k] = 1.0
    xb = np.linalg.solve(Bmat, b)
    scale = max(float(np.abs(b).max()), 1.0)
    z64 = float(cb @ xb)
    eps = {"float32": 1.19e-7, "float64": 2.22e-16}[dtype_name]
    feas_tol = {"float32": 1e-5, "float64": 1e-9}[dtype_name]  # ladder tols
    feas_gate = 10 * feas_tol * scale
    corner_gate = max(32 * eps * max(niter, 1), 1e-5) * max(abs(z64), 1.0)
    feas_ok = bool((xb >= -feas_gate).all())
    z_ok = abs(corner - z64) <= corner_gate
    line = (f"# terminal-basis check: min(xb)={xb.min():.2e} "
            f"(gate -{feas_gate:.2e}), corner z={corner:.4f} vs f64 basis "
            f"z={z64:.4f} (gate {corner_gate:.2e}) -> "
            f"{'OK' if feas_ok and z_ok else 'FAIL'}")
    print(line, file=sys.stderr)
    assert feas_ok, ("terminal basis primal-infeasible on original data: "
                     f"min xb = {xb.min()} vs gate -{feas_gate}")
    assert z_ok, (f"tableau corner {corner} drifted from f64 basis z {z64} "
                  f"beyond gate {corner_gate}")
    return {"min_xb": float(xb.min()), "feas_gate": feas_gate,
            "corner_z": corner, "basis_z64": z64,
            "corner_gate": corner_gate, "niter": niter, "ok": True}



def traffic_model(driver, m, n_struct, block, dtype_name):
    """(bytes, FLOPs) per pivot that the driver needs at this shape.

    Tableau (M, N) = (m+2, m+n+1), f-byte elements:
      rank1   : 2*M*N*f bytes (read + write the tableau each pivot) and
                2*M*N FLOPs (the rank-1 update);
      blocked : 2*M*N*f/K + (M+N)*K*f bytes (the flush amortized over K
                pivots; U and V re-read each pivot) and 2*M*N + 2*(M+N)*K
                FLOPs (the rank-K flush per pivot + the eta contractions).
    """
    f = {"float32": 4, "float64": 8}[dtype_name]
    M, N = m + 2, m + n_struct + 1
    if driver == "rank1":
        return 2 * M * N * f, 2 * M * N
    return (2 * M * N * f / block + (M + N) * block * f,
            2 * M * N + 2 * (M + N) * block)


def roofline(driver, m, n_struct, block, dtype_name, rate, kind):
    """The least time per pivot at the device's published peaks, beside
    the measured one: which bound binds, and the share of it reached."""
    peaks = device_peaks(kind)
    bpp, fpp = traffic_model(driver, m, n_struct, block, dtype_name)
    t_bytes = bpp / peaks["hbm_bytes_per_s"]
    t_flops = fpp / peaks[{"float32": "f32_flops_per_s",
                           "float64": "f64_flops_per_s"}[dtype_name]]
    t_min = max(t_bytes, t_flops)
    return {"bytes_per_pivot": bpp, "flops_per_pivot": fpp,
            "bound": "memory" if t_bytes >= t_flops else "compute",
            "min_us_per_pivot": t_min * 1e6,
            "measured_us_per_pivot": 1e6 / rate,
            "roofline_share": t_min * rate,
            "peaks_source": peaks["source"]}


def run_bench(m=4096, n_struct=4096, pivots=1024, dtype_name="float32",
              seed=0, driver="blocked", block=64, repeats=5,
              profile=False, pricing="default"):
    """Pivot throughput of one driver on the dense bench instance.

    Compiles the driver (timed, with ``memory_analysis``), runs the pivot
    budget once and checks the terminal basis against the original f64
    data, then times ``repeats`` calls, each to ``block_until_ready``; the
    rate is the budget over the median call. ``profile`` traces one more
    call and reduces it (``tools/xplane.py``) to device ops per pivot and
    the device's idle share. Returns ``(rate, pivots, evidence)``."""
    import dataclasses as _dc

    import jax
    import jax.numpy as jnp

    from tpulp.core import RULE_DEVEX, SolverOptions
    from tpulp.solve import run_simplex
    from tpulp.solve.blocked import blocked_driver

    dtype = {"float32": jnp.float32, "float64": jnp.float64}[dtype_name]
    state = make_bench_state(m, n_struct, dtype, seed=seed)
    opts = SolverOptions.for_dtype(dtype, max_iters=pivots)
    if pricing == "devex":
        opts = _dc.replace(opts, rule=RULE_DEVEX)
    if driver == "blocked":
        fn, args = blocked_driver(state, opts, block)
    else:
        fn, args = jax.jit(lambda s: run_simplex(s, opts)), (state,)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    t_compile = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    out = jax.block_until_ready(compiled(*args))
    n_piv = int(out.niter)
    if n_piv != pivots:
        raise SystemExit(
            f"bench instance stopped at {n_piv} pivots (status "
            f"{int(out.status)}), short of the {pivots}-pivot budget")
    gate = verify_terminal_basis(out, m, n_struct, seed, dtype_name)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    rate = n_piv / float(np.median(times))
    evidence = {
        "driver": driver, "block": block, "pricing": pricing,
        "compile_s": t_compile,
        "call_s": times,
        "temp_bytes": getattr(mem, "temp_size_in_bytes", None),
        "argument_bytes": getattr(mem, "argument_size_in_bytes", None),
        "terminal_gate": gate,
    }
    if profile:
        evidence["trace"] = profile_calls(
            lambda: compiled(*args), n_piv,
            os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".profile_trace", f"{driver}_K{block}"))
    return rate, n_piv, evidence


def profile_calls(call, pivots, trace_dir):
    """Trace one warm call of ``call`` (``pivots`` pivots) and reduce the
    trace to device ops per pivot, busy time and idle share
    (``tools/xplane.py``)."""
    import jax

    from tools.xplane import reduce_trace

    jax.block_until_ready(call())
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(call())
    r = reduce_trace(trace_dir)
    top = list(r["ops"].items())[:8]
    return {"dir": trace_dir, "lines": r["lines"],
            "ops_per_pivot": r["n_events"] / pivots,
            "busy_us_per_pivot": r["busy_ns"] / 1e3 / pivots,
            "window_us_per_pivot": r["window_ns"] / 1e3 / pivots,
            "idle_share": r["idle_share"],
            "top_ops_us_per_pivot": {k: ns / 1e3 / pivots
                                     for k, (ns, _) in top}}


def run_bench_batch(batch=1024, m=64, n_struct=64, dtype_name="float32",
                    seed=0, verbose=False, max_iters=500, driver="rank1",
                    block=32):
    """Batched mode (BASELINE config 3): vmap-solve ``batch`` independent
    bounded dense LPs in one device call; returns (aggregate pivots/s,
    LPs/s, lanes optimal).

    ``driver='blocked'`` uses the vmapped rank-K eta driver — the right
    engine once per-lane tableaus stop being small (the rank-1 batched
    driver re-reads every lane's whole tableau per pivot)."""
    import jax
    import jax.numpy as jnp

    from tpulp.batch import run_simplex_batch
    from tpulp.core import SolverOptions
    from tpulp.solve.blocked import run_simplex_blocked_batch

    dtype = {"float32": jnp.float32, "float64": jnp.float64}[dtype_name]
    # build on host, stack, ONE device transfer per leaf
    states = [
        make_bench_state(m, n_struct, dtype, seed=seed + i, bounded=True,
                         _numpy=True)
        for i in range(batch)
    ]
    batched = jax.tree.map(lambda *xs: np.stack(xs, axis=0), *states)
    batched = jax.block_until_ready(jax.tree.map(jnp.asarray, batched))
    opts = SolverOptions.for_dtype(dtype, max_iters=max_iters)

    if driver == "blocked":
        def run(s, o):
            return run_simplex_blocked_batch(s, o, block=block)
    else:
        def run(s, o):
            return run_simplex_batch(s, o)

    jax.block_until_ready(run(batched, opts))  # compile
    t0 = time.perf_counter()
    out = jax.block_until_ready(run(batched, opts))
    dt = time.perf_counter() - t0
    total_piv = int(np.asarray(out.niter).sum())
    statuses = np.asarray(out.status)
    optimal = int((statuses == 1).sum())
    if verbose:
        from tpulp.core import Status

        hist = {Status.NAMES.get(int(s), str(int(s))): int(c)
                for s, c in zip(*np.unique(statuses, return_counts=True))}
        print(
            f"# batch {batch}x({m}x{m + n_struct}) {dtype_name}: {dt:.4f}s, "
            f"{total_piv} pivots, {optimal}/{batch} optimal {hist}, "
            f"{total_piv / dt:.1f} pivots/s, {batch / dt:.1f} LPs/s",
            file=sys.stderr,
        )
    return total_piv / dt, batch / dt, optimal


def knapsack(n_items=28, seed=0):
    """(LinProg, DP optimum) of the bench's 0/1 knapsack."""
    from tpulp import LinExpr, LinProg

    rng = np.random.default_rng(seed)
    values = [int(v) for v in rng.integers(10, 60, size=n_items)]
    weights = [int(w) for w in rng.integers(5, 25, size=n_items)]
    cap = int(sum(weights) * 0.4)
    lp = LinProg()
    obj = LinExpr()
    wexpr = LinExpr()
    for i, (v, w) in enumerate(zip(values, weights)):
        lp.addVar(f"x{i}", integral=True, lb=0, ub=1)
        obj += LinExpr(v, f"x{i}")
        wexpr += LinExpr(w, f"x{i}")
    lp.maximize(obj)
    lp.addConstraint(wexpr.constraintLeq(cap))
    best = [0] * (cap + 1)
    for v, w in zip(values, weights):
        for c in range(cap, w - 1, -1):
            best[c] = max(best[c], best[c - w] + v)
    return lp, best[cap]


def run_bench_milp(n_items=28, batch_size=128, dtype_name="float32",
                   seed=0, verbose=False, mesh=None):
    """MILP B&B node throughput (BASELINE config 4): the 0/1 knapsack with
    ``n_items`` binary variables, solved to proven optimality. Returns
    ``(nodes/s, BnbStats, objective, DP optimum)``.

    Waves run in f32 on the device; exactness is preserved anyway:
    incumbents are exact-verified and failed lanes re-solve through the
    precision ladder. The DP-oracle assert below is the proof."""
    import jax.numpy as jnp

    from tpulp.milp import solve_milp

    lp, best = knapsack(n_items, seed)
    dtype = {"float32": jnp.float32, "float64": jnp.float64}[dtype_name]
    # warm: one full untimed solve compiles EVERY wave executable — cold
    # two-phase, dual-simplex warm wave, and the device-generation chain
    solve_milp(lp, dtype=dtype, batch_size=batch_size, mesh=mesh)
    t0 = time.perf_counter()
    sol, stats = solve_milp(lp, dtype=dtype, batch_size=batch_size,
                            return_stats=True, mesh=mesh)
    dt = time.perf_counter() - t0
    assert sol.status == "optimal" and sol.objective == best, (
        sol.status, sol.objective, best)
    if verbose:
        print(
            f"# milp knapsack n={n_items} batch={batch_size} {dtype_name}: "
            f"{dt:.4f}s, {stats.nodes_solved} nodes in {stats.waves} waves, "
            f"{stats.incumbent_updates} incumbents, "
            f"{stats.nodes_pruned_bound} bound-pruned, "
            f"{stats.solo_resolves} solo re-solves, "
            f"{stats.nodes_solved / dt:.1f} nodes/s | wave time: "
            f"assemble {stats.t_assemble:.4f}s, device(+fetch) "
            f"{stats.t_device:.4f}s, process {stats.t_process:.4f}s "
            f"(verify {stats.t_verify:.4f}s)",
            file=sys.stderr,
        )
    return stats.nodes_solved / dt, stats, sol.objective, best


def run_bench_corpus(dtype_name="float32", verbose=False):
    """Corpus parity sweep (BASELINE parity bar: lpsol LPs + netlib-style
    instances, rel gap <= 1e-9). Solves every corpus case on the device path
    at the requested iterate precision with the full precision ladder +
    exact-basis refinement; reports exact-match count and prints the per-case
    parity table (raw float objective gap vs refined gap) when verbose."""
    import jax.numpy as jnp

    from tpulp.corpus import CASES
    from tpulp.solve import solve_lp

    dtype = {"float32": jnp.float32, "float64": jnp.float64}[dtype_name]
    n_ok = 0
    rows = []
    for c in CASES:
        sf = c.lp().lower()
        t0 = time.time()
        sol = solve_lp(sf, dtype=dtype, max_iters=c.max_iters)
        dt = time.time() - t0
        ok = sol.status == c.status
        raw_gap = refined_gap = None
        raw_note = ""
        if c.status == "optimal" and ok:
            # raw float objective (no refinement) vs exact oracle
            raw = solve_lp(sf, dtype=dtype, refine="none", fallback="none",
                           max_iters=c.max_iters)
            denom = max(abs(float(c.objective)), 1.0)
            if raw.status == "optimal":
                raw_gap = abs(float(raw.objective) - float(c.objective)) / denom
            else:
                # distinguish WHY the raw column is empty (VERDICT r3 weak
                # #8): iteration_limit = budget exhausted at this precision;
                # anything else = the raw float walk failed outright (the
                # ladder's escalation is what rescued the refined column)
                raw_note = f"raw:{raw.status}"
            refined_gap = abs(
                float(sol.objective - c.objective)) / denom
            ok = ok and refined_gap <= 1e-9
        n_ok += bool(ok)
        rows.append((c.name, sol.status, sol.niter, raw_gap, refined_gap, dt,
                     sol.rung))
        if verbose:
            rg = f"{raw_gap:.2e}" if raw_gap is not None else (
                raw_note or "-")
            fg = f"{refined_gap:.2e}" if refined_gap is not None else "-"
            print(
                f"# {c.name:24s} {sol.status:12s} niter={sol.niter:6d} "
                f"raw_gap={rg:9s} refined_gap={fg:9s} {dt:6.2f}s "
                f"rung={sol.rung or '-':18s} {'OK' if ok else 'FAIL'}",
                file=sys.stderr,
            )
    # per-rung escalation table (r5, VERDICT r4 item 1 "done when"): which
    # precision-ladder rung produced each family's final answer
    rungs = {}
    for row in rows:
        rungs[row[6] or "unknown"] = rungs.get(row[6] or "unknown", 0) + 1
    if verbose:
        print(f"# ladder escalation rates: {rungs} "
              f"({len(CASES)} cases at requested dtype {dtype_name})",
              file=sys.stderr)
    return n_ok, len(CASES), rows, rungs



def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="single",
                    choices=["single", "batch", "corpus", "milp"])
    ap.add_argument("--m", type=int, default=4096)
    ap.add_argument("--n", type=int, default=4096,
                    help="dense structural columns (tableau width = m + n)")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--pivots", type=int, default=1024)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"])
    ap.add_argument("--driver", default="blocked",
                    choices=["blocked", "rank1"],
                    help="the timed driver (single mode)")
    ap.add_argument("--block", default=str(DEFAULT_BLOCK),
                    help="rank-K block size of the blocked driver, or a "
                         "comma-separated sweep (one JSON line each)")
    ap.add_argument("--repeats", type=int, default=5,
                    help="timed calls per measurement (median reported)")
    ap.add_argument("--pricing", default="default",
                    choices=["default", "devex"],
                    help="pricing rule for the timed driver (single mode)")
    ap.add_argument("--skip-parity", action="store_true")
    ap.add_argument("--skip-compiled-pin", action="store_true",
                    help="skip the compiled-driver correctness pins")
    ap.add_argument("--profile", action="store_true",
                    help="trace one more call per measurement and report "
                         "device ops per pivot and idle share")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args()

    import jax

    from tpulp.utils.compile_cache import enable_compile_cache

    # before any array exists: corpus and milp modes need the precision
    # ladder's f64 rung on the device
    if args.dtype == "float64" or args.mode in ("corpus", "milp"):
        jax.config.update("jax_enable_x64", True)
    enable_compile_cache()
    require_gpu()
    report = device_report()

    def emit(line):
        print(json.dumps({**line, **report}), flush=True)

    if not args.skip_parity:
        parity_check()

    if args.mode == "corpus":
        n_ok, n_total, _, rungs = run_bench_corpus(
            dtype_name=args.dtype, verbose=args.verbose)
        emit({
            "metric": f"corpus parity, {n_total} netlib-style instances, "
                      f"{args.dtype} iterates + exact refinement",
            "value": n_ok,
            "unit": "instances at <=1e-9 rel gap",
            "escalation_rates": rungs,
        })
        return

    if args.mode == "milp":
        rate, stats, _, _ = run_bench_milp(
            batch_size=args.batch if args.batch <= 512 else 128,
            dtype_name=args.dtype, verbose=args.verbose)
        emit({
            "metric": "MILP B&B node throughput, 28-var 0/1 knapsack to "
                      f"proven optimality ({args.dtype} waves + exact "
                      "incumbents)",
            "value": rate,
            "unit": "nodes/s",
            "nodes": stats.nodes_solved,
            "waves": stats.waves,
        })
        return

    blocks = [int(k) for k in args.block.split(",")]
    if args.mode == "batch":
        from tpulp.solve.api import choose_engine

        # per-lane tableaus default to 64x128; --m/--n set the real size;
        # the lane engine is the one solve_lp would choose for that size
        bm = args.m if args.m != 4096 else 64
        bn = args.n if args.n != 4096 else 64
        driver = choose_engine(bm, bm + bn)
        rate, lps, optimal = run_bench_batch(
            batch=args.batch, m=bm, n_struct=bn,
            dtype_name=args.dtype, verbose=args.verbose,
            driver=driver, block=min(blocks[0], 32),
            max_iters=args.pivots if args.pivots != 1024 else 500)
        emit({
            "metric": f"batched simplex ({driver}), {args.batch} "
                      f"independent {bm}x{bm + bn} LPs ({args.dtype})",
            "value": rate,
            "unit": "pivots/s",
            "lps_per_s": lps,
            "lanes_optimal": optimal,
        })
        return

    kind = report["device"]["kind"]
    device_peaks(kind)  # unknown device: fail before measuring
    for block in blocks:
        rate, _, evidence = run_bench(
            m=args.m, n_struct=args.n, pivots=args.pivots,
            dtype_name=args.dtype, driver=args.driver, block=block,
            repeats=args.repeats, profile=args.profile,
            pricing=args.pricing)
        evidence["roofline"] = roofline(args.driver, args.m, args.n, block,
                                        args.dtype, rate, kind)
        if args.driver == "blocked" and not args.skip_compiled_pin:
            # dies loudly (no JSON) if the compiled driver is fast-but-wrong
            evidence["compiled_pins"] = compiled_pin_suite()
        pricing_tag = "" if args.pricing == "default" else f", {args.pricing}"
        emit({
            "metric": f"simplex pivot throughput, {args.m}x{args.m + args.n}"
                      f" dense tableau ({args.dtype} iterates{pricing_tag}, "
                      f"{args.driver} K={block})",
            "value": rate,
            "unit": "pivots/s",
            "evidence": evidence,
        })


if __name__ == "__main__":
    main()
