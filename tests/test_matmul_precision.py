"""Every float32 matrix product on a device engine's path asks for full f32.

A float32 ``dot_general`` with no precision (or ``DEFAULT``) may run in
TF32 on a GPU, which keeps ~10 mantissa bits: enough to mis-price a column
or misplace a value near an integer. This walks the jaxpr of each engine's
jitted entry point, sub-jaxprs included (while/cond bodies, jit calls,
shard_map, linear solves), and fails on any such product.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax

from tpulp.core import SolverOptions, make_state

M, N_STRUCT, LANES = 6, 9, 4


def _state(seed=0, m=M, n=N_STRUCT):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    x0 = np.abs(rng.normal(size=n))
    b = A @ x0 + np.abs(rng.normal(size=m))
    c = rng.normal(size=n)
    Afull = np.concatenate([A, np.eye(m)], axis=1)
    cfull = np.concatenate([c, np.zeros(m)])
    return make_state(cfull, Afull, b, list(range(n, n + m)),
                      dtype=jnp.float32)


def _batched():
    states = [_state(seed=i) for i in range(LANES)]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def _opts():
    return SolverOptions.for_dtype(jnp.float32, max_iters=50)


def _sub_jaxprs(value):
    """Jaxprs nested in an equation parameter (any container depth)."""
    if hasattr(value, "eqns"):
        yield value
    elif hasattr(value, "jaxpr") and hasattr(value.jaxpr, "eqns"):
        yield value.jaxpr
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _sub_jaxprs(v)


def _full_precision(precision) -> bool:
    if precision is None:
        return False
    parts = precision if isinstance(precision, tuple) else (precision,)
    return all(p == lax.Precision.HIGHEST for p in parts)


def reduced_precision_dots(jaxpr):
    """Every float32 dot_general in ``jaxpr`` not pinned to HIGHEST."""
    bad = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            f32 = any(v.aval.dtype == jnp.float32 for v in eqn.invars)
            if f32 and not _full_precision(eqn.params.get("precision")):
                bad.append(f"{eqn.params.get('precision')} "
                           f"{[str(v.aval) for v in eqn.invars]}")
        for value in eqn.params.values():
            for sub in _sub_jaxprs(value):
                bad.extend(reduced_precision_dots(sub))
    return bad


def _rank1():
    from tpulp.solve import run_simplex

    return lambda s: run_simplex(s, _opts()), (_state(),)


def _devex():
    from tpulp.solve.devex import run_simplex_devex

    return lambda s: run_simplex_devex(s, _opts()), (_state(),)


def _blocked():
    from tpulp.solve.blocked import run_simplex_blocked

    return lambda s: run_simplex_blocked(s, _opts(), block=4), (_state(),)


def _blocked_batch():
    from tpulp.solve.blocked import run_simplex_blocked_batch

    return (lambda s: run_simplex_blocked_batch(s, _opts(), block=4),
            (_batched(),))


def _bounded():
    from tpulp.solve.bounded import make_bounded_state, run_simplex_bounded

    upper = [2.0] * N_STRUCT + [None] * M
    return (lambda s: run_simplex_bounded(make_bounded_state(s, upper),
                                          _opts()), (_state(),))


def _dual():
    from tpulp.solve.dual import run_dual_simplex

    return lambda s: run_dual_simplex(s, _opts()), (_state(),)


def _warm_frame():
    from tpulp.solve.dual import warm_state_from_basis

    st = _state()
    return warm_state_from_basis, (
        st.T[2:, :-1], st.T[0, :-1], st.col_active, st.art_cols,
        jnp.asarray(st.basis), st.T[2:, -1])


def _integrality():
    from tpulp.solve.dual import pack_wave_summary

    n = M + N_STRUCT
    R = jnp.ones((3, n), jnp.float32)
    return pack_wave_summary, (_batched(), R, jnp.zeros((3,), jnp.float32))


def _expand_generation():
    from tpulp.solve.dual import run_expand_generation

    bt = _batched()
    n, n_int = M + N_STRUCT, 3
    f32, i32 = jnp.float32, jnp.int32
    summ = jnp.zeros((LANES, M + 6 + n_int), f32)
    return (lambda *a: run_expand_generation(*a, opts=_opts()), (
        bt.T, bt.basis, summ, jnp.ones((LANES,), bool),
        jnp.zeros((LANES, n_int), f32), jnp.ones((LANES, n_int), f32),
        bt.col_active[0], bt.art_cols[0],
        jnp.zeros((n_int,), i32), jnp.ones((n_int,), f32),
        jnp.zeros((n_int,), i32), jnp.ones((n_int,), f32),
        jnp.asarray(0.0, f32), jnp.asarray(1e-6, f32),
        jnp.asarray(50, i32), jnp.ones((n_int, n), f32),
        jnp.zeros((n_int,), f32)))


def _vmap_batch():
    from tpulp.batch import run_simplex_batch

    return lambda s: run_simplex_batch(s, _opts()), (_batched(),)


def _mesh():
    from tpulp.shard import make_mesh

    return make_mesh(4)


def _sharded_rank1():
    from tpulp.shard import run_simplex_sharded, to_sharded_state

    mesh = _mesh()
    return (lambda s: run_simplex_sharded(s, mesh, _opts()),
            (to_sharded_state(_state(), mesh),))


def _sharded_blocked():
    from tpulp.shard import run_simplex_sharded_blocked, to_sharded_state

    mesh = _mesh()
    return (lambda s: run_simplex_sharded_blocked(s, mesh, _opts(), block=4),
            (to_sharded_state(_state(), mesh),))


def _sharded_bounded():
    from tpulp.shard.sharded_bounded import (run_simplex_sharded_bounded,
                                             to_sharded_bounded_state)
    from tpulp.solve.bounded import make_bounded_state

    mesh = _mesh()
    bs = make_bounded_state(_state(), [2.0] * N_STRUCT + [None] * M)
    return (lambda s: run_simplex_sharded_bounded(s, mesh, _opts()),
            (to_sharded_bounded_state(bs, mesh),))


ENTRY_POINTS = {
    "rank1": _rank1,
    "devex": _devex,
    "blocked": _blocked,
    "blocked_batch": _blocked_batch,
    "bounded": _bounded,
    "dual": _dual,
    "warm_frame": _warm_frame,
    "integrality_check": _integrality,
    "expand_generation": _expand_generation,
    "vmap_batch": _vmap_batch,
    "sharded_rank1": _sharded_rank1,
    "sharded_blocked": _sharded_blocked,
    "sharded_bounded": _sharded_bounded,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_f32_products_are_full_precision(name):
    fn, args = ENTRY_POINTS[name]()
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    assert reduced_precision_dots(jaxpr) == [], name


def test_walker_flags_a_default_precision_product():
    """The walker sees through jit and while_loop to an unpinned product."""
    def body(x):
        return lax.while_loop(lambda c: c[1] < 2,
                              lambda c: (c[0] @ c[0], c[1] + 1), (x, 0))[0]

    x = jnp.ones((3, 3), jnp.float32)
    jaxpr = jax.make_jaxpr(jax.jit(body))(x).jaxpr
    assert len(reduced_precision_dots(jaxpr)) == 1
