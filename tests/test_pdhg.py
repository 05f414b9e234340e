"""PDHG first-order engine gate (BASELINE config 5 analog, SURVEY.md §3.3):
objective parity with the oracle at loosened tolerance, batched vmap use, and
the engine option wiring."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from minilp_tpu import OptimizationDirection, Problem, ComparisonOp, SolverFailure
from minilp_tpu.options import SolverOptions
from minilp_tpu.engine.pdhg import solve_pdhg
from minilp_tpu.status import Status

from .oracle import random_problem, solve_with_oracle

PDHG_OPTS = SolverOptions(engine="pdhg", feas_tol=1e-7, pdhg_max_iter=400_000)


def rel_close(a, b, tol=1e-5):
    return abs(a - b) <= tol * (1.0 + abs(b))


def test_pdhg_simple_problem():
    prob = Problem(OptimizationDirection.Maximize, options=PDHG_OPTS)
    x = prob.add_var(1.0, (0.0, None))
    y = prob.add_var(2.0, (0.0, 3.0))
    prob.add_constraint(x + y, ComparisonOp.Le, 4.0)
    sol = prob.solve()
    assert rel_close(sol.objective(), 7.0)
    assert rel_close(sol[x], 1.0, tol=1e-4)
    assert rel_close(sol[y], 3.0, tol=1e-4)


@pytest.mark.parametrize("seed", range(5))
def test_pdhg_random_matches_oracle(seed):
    rng = np.random.default_rng(3000 + seed)
    prob = random_problem(
        rng, nv=int(rng.integers(5, 20)), m=int(rng.integers(3, 15)),
        frac_free=0.0,  # keep iterates bounded: boxed/one-sided vars only
    )
    prob.options = PDHG_OPTS
    outcome, obj, _x = solve_with_oracle(prob)
    if outcome != "optimal":
        pytest.skip("instance not optimal")
    sol = prob.solve()
    assert rel_close(sol.objective(), obj), (sol.objective(), obj)


def test_pdhg_incremental_not_supported():
    prob = Problem(options=PDHG_OPTS)
    x = prob.add_var(1.0, (0.0, 5.0))
    prob.add_constraint(1.0 * x, ComparisonOp.Ge, 1.0)
    sol = prob.solve()
    with pytest.raises(SolverFailure, match="simplex"):
        sol.add_constraint(1.0 * x, ComparisonOp.Le, 3.0)


def test_pdhg_detects_infeasible():
    # x >= 0 (bound) but x <= -1 (row): no feasible point.  The engine must
    # produce a Farkas certificate (status INFEASIBLE), not run to MAX_ITER.
    from minilp_tpu import Infeasible

    prob = Problem(options=PDHG_OPTS)
    x = prob.add_var(1.0, (0.0, None))
    prob.add_constraint(1.0 * x, ComparisonOp.Le, -1.0)
    with pytest.raises(Infeasible):
        prob.solve()


def test_pdhg_detects_infeasible_system():
    # x + y = 1 and x + y = 3 simultaneously (via two-sided rows).
    from minilp_tpu import Infeasible

    opts = SolverOptions(engine="pdhg", feas_tol=1e-7, presolve=False)
    prob = Problem(options=opts)
    x = prob.add_var(1.0, (None, None))
    y = prob.add_var(1.0, (None, None))
    prob.add_constraint(x + y, ComparisonOp.Eq, 1.0)
    prob.add_constraint(x + y, ComparisonOp.Eq, 3.0)
    with pytest.raises(Infeasible):
        prob.solve()


def test_pdhg_detects_unbounded():
    # maximize x with only a lower-bounding row: recession ray certificate.
    from minilp_tpu import Unbounded

    prob = Problem(OptimizationDirection.Maximize, options=PDHG_OPTS)
    x = prob.add_var(1.0, (0.0, None))
    prob.add_constraint(1.0 * x, ComparisonOp.Ge, 1.0)
    with pytest.raises(Unbounded):
        prob.solve()


@pytest.mark.parametrize("seed", range(3))
def test_pdhg_sparse_matches_dense(seed):
    """BCOO-path PDHG must agree with the dense path on the same instance."""
    from minilp_tpu.engine.pdhg import solve_pdhg, solve_pdhg_sparse
    from jax.experimental import sparse as jsparse

    rng = np.random.default_rng(4200 + seed)
    m, nv = 10, 24
    # sparse-ish structural block + identity slacks
    A_s = rng.normal(size=(m, nv)) * (rng.random((m, nv)) < 0.3)
    x0 = rng.uniform(0.2, 0.8, size=nv)
    b = A_s @ x0 + rng.uniform(0.1, 1.0, size=m)
    A = np.concatenate([A_s, np.eye(m)], axis=1)
    c = np.concatenate([rng.normal(size=nv), np.zeros(m)])
    lo = np.zeros(nv + m)
    hi = np.concatenate([np.ones(nv), np.full(m, np.inf)])

    opts = SolverOptions(engine="pdhg", feas_tol=1e-7)
    dense = solve_pdhg(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
                       jnp.asarray(lo), jnp.asarray(hi), opts=opts)
    Ab = jsparse.BCOO.fromdense(jnp.asarray(A))
    sp = solve_pdhg_sparse(Ab, jnp.asarray(b), jnp.asarray(c),
                           jnp.asarray(lo), jnp.asarray(hi), opts=opts)
    assert int(dense.status) == int(Status.OPTIMAL)
    assert int(sp.status) == int(Status.OPTIMAL)
    obj_d = float(np.asarray(c) @ np.asarray(dense.x))
    obj_s = float(np.asarray(c) @ np.asarray(sp.x))
    assert abs(obj_d - obj_s) <= 1e-5 * (1.0 + abs(obj_d))


def test_pdhg_sparse_driver_path():
    """pdhg_matrix='sparse' end-to-end through Problem.solve."""
    opts = SolverOptions(engine="pdhg", feas_tol=1e-7, pdhg_matrix="sparse")
    prob = Problem(OptimizationDirection.Maximize, options=opts)
    x = prob.add_var(1.0, (0.0, None))
    y = prob.add_var(2.0, (0.0, 3.0))
    prob.add_constraint(x + y, ComparisonOp.Le, 4.0)
    sol = prob.solve()
    assert rel_close(sol.objective(), 7.0)


def test_pdhg_ruiz_earns_its_keep():
    """A badly column-scaled instance (scales spanning 1e-4..1e4): with Ruiz
    equilibration PDHG converges in a modest iteration budget; with Ruiz
    disabled the same budget is nowhere near enough.  (SURVEY.md §3.3's
    equilibration requirement made measurable.)"""
    rng = np.random.default_rng(31337)
    m, nv = 12, 24
    scales = 10.0 ** rng.uniform(-4, 4, size=nv)
    A_s = rng.normal(size=(m, nv)) * scales[None, :]
    x0 = rng.uniform(0.2, 0.8, size=nv) / scales  # interior in scaled units
    b = A_s @ x0 + rng.uniform(0.1, 1.0, size=m)
    A = np.concatenate([A_s, np.eye(m)], axis=1)
    c = np.concatenate([rng.normal(size=nv) * scales, np.zeros(m)])
    lo = np.zeros(nv + m)
    hi = np.concatenate([2.0 / scales, np.full(m, np.inf)])

    budget = 40_000
    args = tuple(jnp.asarray(v) for v in (A, b, c, lo, hi))
    with_ruiz = solve_pdhg(
        *args, opts=SolverOptions(engine="pdhg", feas_tol=1e-7,
                                  pdhg_max_iter=budget)
    )
    without = solve_pdhg(
        *args, opts=SolverOptions(engine="pdhg", feas_tol=1e-7,
                                  pdhg_max_iter=budget, pdhg_ruiz_iters=0)
    )
    assert int(with_ruiz.status) == int(Status.OPTIMAL)
    assert int(with_ruiz.niter) <= budget
    # un-equilibrated: either times out or needs dramatically more work
    assert (
        int(without.status) == int(Status.MAX_ITER)
        or int(without.niter) >= 4 * int(with_ruiz.niter)
    )


@pytest.mark.parametrize("seed", range(4))
def test_pdhg_certificates_no_false_positives(seed):
    """A slow-converging but FEASIBLE-and-BOUNDED instance must never be
    flagged INFEASIBLE/UNBOUNDED by the displacement-ray certificates — an
    exact-claim contract (the certificates fire on every check interval, so a
    long run is many chances to lie)."""
    rng = np.random.default_rng(9000 + seed)
    m, nv = 10, 18
    # near-degenerate: tiny singular values make residuals decay slowly
    U, _ = np.linalg.qr(rng.normal(size=(m, m)))
    V, _ = np.linalg.qr(rng.normal(size=(nv, nv)))
    sv = 10.0 ** np.linspace(0, -3, m)
    A_s = U @ np.diag(sv) @ V[:m]
    x0 = rng.uniform(0.3, 0.7, size=nv)
    b = A_s @ x0 + rng.uniform(0.05, 0.3, size=m)
    A = np.concatenate([A_s, np.eye(m)], axis=1)
    c = np.concatenate([rng.normal(size=nv), np.zeros(m)])
    lo = np.zeros(nv + m)
    hi = np.concatenate([np.ones(nv), np.full(m, np.inf)])
    st = solve_pdhg(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(c), jnp.asarray(lo),
        jnp.asarray(hi),
        opts=SolverOptions(engine="pdhg", feas_tol=1e-7,
                           pdhg_max_iter=150_000),
    )
    assert int(st.status) in (int(Status.OPTIMAL), int(Status.MAX_ITER))


def test_pdhg_batched_vmap():
    # the engine is plain JAX: vmap over a batch of canonical LPs just works
    from minilp_tpu.parallel.batched import make_random_batch

    key = jax.random.PRNGKey(5)
    B, m, nv = 8, 6, 10
    A, b, c, lo, hi, _, _ = make_random_batch(key, B, m, nv)
    opts = SolverOptions(engine="pdhg", feas_tol=1e-7)
    out = jax.vmap(lambda A, b, c, lo, hi: solve_pdhg(A, b, c, lo, hi, opts=opts))(
        A, b, c, lo, hi
    )
    assert (np.asarray(out.status) == int(Status.OPTIMAL)).all()
    # cross-check objectives against the simplex engine on the same batch
    from minilp_tpu.parallel.batched import solve_batch
    simplex = solve_batch(A, b, c, lo, hi,
                          jnp.zeros_like(c).astype(jnp.int8).at[:, nv:].set(4),
                          jnp.broadcast_to(jnp.arange(nv, nv + m, dtype=jnp.int32), (B, m)),
                          opts=SolverOptions())
    pdhg_obj = np.einsum("bn,bn->b", np.asarray(c), np.asarray(out.x))
    np.testing.assert_allclose(pdhg_obj, np.asarray(simplex.obj), rtol=1e-4, atol=1e-4)


def test_pdhg_chunked_launches_match_single():
    """Warm re-entry through `state0`/`stop_at` (the crossover's chunked
    device stage) reproduces the single-launch trajectory: the state round-trips
    through the original-space rescale exactly up to f64 rounding."""
    import jax.numpy as jnp

    from minilp_tpu.canonical import canonicalize
    from minilp_tpu.engine.pdhg import solve_pdhg
    from minilp_tpu.options import SolverOptions
    from minilp_tpu.status import Status

    from .oracle import random_problem

    rng = np.random.default_rng(11)
    prob = random_problem(rng, nv=40, m=24, density=0.6,
                          frac_free=0.0, frac_boxed=1.0, frac_fixed=0.0)
    can = canonicalize(prob, dtype=np.float64)
    opts = SolverOptions(engine="pdhg", feas_tol=1e-7, pdhg_max_iter=200_000)
    args = (jnp.asarray(can.A), jnp.asarray(can.b), jnp.asarray(can.c),
            jnp.asarray(can.lo), jnp.asarray(can.hi))
    single = solve_pdhg(*args, opts=opts)
    st = None
    done = 0
    while True:
        cap = min(done + 700, opts.pdhg_max_iter)
        st = solve_pdhg(*args, opts=opts, state0=st, stop_at=jnp.int32(cap))
        done = int(st.niter)
        if int(st.status) != int(Status.MAX_ITER) or done >= opts.pdhg_max_iter:
            break
    assert int(st.status) == int(single.status) == int(Status.OPTIMAL)
    obj_s = float(can.c @ np.asarray(single.x))
    obj_c = float(can.c @ np.asarray(st.x))
    assert abs(obj_c - obj_s) <= 1e-6 * (1 + abs(obj_s))


def test_pdhg_halpern_variant_matches_oracle():
    """Opt-in reflected-Halpern scheme (r2HPDHG-class): fixed-point-residual
    restarts + frozen primal weight.  On a well-scaled instance it must
    reach the same optimum as vanilla (measured ~1.6x fewer iterations on
    this class; the badly-scaled trade-off is documented in options.py)."""
    rng = np.random.default_rng(7)
    m, nv = 10, 24
    A_s = rng.normal(size=(m, nv))
    x0 = rng.uniform(0.2, 0.8, size=nv)
    b = A_s @ x0 + rng.uniform(0.1, 1.0, size=m)
    A = np.concatenate([A_s, np.eye(m)], axis=1)
    c = np.concatenate([rng.normal(size=nv), np.zeros(m)])
    lo = np.zeros(nv + m)
    hi = np.concatenate([np.full(nv, 2.0), np.full(m, np.inf)])
    args = tuple(jnp.asarray(v) for v in (A, b, c, lo, hi))
    outs = {}
    for var in ("vanilla", "halpern"):
        st = solve_pdhg(*args, opts=SolverOptions(
            engine="pdhg", feas_tol=1e-7, pdhg_max_iter=200_000,
            pdhg_variant=var))
        assert int(st.status) == int(Status.OPTIMAL), var
        outs[var] = (float(np.asarray(c) @ np.asarray(st.x)), int(st.niter))
    ov, oh = outs["vanilla"][0], outs["halpern"][0]
    assert abs(ov - oh) <= 1e-5 * (1 + abs(ov))
