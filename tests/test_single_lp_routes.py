"""Single-LP routes: the dense XLA engine (`device_xla`, the cold route up to
2048 padded rows), `Problem.solve()` around it, and the host sparse engine's cold
long-step phase 1 — oracle agreement, the canonical layout, inert padding,
and warm restarts through the engine and the incremental API."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from minilp_tpu.canonical import canonicalize
from minilp_tpu.engine import hostlp
from minilp_tpu.engine.primal import solve_canonical
from minilp_tpu.options import SolverOptions
from minilp_tpu.parallel.batched import make_random_batch
from minilp_tpu.status import Status, VarStat
from minilp_tpu.utils import records

from .oracle import random_problem, solve_with_oracle

_solve = jax.jit(solve_canonical, static_argnames=("opts",))
OPTS = SolverOptions(max_iter=2000)


def _one(seed, m, nv):
    args = make_random_batch(jax.random.PRNGKey(seed), 1, m, nv)
    return [x[0] for x in args]


def _highs(A, b, c, lo, hi):
    from scipy.optimize import linprog

    A, b, c, lo, hi = map(np.asarray, (A, b, c, lo, hi))
    bounds = [
        (lo[j] if np.isfinite(lo[j]) else None,
         hi[j] if np.isfinite(hi[j]) else None)
        for j in range(c.shape[0])
    ]
    r = linprog(c, A_eq=A, b_eq=b, bounds=bounds, method="highs")
    assert r.status == 0
    return r.fun


@pytest.mark.parametrize("seed,m,nv", [(0, 8, 16), (1, 16, 24), (2, 16, 40)])
def test_xla_engine_matches_oracle(seed, m, nv):
    A, b, c, lo, hi, vs, bs = _one(seed, m, nv)
    st = _solve(A, b, c, lo, hi, vs, bs, opts=OPTS)
    assert int(st.status) == int(Status.OPTIMAL)
    ref = _highs(A, b, c, lo, hi)
    assert abs(float(st.obj) - ref) <= 1e-9 * (1 + abs(ref))


@pytest.mark.parametrize("seed", range(3))
def test_xla_engine_agrees_with_host_engine(seed):
    """The device engine and the host sparse engine, both exact f64 from the
    slack basis, reach the same optimum."""
    A, b, c, lo, hi, vs, bs = _one(100 + seed, 16, 32)
    st = _solve(A, b, c, lo, hi, vs, bs, opts=OPTS)
    host = hostlp.solve_host_sparse(
        *map(np.asarray, (A, b, c, lo, hi, bs, vs)), opts=OPTS)
    assert int(st.status) == int(host.status) == int(Status.OPTIMAL)
    np.testing.assert_allclose(float(st.obj), host.obj, rtol=1e-9, atol=1e-9)


def test_xla_engine_n_padding_inert():
    """Extra FIXED [0, 0] zero columns (the canonical form's column
    alignment) leave the optimum unchanged."""
    A, b, c, lo, hi, vs, bs = _one(9, 8, 20)
    pad = lambda v, k, fill: jnp.concatenate([v, jnp.full((k,), fill, v.dtype)])
    Ap = jnp.concatenate([A, jnp.zeros((A.shape[0], 4))], axis=1)
    st = _solve(A, b, c, lo, hi, vs, bs, opts=OPTS)
    stp = _solve(Ap, b, pad(c, 4, 0.0), pad(lo, 4, 0.0), pad(hi, 4, 0.0),
                 pad(vs, 4, int(VarStat.FIXED)), bs, opts=OPTS)
    assert int(st.status) == int(stp.status) == int(Status.OPTIMAL)
    np.testing.assert_allclose(float(stp.obj), float(st.obj), rtol=1e-12,
                               atol=1e-12)
    assert (np.asarray(stp.vstat)[-4:] == int(VarStat.FIXED)).all()


@pytest.mark.parametrize("seed", range(3))
def test_driver_canonical_layout(seed):
    """Problem.solve() on random problems (free vars, at-upper vars, Eq/Ge
    rows, maximize) through the device route: certified, oracle-exact."""
    rng = np.random.default_rng(8200 + seed)
    prob = random_problem(
        rng, nv=int(rng.integers(4, 10)), m=int(rng.integers(2, 8))
    )
    outcome, obj, _x = solve_with_oracle(prob)
    if outcome != "optimal":
        pytest.skip("instance not optimal")
    sol = prob.solve()
    assert sol._engine.certified is True
    assert abs(sol.objective() - obj) <= 1e-9 * (1 + abs(obj))


def test_driver_reports_device_route():
    """The cold route and its backend are visible in the solve record."""
    from minilp_tpu.utils.synth import netlib_shaped_problem

    prob = netlib_shaped_problem(30, 60, 0.2, seed=3)
    with records.capture() as recs:
        prob.solve()
    assert [r.event for r in recs] == ["cold_solve"]
    assert recs[0].backend == "cpu" and recs[0].status == "OPTIMAL"
    assert recs[0].padded_rows == 32


def test_warm_restart_zero_pivots():
    """Re-entering the engine from its own optimal (basis, vstat, B⁻¹) takes
    no pivots and returns the same objective."""
    A, b, c, lo, hi, vs, bs = _one(21, 16, 32)
    cold = _solve(A, b, c, lo, hi, vs, bs, opts=OPTS)
    warm = _solve(A, b, c, lo, hi, cold.vstat, cold.basis, opts=OPTS,
                  Binv0=cold.Binv)
    assert int(warm.status) == int(Status.OPTIMAL)
    assert int(warm.niter) == 0
    np.testing.assert_allclose(float(warm.obj), float(cold.obj), rtol=1e-12)


def test_warm_restart_after_bound_change():
    """A tightened box bound, warm-started from the old optimum, reaches the
    new optimum (oracle)."""
    A, b, c, lo, hi, vs, bs = _one(22, 16, 32)
    cold = _solve(A, b, c, lo, hi, vs, bs, opts=OPTS)
    hi2 = np.asarray(hi).copy()
    x_cold = np.zeros(hi2.shape)
    x_cold[np.asarray(cold.basis)] = np.asarray(cold.xB)
    j = int(np.argmax(x_cold[:32]))          # a structural with value > 0
    hi2[j] = 0.5 * x_cold[j]
    vstat = np.asarray(cold.vstat).copy()
    if vstat[j] == int(VarStat.AT_UPPER):
        vstat[j] = int(VarStat.AT_LOWER)
    warm = _solve(A, b, c, lo, jnp.asarray(hi2), jnp.asarray(vstat),
                  cold.basis, opts=OPTS, Binv0=cold.Binv)
    assert int(warm.status) == int(Status.OPTIMAL)
    ref = _highs(A, b, c, lo, hi2)
    assert abs(float(warm.obj) - ref) <= 1e-9 * (1 + abs(ref))


def test_incremental_warm_restart_through_api():
    """add_constraint / fix_var / unfix_var re-solves after a device-route
    cold solve stay exact (host-first warm routing)."""
    from minilp_tpu import ComparisonOp, OptimizationDirection, Problem

    prob = Problem(OptimizationDirection.Maximize)
    x = prob.add_var(3.0, (0.0, None))
    y = prob.add_var(2.0, (0.0, None))
    prob.add_constraint(x + y, ComparisonOp.Le, 4.0)
    prob.add_constraint(x + 3.0 * y, ComparisonOp.Le, 6.0)
    sol = prob.solve()
    assert abs(sol.objective() - 12.0) <= 1e-9
    sol = sol.add_constraint(x - y, ComparisonOp.Le, 1.0)
    assert abs(sol.objective() - 9.25) <= 1e-9
    sol = sol.fix_var(y, 1.0)
    assert abs(sol.objective() - 8.0) <= 1e-9
    changed, sol = sol.unfix_var(y)
    assert changed and abs(sol.objective() - 9.25) <= 1e-9


@pytest.mark.parametrize("refactor_period", [8, 64])
def test_refactor_period_agrees(refactor_period):
    """Periodic in-graph refreshes every 8 or every 64 pivots: the same
    certified optimum."""
    A, b, c, lo, hi, vs, bs = _one(31, 16, 40)
    opts = SolverOptions(max_iter=2000, refactor_period=refactor_period)
    st = _solve(A, b, c, lo, hi, vs, bs, opts=opts)
    assert int(st.status) == int(Status.OPTIMAL)
    ref = _highs(A, b, c, lo, hi)
    assert abs(float(st.obj) - ref) <= 1e-9 * (1 + abs(ref))


def test_devex_reset_option_reaches_host_engine():
    """A tiny devex_reset keeps resetting the weights; the host engine must
    still converge to the same optimum."""
    A, b, c, lo, hi, vs, bs = map(np.asarray, _one(41, 16, 40))
    base = hostlp.solve_host_sparse(A, b, c, lo, hi, bs, vs, opts=OPTS)
    reset = hostlp.solve_host_sparse(
        A, b, c, lo, hi, bs, vs,
        opts=SolverOptions(max_iter=2000, devex_reset=1.5))
    assert int(base.status) == int(reset.status) == int(Status.OPTIMAL)
    np.testing.assert_allclose(reset.obj, base.obj, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("seed,m,nv", [(3, 16, 24), (4, 16, 40)])
def test_host_long_step_phase1_matches_oracle(seed, m, nv):
    """Cold host solve from the slack basis of an instance that starts
    infeasible (negative rhs rows), so phase 1 runs its long-step
    (piecewise-linear) ratio test."""
    A, b, c, lo, hi, vs, bs = map(np.asarray, _one(seed, m, nv))
    b = b.copy()
    b[: m // 2] = -np.abs(b[: m // 2])     # slacks ≥ 0 start violated
    lo = lo.copy()
    lo[: nv] = -1.0                         # keep the instance feasible
    res = hostlp.solve_host_sparse(A, b, c, lo, hi, bs, vs, opts=OPTS)
    ref = _highs(A, b, c, lo, hi)
    assert int(res.status) == int(Status.OPTIMAL)
    assert abs(res.obj - ref) <= 1e-9 * (1 + abs(ref))


@pytest.mark.parametrize("seed", [0, 2])
def test_host_long_step_degenerate_instance(seed):
    """Planted degeneracy (zero slackness, duplicate rows/columns) through
    the host engine's long-step phase 1: exact terminal claim."""
    from minilp_tpu.utils.synth import degenerate_problem

    prob = degenerate_problem(20, 40, 0.25, seed=seed)
    outcome, obj, _ = solve_with_oracle(prob)
    can = canonicalize(prob, dtype=np.float64)
    res = hostlp.solve_host_sparse(
        can.A, can.b, can.c, can.lo, can.hi, can.basis0, can.vstat0,
        opts=SolverOptions(max_iter=5000),
    )
    assert res is not None
    if outcome == "optimal":
        assert int(res.status) == int(Status.OPTIMAL)
        got = can.obj_sign * res.obj
        assert abs(got - obj) <= 1e-7 * (1 + abs(obj))
    else:
        assert int(res.status) != int(Status.OPTIMAL)
