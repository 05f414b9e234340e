"""Card-only checks: compiled kernels and device routes on an NVIDIA GPU.

Every test here carries the `gpu` marker and skips without a GPU (the
decision is taken at run time by tests/conftest.py).  Run them on the card
with ``python chip_smoke.py`` (its phase 5), which sets
``MINILP_TEST_DEVICE=gpu`` and calls pytest in its own process.
"""

import numpy as np
import pytest

from minilp_tpu.parallel.batched import (
    make_random_batch_host, solve_batch_certified, solve_batches_pipelined,
)
from minilp_tpu.status import Status
from minilp_tpu.utils.synth import netlib_shaped_problem

from .oracle import solve_with_oracle

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("m,nv", [(32, 96), (64, 192), (8, 16)])
def test_triton_kernel_on_card(m, nv):
    """The compiled kernel at the scenario shape, the envelope's edge and a
    padded tiny shape: ≥ 99% of lanes certified by the kernel itself (the
    rest by the HiGHS fallback), all equal to the plain vmapped route."""
    batch = make_random_batch_host(3, batch=256, m=m, nv=nv)
    kern = solve_batch_certified(*batch, route="triton", max_iter=4000)
    plain = solve_batch_certified(*batch, route="xla", max_iter=4000)
    assert np.asarray(kern.host_resolved).mean() <= 0.01
    assert (np.asarray(kern.status) == int(Status.OPTIMAL)).all()
    np.testing.assert_allclose(kern.obj, plain.obj, rtol=1e-9, atol=1e-9)


def test_pipelined_routes_agree_on_card():
    batches = [make_random_batch_host(40 + k, batch=512, m=32, nv=96)
               for k in range(2)]
    a = solve_batches_pipelined(batches, route="triton")
    b = solve_batches_pipelined(batches, route="xla")
    for ra, rb in zip(a, b):
        assert ra.verified.all() and rb.verified.all()
        np.testing.assert_allclose(ra.obj, rb.obj, rtol=1e-9, atol=1e-9)


def test_cold_solve_device_route_on_card():
    from minilp_tpu.utils import records

    prob = netlib_shaped_problem(60, 150, 0.1, seed=21)
    outcome, obj, _ = solve_with_oracle(prob)
    assert outcome == "optimal"
    with records.capture() as recs:
        sol = prob.solve()
    assert [(r.event, r.backend) for r in recs] == [("cold_solve", "gpu")]
    assert sol._engine.certified is True
    assert abs(sol.objective() - obj) <= 1e-9 * (1 + abs(obj))


def test_f32_certified_route_on_card():
    """f32 iterate with full-precision products on the card, adopted only
    after exact f64 certification."""
    from minilp_tpu.options import SolverOptions

    prob = netlib_shaped_problem(120, 360, 0.05, seed=9)
    outcome, obj, _ = solve_with_oracle(prob)
    prob.options = SolverOptions(f32_midsize="always")
    sol = prob.solve()
    assert sol._engine.certified is True
    assert abs(sol.objective() - obj) <= 1e-9 * (1 + abs(obj))


def test_incremental_warm_loop_on_card():
    """Branch-and-cut-style warm loop after a device-route cold solve."""
    from minilp_tpu.api import ComparisonOp, LinearExpr, Variable

    prob = netlib_shaped_problem(60, 150, 0.1, seed=22)
    sol = prob.solve()
    assert sol._engine.certified is True
    rng = np.random.default_rng(0)
    for _ in range(3):
        js = rng.choice(150, size=6, replace=False)
        cf = rng.normal(size=6)
        val = sum(float(co) * sol[Variable(int(j))] for co, j in zip(cf, js))
        expr = LinearExpr((float(co), Variable(int(j))) for co, j in zip(cf, js))
        sol = sol.add_constraint(expr, ComparisonOp.Le, val + 0.5)
        assert sol._engine.certified is True


def test_device_pdhg_stage_on_card():
    """The crossover's device stage: dense f32 PDHG chunks on the card reach
    a host-f64-verified KKT neighbourhood."""
    from minilp_tpu.canonical import canonicalize
    from minilp_tpu.engine.crossover import _device_pdhg_stage, kkt_error_f64
    from minilp_tpu.options import SolverOptions

    prob = netlib_shaped_problem(120, 360, 0.05, seed=9)
    can = canonicalize(prob, dtype=np.float64)
    opts = SolverOptions()
    tol = max(opts.crossover_tol, opts.feas_tol)
    out = _device_pdhg_stage(can, opts, tol, progress=False)
    assert out is not None
    x, y, niter, err, _omega = out
    assert niter > 0
    err2 = kkt_error_f64(can.A, can.b, can.c, can.lo, can.hi, x, y, tol)
    assert abs(err - err2) <= 1e-12 * (1 + err2)
    assert err <= 1e-2  # at worst the f32 floor; typically <= tol
