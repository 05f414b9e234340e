"""Batched-route gate: the Triton kernel (interpret mode on CPU) against the
plain vmapped f32 route and the scipy-HiGHS oracle, at power-of-two and
padded shapes, plus the pipelined driver and the canonical layout."""

import numpy as np
import pytest
import jax

from minilp_tpu.parallel.batched import (
    make_random_batch, make_random_batch_host, solve_batch_certified,
    solve_batches_pipelined,
)
from minilp_tpu.status import Status


def _highs(A, b, c, lo, hi):
    from scipy.optimize import linprog

    bounds = [
        (lo[j] if np.isfinite(lo[j]) else None,
         hi[j] if np.isfinite(hi[j]) else None)
        for j in range(c.shape[0])
    ]
    r = linprog(c, A_eq=A, b_eq=b, bounds=bounds, method="highs")
    assert r.status == 0
    return r.fun


# (8, 16): padded to 16×32; (16, 16): already 16×32 — no padding at all
@pytest.mark.parametrize("seed,B,m,nv", [(0, 8, 8, 16), (1, 8, 16, 16)])
def test_packed_matches_oracle(seed, B, m, nv):
    key = jax.random.PRNGKey(seed)
    A, b, c, lo, hi, _, _ = map(np.asarray, make_random_batch(key, B, m, nv))
    res = solve_batch_certified(A, b, c, lo, hi, route="triton",
                                interpret=True)
    assert (np.asarray(res.status) == int(Status.OPTIMAL)).all()
    assert not np.asarray(res.host_resolved).any()
    for i in range(B):
        ref = _highs(A[i], b[i], c[i], lo[i], hi[i])
        assert abs(float(res.obj[i]) - ref) <= 1e-9 * (1 + abs(ref)), i


def test_packed_agrees_with_unpacked():
    """The kernel and the plain vmapped f32 route certify the same optima."""
    key = jax.random.PRNGKey(3)
    A, b, c, lo, hi, _, _ = map(np.asarray, make_random_batch(key, 8, 8, 12))
    kern = solve_batch_certified(A, b, c, lo, hi, route="triton",
                                 interpret=True)
    plain = solve_batch_certified(A, b, c, lo, hi, route="xla")
    np.testing.assert_allclose(
        np.asarray(kern.obj), np.asarray(plain.obj), rtol=1e-9, atol=1e-9
    )


def test_pipelined_batches():
    """solve_batches_pipelined: host-resident data, overlap-friendly loop,
    all lanes certified, objectives match the oracle — and the two routes
    return identical certified objectives."""
    batches = [make_random_batch_host(100 + k, batch=8, m=8, nv=16)
               for k in range(3)]
    results = solve_batches_pipelined(batches, max_iter=2000, route="xla")
    assert len(results) == 3
    results_k = solve_batches_pipelined(batches, max_iter=2000,
                                        route="triton", interpret=True)
    for r, rk in zip(results, results_k):
        np.testing.assert_allclose(
            np.asarray(r.obj), np.asarray(rk.obj), rtol=1e-12, atol=1e-12
        )
    for (A, b, c, lo, hi), res in zip(batches, results):
        assert np.asarray(res.verified).all()
        for i in range(2):  # spot-check two lanes per batch
            ref = _highs(A[i], b[i], c[i], lo[i], hi[i])
            assert abs(float(res.obj[i]) - ref) <= 1e-9 * (1 + abs(ref))


@pytest.mark.parametrize("seed", range(2))
def test_packed_canonical_layout(seed):
    """Canonical-form problems (slack0=nv, free vars, Eq/Ge rows) through the
    kernel, one problem replicated across a batch."""
    from minilp_tpu.canonical import canonicalize
    from .oracle import random_problem, solve_with_oracle

    rng = np.random.default_rng(8800 + seed)
    prob = random_problem(
        rng, nv=int(rng.integers(4, 8)), m=int(rng.integers(2, 6))
    )
    outcome, obj, _x = solve_with_oracle(prob)
    if outcome != "optimal":
        pytest.skip("instance not optimal")
    can = canonicalize(prob, dtype=np.float64)
    tile = lambda x: np.broadcast_to(x, (4,) + x.shape).copy()
    res = solve_batch_certified(
        tile(can.A), tile(can.b), tile(can.c), tile(can.lo), tile(can.hi),
        slack0=can.nv, max_iter=4000, route="triton", interpret=True,
    )
    assert np.asarray(res.verified).all()
    got = can.obj_sign * np.asarray(res.obj)
    np.testing.assert_allclose(got, obj, rtol=1e-7, atol=1e-7)
