"""EP-analog scheduling gate (SURVEY.md §3.3 EP row): size bucketing +
difficulty-sorted lane order over both batched routes (the Triton kernel in
interpret mode on CPU), scipy-HiGHS oracle."""

import numpy as np
import pytest

from minilp_tpu.parallel.batched import make_random_batch_host
from minilp_tpu.parallel.scheduling import (
    LPResult,
    difficulty_scores,
    pad_lp,
    solve_batch_sorted,
    solve_heterogeneous,
    sort_for_packing,
)
from minilp_tpu.status import Status


def _oracle(A, b, c, lo, hi):
    from scipy.optimize import linprog

    bounds = [
        (lo[j] if np.isfinite(lo[j]) else None,
         hi[j] if np.isfinite(hi[j]) else None)
        for j in range(c.size)
    ]
    return linprog(c, A_eq=A, b_eq=b, bounds=bounds, method="highs")


def test_difficulty_scores_shape_and_determinism():
    A, b, c, lo, hi = make_random_batch_host(7, batch=12, m=8, nv=12)
    s1 = difficulty_scores(A, b, c, lo, hi)
    s2 = difficulty_scores(A, b, c, lo, hi)
    assert s1.shape == (12,)
    np.testing.assert_array_equal(s1, s2)
    order = sort_for_packing(s1)
    assert sorted(order.tolist()) == list(range(12))


def test_difficulty_scores_accepts_padded_columns():
    """Layout [structural | identity slack | pad] (the canonical form's
    column alignment) must score identically to the unpadded layout when
    slack0 is given explicitly."""
    A, b, c, lo, hi = make_random_batch_host(7, batch=6, m=8, nv=12)
    s_ref = difficulty_scores(A, b, c, lo, hi)
    pad = 4
    B, m, n = A.shape
    Ap = np.concatenate([A, np.zeros((B, m, pad))], axis=2)
    cp = np.concatenate([c, np.zeros((B, pad))], axis=1)
    lop = np.concatenate([lo, np.zeros((B, pad))], axis=1)
    hip = np.concatenate([hi, np.zeros((B, pad))], axis=1)
    s_pad = difficulty_scores(Ap, b, cp, lop, hip, slack0=12)
    np.testing.assert_array_equal(s_ref, s_pad)


def test_sorted_packing_matches_unsorted_and_oracle():
    """Sorting must be answer-invariant: lane i of the sorted solve is the
    same LP i's certified answer, matching the oracle."""
    A, b, c, lo, hi = make_random_batch_host(11, batch=8, m=8, nv=16)
    res = solve_batch_sorted(A, b, c, lo, hi, route="triton", interpret=True)
    assert (np.asarray(res.status) == int(Status.OPTIMAL)).all()
    assert np.asarray(res.verified).all()
    for i in range(8):
        r = _oracle(A[i], b[i], c[i], lo[i], hi[i])
        assert r.status == 0
        assert abs(float(res.obj[i]) - r.fun) <= 1e-9 * (1 + abs(r.fun)), i


def test_pad_lp_is_inert():
    """Padding an LP to a larger bucket shape must not change its optimum."""
    A, b, c, lo, hi = make_random_batch_host(3, batch=1, m=6, nv=10)
    A, b, c, lo, hi = A[0], b[0], c[0], lo[0], hi[0]
    Ap, bp, cp, lop, hip = pad_lp(A, b, c, lo, hi, 10, M=8, NV=16)
    assert Ap.shape == (8, 24)
    r0 = _oracle(A, b, c, lo, hi)
    r1 = _oracle(Ap, bp, cp, lop, hip)
    assert r0.status == 0 and r1.status == 0
    assert abs(r0.fun - r1.fun) <= 1e-9 * (1 + abs(r0.fun))
    # padded structural columns and padded-row slacks stay at 0
    assert np.all(r1.x[10:16] == 0)
    assert np.allclose(r1.x[16 + 6:], 0)


def test_heterogeneous_sizes_match_oracle():
    """Mixed-size workload: bucketed, padded, sorted, packed — answers come
    back certified, in order, in each LP's own layout."""
    lps = []
    for seed, m, nv, count in [(0, 4, 6, 3), (1, 6, 10, 2), (2, 8, 16, 3)]:
        A, b, c, lo, hi = make_random_batch_host(seed, batch=count, m=m, nv=nv)
        for i in range(count):
            lps.append((A[i], b[i], c[i], lo[i], hi[i]))
    results = solve_heterogeneous(
        lps, row_granule=4, col_granule=8, route="triton", interpret=True,
    )
    assert len(results) == len(lps)
    for lp, res in zip(lps, results):
        A, b, c, lo, hi = lp
        assert isinstance(res, LPResult)
        assert res.verified
        assert res.status == int(Status.OPTIMAL)
        assert res.x.shape == c.shape
        r = _oracle(A, b, c, lo, hi)
        assert r.status == 0
        assert abs(res.obj - r.fun) <= 1e-9 * (1 + abs(r.fun))
        # the returned x must be feasible and reproduce the objective
        assert np.allclose(A @ res.x, b, atol=1e-7)
        assert float(c @ res.x) == pytest.approx(res.obj, abs=1e-8)


def test_heterogeneous_single_bucket_lane_padding():
    """One bucket through the plain route: answers in the original order."""
    A, b, c, lo, hi = make_random_batch_host(5, batch=3, m=6, nv=10)
    lps = [(A[i], b[i], c[i], lo[i], hi[i]) for i in range(3)]
    results = solve_heterogeneous(lps, route="xla")
    assert len(results) == 3
    for i, res in enumerate(results):
        r = _oracle(A[i], b[i], c[i], lo[i], hi[i])
        assert abs(res.obj - r.fun) <= 1e-9 * (1 + abs(r.fun))


def test_pipelined_sorted_packs_matches_oracle():
    """Sorted order (scores from last round's pivot counts) must be
    answer-invariant: lane i of each result is LP i's certified answer."""
    batches = [make_random_batch_host(200 + k, batch=8, m=8, nv=16)
               for k in range(2)]
    results = []
    for batch in batches:
        first = solve_batch_sorted(*batch, route="xla")
        results.append(solve_batch_sorted(*batch, scores=first.niter,
                                          route="triton", interpret=True))
    assert len(results) == 2
    for (A, b, c, lo, hi), res in zip(batches, results):
        assert np.asarray(res.verified).all()
        for i in range(8):
            r = _oracle(A[i], b[i], c[i], lo[i], hi[i])
            assert r.status == 0
            assert abs(float(res.obj[i]) - r.fun) <= 1e-9 * (1 + abs(r.fun))


def test_heterogeneous_infeasible_lane():
    """An infeasible LP in the mix gets its exact status, not a bogus optimum."""
    A, b, c, lo, hi = make_random_batch_host(9, batch=2, m=6, nv=10)
    lps = [(A[i], b[i], c[i], lo[i], hi[i]) for i in range(2)]
    # x + s = -1 with x,s ≥ 0 is infeasible
    Ai = np.array([[1.0, 1.0]])
    lps.append((Ai, np.array([-1.0]), np.array([1.0, 0.0]),
                np.zeros(2), np.full(2, np.inf), 1))
    results = solve_heterogeneous(lps, row_granule=4, col_granule=4,
                                  route="triton", interpret=True)
    assert results[2].status == int(Status.INFEASIBLE)
    for i in range(2):
        r = _oracle(A[i], b[i], c[i], lo[i], hi[i])
        assert abs(results[i].obj - r.fun) <= 1e-9 * (1 + abs(r.fun))
