"""Heterogeneous-batch scheduling: size bucketing + difficulty-sorted order.

This is the EP-analog row of SURVEY.md §3.3 ("heterogeneous batch scheduling —
group scenario LPs by size/iteration count across devices to avoid
stragglers").  The reference (`ztlpn/minilp`) has no batching at all; these
are build-only components shaped by how the batched routes execute:

* **Stragglers.** The batched kernel runs one LP per program and the GPU
  schedules programs in waves, roughly in program order; the vmapped XLA
  route runs a whole batch in lockstep.  Either way a group of LPs costs the
  iterations of its slowest member, so placing LPs of *similar* expected
  iteration count next to each other is the classic longest-processing-time
  batching argument.  `sort_for_packing` orders the batch by a cheap a-priori
  difficulty score; results are un-permuted before returning.
* **Shape buckets.** The routes are fixed-shape; a workload of LPs with
  different (m, nv) must be padded.  Padding every LP to the global max wastes
  memory and iteration work quadratically (the basis inverse is M²), so
  `solve_heterogeneous` groups LPs into (M, NV) *tier buckets* (rows and
  columns to caller-set granules), pads only within the bucket using the
  inert-padding scheme of `canonical.py` (padding rows carry a fixed [0,0]
  slack basic at 0; padding columns are fixed [0,0] — provably never active),
  and solves each bucket as one batch.

Both entry points keep the certification contract of the batched drivers
(`parallel.batched.resolve_unverified_host`): f32 device iterate, exact f64
host verification of every lane, scipy-HiGHS re-solve of the rare uncertified
lanes — callers always get exact, certified answers in the ORIGINAL input
order and column layout.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np


class LPResult(NamedTuple):
    """Per-LP certified answer in the LP's own column layout."""

    obj: float
    x: np.ndarray        # (n,) f64
    status: int
    niter: int
    verified: bool


def _split_slack(A, b, c, lo, hi, slack0):
    """Structural column count for layout [structural | identity slack | pad].

    Padding columns beyond slack0+m (inert FIXED [0,0] columns, e.g. the
    canonical form's column alignment) are accepted when `slack0` is given
    explicitly; with slack0=None the layout must be exactly [structural |
    slack] (nothing to infer the pad width from).
    """
    m, n = A.shape
    if slack0 is None:
        slack0 = n - m
    if n < slack0 + m:
        raise ValueError(
            f"expected layout [structural | identity slack | pad]: n={n}, "
            f"slack0={slack0}, m={m}"
        )
    return int(slack0)


def difficulty_scores(A, b, c, lo, hi, *, slack0=None, tol: float = 1e-9):
    """Cheap a-priori per-LP difficulty proxy for a batch (B, m, n).

    Iteration count of the two-phase simplex correlates with (a) how many
    initial basic (slack) values violate their bounds — each costs phase-1
    pivots — and (b) how many nonbasic columns price attractively at the
    initial point — an upper envelope on distinct phase-2 entering columns.
    Both are one vectorized pass over the batch (no solves):

      score = 2·#infeasible_rows + #attractive_cols

    The constant 2 reflects that phase-1 pivots also re-lengthen phase 2.
    Any monotone proxy works — the scheduler only needs *similar* LPs to sort
    near each other; exactness is irrelevant to correctness (tests assert the
    sorted solve is lane-for-lane identical to the unsorted one).
    """
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)
    B, m, n = A.shape
    s0 = _split_slack(A[0], b[0], c[0], lo[0], hi[0], slack0)

    loS, hiS = lo[:, :s0], hi[:, :s0]
    # initial nonbasic values: nearest finite bound (AT_LOWER preferred), the
    # same rule the engine uses (status.initial_vstat)
    xN = np.where(np.isfinite(loS), loS, np.where(np.isfinite(hiS), hiS, 0.0))
    xB = b - np.einsum("bmn,bn->bm", A[:, :, :s0], xN)
    loB, hiB = lo[:, s0:s0 + m], hi[:, s0:s0 + m]
    infeas = ((xB < loB - tol) | (xB > hiB + tol)).sum(axis=1)

    # reduced costs at the all-slack basis with zero slack costs are just the
    # structural objective; count columns that price attractively
    cS = c[:, :s0]
    at_lo = np.isfinite(loS)
    at_hi = ~at_lo & np.isfinite(hiS)
    free = ~at_lo & ~at_hi
    attractive = (
        (at_lo & (cS < -tol)) | (at_hi & (cS > tol)) | (free & (np.abs(cS) > tol))
    ).sum(axis=1)
    return (2 * infeas + attractive).astype(np.int64)


def sort_for_packing(scores) -> np.ndarray:
    """Stable order placing similar-difficulty LPs in adjacent lanes."""
    return np.argsort(np.asarray(scores), kind="stable")


def solve_batch_sorted(
    A, b, c, lo, hi, *, slack0=None, scores=None, **route_kwargs,
):
    """`batched.solve_batch_certified` with difficulty-sorted lane order.

    Sorts the batch by `difficulty_scores` (or a caller-supplied `scores`
    array), solves it, and returns results un-permuted — the output is
    positionally identical to the unsorted call.  `route_kwargs` pass
    through (`max_iter`, `route`, `interpret`).

    Simplex iteration counts are only weakly predictable a priori (corr ≈
    0.5–0.6 for every static feature tried), so for RE-SOLVE workloads pass
    last round's measured `res.niter` as `scores` — measured counts are the
    strongest predictor available.
    """
    from .batched import solve_batch_certified

    if scores is None:
        scores = difficulty_scores(A, b, c, lo, hi, slack0=slack0)
    order = sort_for_packing(scores)
    inv = np.empty_like(order)
    inv[order] = np.arange(order.size)
    take = lambda arr: np.asarray(arr)[order]
    res = solve_batch_certified(
        take(A), take(b), take(c), take(lo), take(hi), slack0=slack0,
        **route_kwargs,
    )
    back = lambda arr: np.asarray(arr)[inv]
    return res._replace(
        basis=back(res.basis), vstat=back(res.vstat), status=back(res.status),
        niter=back(res.niter), obj=back(res.obj),
        verified=back(res.verified), x=back(res.x),
    )


# ---------------------------------------------------------------------------
# Size bucketing (heterogeneous batches)
# ---------------------------------------------------------------------------

def _align_up(x: int, a: int) -> int:
    return ((x + a - 1) // a) * a if a > 1 else x


def pad_lp(A, b, c, lo, hi, slack0, M: int, NV: int):
    """Pad one LP (m, nv+m) → the bucket shape (M, NV+M), inert-padding scheme.

    Layout preserved: [structural | identity slack]; structural padding columns
    are FIXED [0,0]; padding rows have b=0 and a FIXED [0,0] slack that starts
    basic at 0 (feasible and provably inert — `canonical.py` docstring).
    """
    A = np.asarray(A, dtype=np.float64)
    m, n = A.shape
    nv = slack0
    Np = NV + M
    # the routes initialize the basis inverse to I, i.e. the slack block must
    # be an exact +1 identity (canonical.py encodes row direction in the slack
    # BOUNDS, not the coefficient sign)
    if not np.array_equal(A[:, nv:nv + m], np.eye(m)):
        raise ValueError("slack block A[:, slack0:slack0+m] must be identity")
    A_p = np.zeros((M, Np))
    A_p[:m, :nv] = A[:, :nv]
    A_p[np.arange(M), NV + np.arange(M)] = 1.0

    pad_vec = lambda v, fill_sv, fill_row: np.concatenate([
        np.asarray(v, dtype=np.float64)[:nv],
        np.full(NV - nv, fill_sv, dtype=np.float64),
        np.asarray(v, dtype=np.float64)[nv:],
        np.full(M - m, fill_row, dtype=np.float64),
    ])
    b_p = np.concatenate([np.asarray(b, dtype=np.float64), np.zeros(M - m)])
    c_p = pad_vec(c, 0.0, 0.0)
    lo_p = pad_vec(lo, 0.0, 0.0)
    hi_p = pad_vec(hi, 0.0, 0.0)
    return A_p, b_p, c_p, lo_p, hi_p


def _unpad_x(x_p, nv: int, m: int, NV: int) -> np.ndarray:
    return np.concatenate([x_p[:nv], x_p[NV:NV + m]])


def solve_heterogeneous(
    lps: Sequence[Tuple],
    *,
    row_granule: int = 8,
    col_granule: int = 32,
    sort_lanes: bool = True,
    max_iter: int = 2000,
    **route_kwargs,
) -> List[LPResult]:
    """Solve a heterogeneous list of LPs with size bucketing + sorted order.

    `lps` is a sequence of `(A, b, c, lo, hi)` (equality form, layout
    [structural | identity slack], minimize) or `(A, b, c, lo, hi, slack0)`.
    LPs are grouped into (rows→`row_granule`, structural cols→`col_granule`)
    tier buckets, padded only to their bucket's shape, difficulty-sorted
    within the bucket, solved as one batch per bucket, and returned as
    `LPResult`s in the ORIGINAL order and each LP's own column layout.
    `route_kwargs` pass through to `batched.solve_batch_certified`.

    Every result is certified: f64 host verification of the device basis,
    exact scipy-HiGHS re-solve of any uncertified lane.
    """
    from .batched import solve_batch_certified

    parsed = []
    for lp in lps:
        if len(lp) == 6:
            A, b, c, lo, hi, s0 = lp
        else:
            A, b, c, lo, hi = lp
            s0 = None
        s0 = _split_slack(A, b, c, lo, hi, s0)
        parsed.append((np.asarray(A, dtype=np.float64), np.asarray(b, np.float64),
                       np.asarray(c, np.float64), np.asarray(lo, np.float64),
                       np.asarray(hi, np.float64), s0))

    buckets: dict[Tuple[int, int], List[int]] = {}
    for i, (A, *_rest, s0) in enumerate(parsed):
        m = A.shape[0]
        tier = (_align_up(m, row_granule), _align_up(s0, col_granule))
        buckets.setdefault(tier, []).append(i)

    results: List[LPResult] = [None] * len(parsed)  # type: ignore[list-item]
    for (M, NV), idxs in buckets.items():
        padded = [pad_lp(*parsed[i][:5], parsed[i][5], M, NV) for i in idxs]
        Ab = np.stack([p[0] for p in padded])
        bb = np.stack([p[1] for p in padded])
        cb = np.stack([p[2] for p in padded])
        lob = np.stack([p[3] for p in padded])
        hib = np.stack([p[4] for p in padded])

        order = (sort_for_packing(difficulty_scores(Ab, bb, cb, lob, hib,
                                                    slack0=NV))
                 if sort_lanes else np.arange(len(idxs)))
        B = len(idxs)
        res = solve_batch_certified(
            Ab[order], bb[order], cb[order], lob[order], hib[order],
            slack0=NV, max_iter=max_iter, **route_kwargs,
        )
        for lane in range(B):
            i = idxs[int(order[lane])]
            A, b, c, lo, hi, s0 = parsed[i]
            results[i] = LPResult(
                obj=float(res.obj[lane]),
                x=_unpad_x(np.asarray(res.x[lane]), s0, A.shape[0], NV),
                status=int(res.status[lane]),
                niter=int(res.niter[lane]),
                verified=bool(res.verified[lane]),
            )
    return results
