"""Batched simplex kernel gate (Pallas, Triton route): interpret mode on the
CPU, cross-lowering to the Triton custom call, and the route's wrapper
(padding, certification).  The compiled kernel runs on the card in
tests/test_gpu.py.  Oracle: scipy-HiGHS per instance."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from minilp_tpu.ops.kernels import batched_simplex as bs
from minilp_tpu.parallel.batched import (
    make_random_batch, make_random_batch_host, solve_batch_certified,
)
from minilp_tpu.status import Status

TRITON = dict(route="triton", interpret=True)


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


@pytest.mark.parametrize("seed,B,m,nv", [(0, 8, 8, 16), (1, 4, 16, 24)])
def test_megakernel_matches_oracle(seed, B, m, nv):
    key = jax.random.PRNGKey(seed)
    A, b, c, lo, hi, _, _ = map(np.asarray, make_random_batch(key, B, m, nv))
    res = solve_batch_certified(A, b, c, lo, hi, **TRITON)
    assert (np.asarray(res.status) == int(Status.OPTIMAL)).all()
    assert not np.asarray(res.host_resolved).any()  # the kernel certified all
    for i in range(B):
        ref = _highs(A[i], b[i], c[i], lo[i], hi[i])
        assert abs(float(res.obj[i]) - ref) <= 1e-9 * (1 + abs(ref)), i


def test_megakernel_agrees_with_xla_engine():
    from minilp_tpu.options import SolverOptions
    from minilp_tpu.parallel.batched import solve_batch

    key = jax.random.PRNGKey(7)
    args = make_random_batch(key, 6, 8, 12)
    A, b, c, lo, hi, vstat0, basis0 = args
    res = solve_batch_certified(*map(np.asarray, args[:5]), **TRITON)
    ref = solve_batch(*args, opts=SolverOptions())
    np.testing.assert_allclose(
        np.asarray(res.obj), np.asarray(ref.obj), rtol=1e-9, atol=1e-9
    )


@pytest.mark.parametrize("seed", range(3))
def test_megakernel_canonical_layout(seed):
    """Kernel on canonicalize() output (slack block at slack0=nv, inert
    padding after — the wrapper moves it behind its own padding rows):
    free vars, at-upper vars, Eq/Ge rows, maximize."""
    from minilp_tpu.canonical import canonicalize
    from .oracle import random_problem, solve_with_oracle

    rng = np.random.default_rng(7100 + seed)
    prob = random_problem(
        rng, nv=int(rng.integers(4, 10)), m=int(rng.integers(2, 8))
    )
    outcome, obj, _x = solve_with_oracle(prob)
    if outcome != "optimal":
        pytest.skip("instance not optimal")
    can = canonicalize(prob, dtype=np.float64)
    res = solve_batch_certified(
        can.A[None], can.b[None], can.c[None], can.lo[None], can.hi[None],
        slack0=can.nv, max_iter=4000, **TRITON,
    )
    assert bool(res.verified[0])
    got = float(can.obj_sign * float(res.obj[0]))
    assert abs(got - obj) <= 1e-7 * (1 + abs(obj)), (got, obj)


@pytest.mark.parametrize("m,n", [(8, 28), (16, 32), (32, 128), (33, 100),
                                 (64, 256)])
def test_padded_dims_powers_of_two(m, n):
    mp, np_ = bs.padded_dims(m, n)
    assert mp >= max(m, bs.MIN_DIM) and np_ >= n + (mp - m)
    assert mp & (mp - 1) == 0 and np_ & (np_ - 1) == 0
    assert bs.fits(m, n) == (mp <= bs.MAX_ROWS and mp * np_ <= bs.MAX_CELLS)


def test_pad_batch_roundtrip_is_inert():
    """Padding rows/columns carry no information: the padded LP has the same
    HiGHS optimum, and unpad_result maps a padded basis back exactly."""
    A, b, c, lo, hi = make_random_batch_host(3, batch=2, m=6, nv=10)
    Ap, bp, cp, lop, hip = bs.pad_batch(A, b, c, lo, hi, slack0=10)
    assert Ap.shape == (2, 16, 32)
    for i in range(2):
        f0 = _highs(A[i], b[i], c[i], lo[i], hi[i])
        f1 = _highs(Ap[i].astype(np.float64), bp[i], cp[i], lop[i], hip[i])
        assert abs(f0 - f1) <= 1e-5 * (1 + abs(f0))  # f32-rounded copy
    basis_p = np.broadcast_to(np.arange(10, 26), (2, 16)).astype(np.int32)
    vstat_p = np.zeros((2, 32), np.int32)
    basis, vstat = bs.unpad_result(basis_p, vstat_p, 6, 16, 10)
    np.testing.assert_array_equal(basis, np.broadcast_to(np.arange(10, 16),
                                                         (2, 6)))
    assert vstat.shape == (2, 16)


@pytest.mark.parametrize("m,n", [(16, 32), (32, 128), (64, 256)])
def test_kernel_lowers_to_triton(m, n):
    """The kernel cross-lowers for CUDA to one Triton custom call at each
    power-of-two width (every primitive has a Triton rule); what ptxas says
    of it shows only on the card."""
    from jax import export

    f32 = lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)
    with jax.enable_x64(False):
        exp = export.export(
            jax.jit(lambda *a: bs.simplex_kernel_call(
                *a, slack0=n - m, max_iter=2000)),
            platforms=("cuda",),
            disabled_checks=[export.DisabledSafetyCheck.custom_call(
                "__gpu$xla.gpu.triton")],
        )(f32(4, m, n), f32(4, m), f32(4, n), f32(4, n), f32(4, n))
    text = exp.mlir_module()
    assert text.count("__gpu$xla.gpu.triton") == 1
    assert "name = \"batched_simplex\"" in text or "batched_simplex" in text


@pytest.mark.parametrize("route", ["xla", "triton"])
def test_solve_batch_certified_all_lanes(route):
    """solve_batch_certified returns an all-verified batch (host fallback
    covers any lane the f32 iterate could not certify)."""
    key = jax.random.PRNGKey(11)
    A, b, c, lo, hi, _, _ = map(np.asarray, make_random_batch(key, 8, 8, 16))
    res = solve_batch_certified(A, b, c, lo, hi, route=route,
                                interpret=route == "triton")
    assert np.asarray(res.verified).all()
    assert (np.asarray(res.status) == int(Status.OPTIMAL)).all()
    # exact vertex consistency: A x = b and c·x = obj in f64
    xn = np.asarray(res.x)
    resid = np.abs(np.einsum("bmn,bn->bm", A, xn) - b).max()
    assert resid < 1e-9
    np.testing.assert_allclose(
        np.einsum("bn,bn->b", c, xn), np.asarray(res.obj), rtol=1e-12,
        atol=1e-12
    )


def test_megakernel_envelope_64x256():
    # the kernel's full envelope: padded 64×256
    A, b, c, lo, hi, _, _ = map(
        np.asarray, make_random_batch(jax.random.PRNGKey(5), 2, 64, 192))
    res = solve_batch_certified(A, b, c, lo, hi, max_iter=4000, **TRITON)
    assert not np.asarray(res.host_resolved).any()
    for i in range(2):
        ref = _highs(A[i], b[i], c[i], lo[i], hi[i])
        assert abs(float(res.obj[i]) - ref) <= 1e-8 * (1 + abs(ref))
