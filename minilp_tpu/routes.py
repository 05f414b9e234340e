"""Route selection: which engine runs a solve, decided in one place.

Every decision here reads only what the code can observe — the JAX backend,
the padded shape and the working dtype — so users do not pick routes with
options.  The backends this package is built for are the CPU (tests, and
machines without an accelerator) and an NVIDIA GPU; any other backend is an
error rather than a silent fallback.

Routes, by regime:

* cold single LP (`cold_route`):
  - ``"crossover"``: f64, padded M > 2048 — PDHG → basis identification →
    exact host polish (`engine/crossover.py`);
  - ``"host_sparse"``: f64, padded M > 2048 with the crossover disabled —
    the host sparse simplex from the slack basis (`engine/hostlp.py`);
  - ``"device_xla"``: everything else — the dense f64 XLA engine
    (`engine/primal.py`) on the default device.
* PDHG stage of the crossover (`device_pdhg`): on the GPU the dense f32
  stage runs on the card; on the CPU the host sparse f64 stage runs alone.
* scenario batches (`batched_route`): ``"triton"`` (the one-LP-per-program
  kernel, `ops/kernels/batched_simplex.py`) on the GPU inside the kernel's
  envelope, else ``"xla"`` (the vmapped f32 engine, `parallel/batched.py`).
"""

from __future__ import annotations

import jax

#: backends this package runs on
KNOWN_BACKENDS = ("cpu", "gpu")

#: padded-row threshold above which cold f64 solves leave the dense engine
CROSSOVER_MIN_ROWS = 2048


class UnsupportedBackend(RuntimeError):
    """JAX's default backend is neither the CPU nor an NVIDIA GPU."""


def backend(name: str | None = None) -> str:
    """The default JAX backend, checked against `KNOWN_BACKENDS`."""
    b = jax.default_backend() if name is None else name
    if b not in KNOWN_BACKENDS:
        raise UnsupportedBackend(
            f"JAX backend {b!r} is not supported; minilp_tpu runs on "
            f"{' or '.join(KNOWN_BACKENDS)}"
        )
    return b


def cpu_device():
    """The host CPU device for host-pinned stages; a clear error when the
    CPU platform was excluded (e.g. ``JAX_PLATFORMS=cuda``)."""
    try:
        return jax.devices("cpu")[0]
    except RuntimeError as e:
        raise UnsupportedBackend(
            "the host CPU backend is not visible to JAX; host-pinned solver "
            "stages need it (leave 'cpu' in JAX_PLATFORMS)"
        ) from e


def cold_route(M: int, dtype: str, crossover: str = "auto",
               backend_name: str | None = None) -> str:
    """Engine for a cold single-LP solve at padded row count M."""
    backend(backend_name)
    if crossover not in ("auto", "never"):
        raise ValueError(f"unknown crossover {crossover!r}")
    if dtype == "float64" and M > CROSSOVER_MIN_ROWS:
        return "crossover" if crossover == "auto" else "host_sparse"
    return "device_xla"


def device_pdhg(backend_name: str | None = None) -> bool:
    """Whether the crossover's dense f32 PDHG stage runs on the device."""
    return backend(backend_name) == "gpu"


def batched_route(m: int, n: int, backend_name: str | None = None) -> str:
    """Engine for a batch of (m, n) scenario LPs."""
    from .ops.kernels import batched_simplex

    if backend(backend_name) == "gpu" and batched_simplex.fits(m, n):
        return "triton"
    return "xla"
