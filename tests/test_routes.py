"""Route selection (minilp_tpu/routes.py): by backend, size and dtype, and
the errors for what the package does not run on."""

import jax
import pytest

from minilp_tpu import routes
from minilp_tpu.utils import compile_cache


@pytest.mark.parametrize("name", ["cpu", "gpu"])
def test_known_backends(name):
    assert routes.backend(name) == name


@pytest.mark.parametrize("name", ["rocm", "metal", "neuron"])
def test_unknown_backend_raises(name):
    with pytest.raises(routes.UnsupportedBackend, match=name):
        routes.backend(name)
    with pytest.raises(routes.UnsupportedBackend):
        routes.cold_route(512, "float64", backend_name=name)
    with pytest.raises(routes.UnsupportedBackend):
        routes.batched_route(32, 128, backend_name=name)
    with pytest.raises(routes.UnsupportedBackend):
        routes.device_pdhg(backend_name=name)


def test_default_backend_is_cpu_here():
    assert routes.backend() == jax.default_backend() == "cpu"


@pytest.mark.parametrize("M,dtype,crossover,backend,expected", [
    (824, "float64", "auto", "gpu", "device_xla"),       # 25fv47 shape
    (2048, "float64", "auto", "gpu", "device_xla"),      # last dense bucket
    (3136, "float64", "auto", "gpu", "crossover"),       # maros-r7 shape
    (3136, "float64", "never", "gpu", "host_sparse"),
    (3136, "float32", "auto", "gpu", "device_xla"),      # f32: no crossover
    (3136, "float64", "auto", "cpu", "crossover"),
    (824, "float64", "auto", "cpu", "device_xla"),
    (8, "float64", "never", "cpu", "device_xla"),
])
def test_cold_route(M, dtype, crossover, backend, expected):
    assert routes.cold_route(M, dtype, crossover, backend_name=backend) == expected


def test_cold_route_rejects_unknown_crossover():
    with pytest.raises(ValueError, match="crossover"):
        routes.cold_route(4096, "float64", "sometimes", backend_name="gpu")


@pytest.mark.parametrize("backend,expected", [("gpu", True), ("cpu", False)])
def test_device_pdhg(backend, expected):
    assert routes.device_pdhg(backend_name=backend) is expected


@pytest.mark.parametrize("m,n,backend,expected", [
    (32, 128, "gpu", "triton"),    # the scenario shape: padded 32×128
    (8, 24, "gpu", "triton"),      # padded to the 16×32 floor
    (64, 192, "gpu", "triton"),    # the envelope's edge: padded 64×256
    (65, 160, "gpu", "xla"),       # 128 padded rows: beyond the envelope
    (32, 600, "gpu", "xla"),       # padded 32×1024: beyond the envelope
    (32, 128, "cpu", "xla"),       # no card: the plain route
])
def test_batched_route(m, n, backend, expected):
    assert routes.batched_route(m, n, backend_name=backend) == expected


def test_cpu_device_missing_raises(monkeypatch):
    def no_cpu(platform=None):
        raise RuntimeError("Unknown backend cpu")

    monkeypatch.setattr(jax, "devices", no_cpu)
    with pytest.raises(routes.UnsupportedBackend, match="JAX_PLATFORMS"):
        routes.cpu_device()


def test_compile_cache_env_set_is_left_alone(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path / "from_env"))
    assert compile_cache.configure("/x/y/script.py") == str(tmp_path / "from_env")
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_env_unset_uses_script_dir(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    script = tmp_path / "checkout" / "chip_smoke.py"
    try:
        got = compile_cache.configure(str(script))
        assert got == str(tmp_path / "checkout" / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
