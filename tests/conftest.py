"""Test configuration: CPU backend with 8 virtual devices, f64 enabled.

Multi-device code paths are exercised on a faked 8-device CPU mesh (SURVEY.md
§5 (d) — the standard JAX host-count-simulation trick).

Tests that need an NVIDIA GPU carry the `gpu` marker.  Whether a GPU is
present is decided at run time, inside the autouse fixture below, never while
modules are collected: such tests skip on the CPU, and `chip_smoke.py` runs
them on the card with ``MINILP_TEST_DEVICE=gpu`` (which leaves JAX's default
backend alone instead of forcing the CPU).
"""

import os

ON_DEVICE = os.environ.get("MINILP_TEST_DEVICE") == "gpu"

# Must run before jax is imported anywhere.
if not ON_DEVICE:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
if not ON_DEVICE:
    jax.config.update("jax_platforms", "cpu")


import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip `gpu`-marked tests unless JAX's default backend is a GPU."""
    if request.node.get_closest_marker("gpu") is not None:
        if jax.default_backend() != "gpu":
            pytest.skip("needs an NVIDIA GPU (run: python chip_smoke.py)")
    yield


def pytest_addoption(parser):
    parser.addoption(
        "--run-slow", action="store_true", default=False,
        help="run Netlib-scale slow tests",
    )


def pytest_configure(config):
    # Build the native MPS tokenizer once if the toolchain is present, so the
    # ctypes-path tests run instead of skipping (native/build.sh is one g++).
    import pathlib
    import shutil
    import subprocess

    native = pathlib.Path(__file__).resolve().parent.parent / "native"
    if not (native / "libmps_parser.so").exists() and shutil.which("g++"):
        try:
            subprocess.run(
                ["sh", str(native / "build.sh")], check=True,
                capture_output=True, timeout=120,
            )
        except (subprocess.SubprocessError, OSError):
            pass  # tests fall back to the pure-Python parser path
