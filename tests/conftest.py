"""Test configuration: JAX on a virtual 8-device CPU mesh with float64.

Correctness tests run on the CPU: the float64 parity path of
lte_cell_scanner.platform, with XLA's host-platform device
virtualization for the multi-device tests. Tests marked ``gpu`` are the
card-only precision parity checks; they skip here and run on an NVIDIA
GPU with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_ENABLE_X64"] = "true"

import jax  # noqa: E402
import pytest  # noqa: E402

if os.environ["JAX_PLATFORMS"] == "cpu":
    # In case jax was imported before this file set the environment.
    jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips elsewhere); run with "
        "JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU. Decided here, at run time, never
    at import: every xdist worker must collect the same tests."""
    from lte_cell_scanner import platform

    if platform.name() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: JAX_PLATFORMS=cuda "
                    "python -m pytest -m gpu tests/)")


REFERENCE_DIR = "/root/reference"


def reference_path(*parts):
    return os.path.join(REFERENCE_DIR, *parts)


@pytest.fixture(scope="session")
def capbuf_0000():
    """The recorded 739 MHz capture with cell ID 271 (reference test anchor)."""
    from lte_cell_scanner.io.itfile import load_it

    path = reference_path("test", "capbuf_0000.it")
    if not os.path.exists(path):
        pytest.skip("reference capture not available")
    d = load_it(path)
    return d["capbuf"], float(d["fc"][0])
