"""The platform switch, the compile-cache rule and chip_smoke's guard."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lte_cell_scanner import platform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_platform_cpu_is_the_float64_parity_path():
    assert platform.name() == "cpu"
    assert platform.scan_dtype() == np.float64      # conftest enables x64
    assert not platform.device_peaks()
    assert platform.wideband_backend() == "numpy"


def test_platform_gpu_is_the_float32_device_path(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert platform.name() == "gpu"
    assert platform.scan_dtype() == np.float32
    assert platform.device_peaks()
    assert platform.wideband_backend() == "jax"


@pytest.mark.parametrize("other", ["tpu", "rocm", "METAL"])
def test_platform_other_names_raise(monkeypatch, other):
    monkeypatch.setattr(jax, "default_backend", lambda: other)
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        platform.name()
    with pytest.raises(RuntimeError):
        platform.scan_dtype()


def test_platform_jit_names_the_matmul_precision():
    """Every matmul traced through platform.jit carries the explicit
    precision (no TF32 on the GPU), static arguments included."""
    @platform.jit(static_argnames=("k",))
    def f(a, b, k=1):
        return jnp.einsum("ij,jk->ik", a, b) * k + a @ b

    a = jnp.ones((4, 4), jnp.float32)
    text = f.lower(a, a, k=2).as_text()
    assert text.count("precision = [HIGHEST, HIGHEST]") == 2
    np.testing.assert_allclose(np.asarray(f(a, a, k=2)), 12.0)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_rule(tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR set: it is the cache and nothing else is
    configured. Unset: one fixed directory inside the checkout, listed
    in .gitignore. The cell-table cache follows the same rule."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("JAX_COMPILATION_CACHE")}
    env["JAX_PLATFORMS"] = "cpu"
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    code = ("import json, jax, lte_cell_scanner as p; "
            "from lte_cell_scanner.ops.mib_jax import _table_cache_dir; "
            "print(json.dumps([jax.config.jax_compilation_cache_dir, "
            "p.cache_dir(), _table_cache_dir()]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.strip().splitlines()[-1]
    jax_dir, pkg_dir, table_dir = json.loads(out)
    want = (str(tmp_path) if env_set
            else os.path.join(REPO, ".jax_cache"))
    assert jax_dir == pkg_dir == table_dir == want
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cache_dir_function_follows_environment(tmp_path):
    import lte_cell_scanner as pkg

    assert pkg.cache_dir({"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}) \
        == str(tmp_path)
    assert pkg.cache_dir({}) == pkg.CHECKOUT_CACHE_DIR
    assert os.path.dirname(pkg.CHECKOUT_CACHE_DIR) == REPO


def test_chip_smoke_refuses_the_cpu():
    """No GPU: chip_smoke exits non-zero, says so, and prints no result
    line (there is no CPU fallback)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "no GPU found" in r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_guard_in_process():
    import chip_smoke

    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code != 0 and "no GPU found" in str(e.value.code)


def test_chip_smoke_result_line_keys():
    import chip_smoke

    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
              "count": 1}
    line = json.loads(chip_smoke.result_line(device))
    assert list(line) == ["ok", "device"] and line["ok"] is True
    assert list(line["device"]) == ["platform", "kind", "count"]
    assert line["device"] == device
