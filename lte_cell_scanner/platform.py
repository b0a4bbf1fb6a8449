"""The one place that maps the JAX platform to a device implementation.

- ``cpu``: the float64 parity path. Tests and the host reference run
  here with ``jax_enable_x64``; the PSS scan tables come back in float64
  and the scan's greedy peak search stays on the host (ops/peak.py).
- ``gpu``: the float32 XLA path. The scan and its peak search run as one
  device program (ops/xcorr_jax.scan_and_peaks), and every matmul traced
  through :func:`jit` runs at :data:`MATMUL_PRECISION`.

Any other platform is an error: nothing in this package has been
written or checked for it.
"""

from __future__ import annotations

import functools
import subprocess

import jax
import numpy as np

# Float32 matmuls at full float32 precision. XLA's default on the GPU
# lets cuBLAS run them in TF32 (a 10-bit mantissa), which moves the scan
# scores, the DFT grids and the Viterbi branch metrics away from the
# float64 host reference; the Viterbi decode must stay bit-identical to
# the host decoder for tie-free LLRs (models/convcode_jax.py).
MATMUL_PRECISION = "highest"
MATMUL_PRECISION_NOTE = ("float32 matmuls at precision=HIGHEST (full "
                         "float32, no TF32) on every device program")

SUPPORTED = ("cpu", "gpu")


def name() -> str:
    """The JAX platform in use: "cpu" or "gpu"; anything else raises."""
    p = jax.default_backend()
    if p not in SUPPORTED:
        raise RuntimeError(
            f"unsupported JAX platform {p!r}: this program runs on the CPU "
            "(float64 reference, tests) or an NVIDIA GPU")
    return p


def scan_dtype():
    """Real dtype of the device scan: float64 only on the CPU parity
    path with x64 enabled, float32 everywhere else."""
    if name() == "cpu" and jax.config.jax_enable_x64:
        return np.float64
    return np.float32


def device_peaks() -> bool:
    """Whether the single-capture scan runs its greedy peak search on
    the device (GPU: only the ~1 KB peak table comes home) rather than
    on the host over float64 tables (CPU parity path)."""
    return name() == "gpu"


def wideband_backend() -> str:
    """Channelizer for a wideband recording: the one-dispatch device
    filter bank on the GPU, the float64 host channelizer on the CPU."""
    return "jax" if name() == "gpu" else "numpy"


def jit(fun=None, **jit_kwargs):
    """``jax.jit`` whose trace runs every matmul at MATMUL_PRECISION.

    The precision is a trace-time setting, so it is entered inside the
    traced function: callers need no context of their own."""
    if fun is None:
        return functools.partial(jit, **jit_kwargs)

    @functools.wraps(fun)
    def at_precision(*args, **kwargs):
        with jax.default_matmul_precision(MATMUL_PRECISION):
            return fun(*args, **kwargs)

    return jax.jit(at_precision, **jit_kwargs)


def require_gpu() -> dict:
    """Refuse to run a measurement anywhere but on a GPU (no CPU
    fallback). Returns the device as JAX reports it."""
    try:
        devs = jax.devices()
    except RuntimeError as e:
        raise SystemExit(f"no GPU found: {e}") from e
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU found: JAX platform is "
                         f"{devs[0].platform!r}; this measurement runs "
                         "only on an NVIDIA GPU")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_name_and_power() -> str:
    """The cards' names and power limits, as ``nvidia-smi`` reports them
    (one line per card); a card below its top power limit runs slower
    under load, so every device number is printed beside this."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return "\n".join(ln.strip() for ln in out.stdout.splitlines()
                     if ln.strip())
