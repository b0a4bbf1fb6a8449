"""LTE cell search & tracking framework on JAX.

A ground-up JAX/XLA re-design of the capabilities of the
LTE-Cell-Scanner reference suite (CellSearch + LTE-Tracker): find and track
LTE base-station cells from 1.92 Msps IQ captures, decoding PSS/SSS sync,
estimating time/frequency offsets, and blind-decoding the PBCH MIB.

Layer map (mirrors the capability inventory of the reference, re-architected
for a GPU; ``platform`` picks the device implementation):

- ``utils``    — DSP primitives (reference: include/dsp.h, include/itpp_ext.h)
- ``models``   — LTE PHY tables & codecs (reference: src/lte_lib.cpp)
- ``ops``      — cell-search kernels, JAX device path + float64 host
                 reference path (reference: src/searcher.cpp)
- ``io``       — capture front end: .it files, raw rtl_sdr files,
                 record/replay, DL signal simulator (reference:
                 src/capbuf.cpp, src/itpp_ext.cpp, Matlab/create_dl_sig.m)
- ``search``   — batch cell-search driver + CLI (reference: src/CellSearch.cpp)
- ``tracker``  — realtime multi-cell tracking runtime (reference:
                 src/LTE-Tracker.cpp and the *_thread.cpp files)
- ``parallel`` — device-mesh sharding of the search pipeline (new; the
                 reference is single-machine OpenMP + pthreads)
"""

__version__ = "0.1.0"

import os as _os
import sys as _sys

# Persistent XLA compilation cache. Where JAX_COMPILATION_CACHE_DIR is
# set, JAX reads it itself and nothing else is configured here.
# Otherwise the cache lives at one fixed directory inside the checkout
# (listed in .gitignore): the cache key includes the path, so a
# directory that moves never hits.
CHECKOUT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def cache_dir(environ=_os.environ) -> str:
    """Directory of the compile cache and the cell-table cache."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR


if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    if "jax" in _sys.modules:
        # jax read its environment at import time: configure it directly.
        import jax as _jax

        if not _jax.config.jax_compilation_cache_dir:
            _jax.config.update("jax_compilation_cache_dir",
                               CHECKOUT_CACHE_DIR)
            _jax.config.update("jax_persistent_cache_min_compile_time_secs",
                               1)
    else:
        _os.environ["JAX_COMPILATION_CACHE_DIR"] = CHECKOUT_CACHE_DIR
        _os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS",
                               "1")

from lte_cell_scanner.constants import FS_LTE, CAPLENGTH  # noqa: F401
from lte_cell_scanner.models.cell import Cell  # noqa: F401
