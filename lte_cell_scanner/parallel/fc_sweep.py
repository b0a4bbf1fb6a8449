"""Data-parallel fc sweep: whole captures sharded across the device mesh.

The carrier-frequency loop is the reference's outermost, embarrassingly
parallel axis (src/CellSearch.cpp:471; SURVEY §2.9 names it the primary
scaling axis). Each device runs the complete single-capture scan —
correlation bank, incoherent k_factor fold, delay-spread smoothing, power
estimate, threshold, greedy peak extraction — on its share of the
captures; the only host traffic is the per-capture peak tables (~1 KB
each). Combined with the (seq, hyp) sharding in sharded_search.py this
covers all three parallel axes of the problem.
"""

from __future__ import annotations

from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lte_cell_scanner import platform
from lte_cell_scanner.constants import DS_COMB_ARM, PSS_TD_LEN
from lte_cell_scanner.models.cell import Cell
from lte_cell_scanner.ops.peak_jax import (
    MAX_PEAKS,
    peaks_to_cells,
    r_th1_normalized,
)
from lte_cell_scanner.ops.xcorr import n_comb_sp_for, n_comb_xc_for
from lte_cell_scanner.ops.xcorr_jax import (_scan_and_peaks, planes_to_ri,
                                            scan_inputs)


_JIT_CACHE: dict = {}        # program-key -> jitted sweep callable
                             # (a fresh closure per call would retrace —
                             # and recompile — every sweep invocation)


def _cache_put(cache: dict, key, value, cap: int = 8):
    """Bounded FIFO insert (compiled programs are large)."""
    if len(cache) >= cap:
        cache.pop(next(iter(cache)))
    cache[key] = value


def _to_complex(capbufs: np.ndarray, b: int = None):
    """(B, 2, n) planes (uint8 radio bytes or float) -> complex (B, n)
    (pass-through for complex input); with ``b``, only that capture."""
    if capbufs.ndim != 3:
        return capbufs if b is None else capbufs[b]
    if b is not None:
        capbufs = capbufs[b:b + 1]
    if capbufs.dtype == np.uint8:
        f = (capbufs.astype(np.float32) - 127.0) / 128.0
    else:
        f = capbufs
    c = f[:, 0] + 1j * f[:, 1]
    return c if b is None else c[0]


@platform.jit
def capture_stack(planes):
    """(B, 2, n) re/im planes (uint8 radio bytes or float) -> the
    (B*n, 2) f32 capture stack the batched decode programs index with
    per-candidate bases (ops/sync_jax, ops/mib_jax)."""
    f = ((planes.astype(jnp.float32) - 127.0) / 128.0
         if planes.dtype == jnp.uint8 else planes.astype(jnp.float32))
    return jnp.moveaxis(f, 1, 2).reshape(-1, 2)


def make_cap_mesh(n_cap_shards: int) -> Mesh:
    devs = np.array(jax.devices()[:n_cap_shards])
    return Mesh(devs, axis_names=("cap",))


def _as_planes(capbufs):
    """Host or device captures -> (B, 2, n) planes: complex host input
    becomes f32 planes; uint8/float planes and device arrays pass
    through untouched (they convert on device)."""
    if isinstance(capbufs, jax.Array):
        return capbufs
    capbufs = np.asarray(capbufs)
    if capbufs.ndim == 3:
        return capbufs
    return np.stack([capbufs.real, capbufs.imag], 1).astype(np.float32)


def sweep_call(capbufs, fc_list: Sequence[float], f_search_set: np.ndarray,
               mesh: Mesh, fs_programmed: float = 1.92e6,
               ds_comb_arm: int = DS_COMB_ARM, max_peaks: int = MAX_PEAKS,
               fc_prog_list: Sequence[float] = None):
    """The DP scan as (program, args): ``program(*args)`` returns the
    device (B, max_peaks, 4) peak tables, sharded over ``cap``.

    Each device scans its captures one at a time (``lax.map``): the
    im2col stack and correlation of ONE capture (~0.3 GB at 31
    hypotheses) bound the program's working set, whatever the batch.
    Exposed so a caller can compile it alone and read its
    ``memory_analysis()``."""
    planes = _as_planes(capbufs)
    B, _, n_cap = planes.shape
    fcp = list(fc_list) if fc_prog_list is None else list(fc_prog_list)
    n_shards = mesh.shape["cap"]
    if B % n_shards:
        raise ValueError(f"B={B} not divisible by cap shards {n_shards}")
    f_search_set = np.asarray(f_search_set, dtype=np.float64)
    n_lags = n_cap - (PSS_TD_LEN - 1)
    # The fold count must be uniform across the batch (static shapes):
    # take the min over the swept carriers.
    n_comb_xc = min(n_comb_xc_for(n_lags, f_search_set, fc_list[b],
                                  fcp[b], fs_programmed)
                    for b in range(B))
    n_comb_sp = n_comb_sp_for(n_cap)
    r_norm = r_th1_normalized(n_comb_xc, ds_comb_arm)
    per = [scan_inputs(f_search_set, n_comb_xc, fc_list[b], fcp[b],
                       fs_programmed) for b in range(B)]
    tre, tim, starts = (np.stack([p[k] for p in per]) for k in range(3))

    mesh_key = (tuple(str(d) for d in mesh.devices.flat),
                tuple(mesh.shape.items()))
    jit_key = (mesh_key, n_comb_sp, ds_comb_arm, float(r_norm), max_peaks)
    program = _JIT_CACHE.get(jit_key)
    if program is None:
        def local_scan(cap_loc, tr_loc, ti_loc, st_loc):
            def one(args):
                c, tr, ti, st = args
                return _scan_and_peaks(planes_to_ri(c), tr, ti, st, r_norm,
                                       n_comb_sp, ds_comb_arm, max_peaks)

            return jax.lax.map(one, (cap_loc, tr_loc, ti_loc, st_loc))

        program = platform.jit(shard_map(local_scan, mesh=mesh,
                                         in_specs=(P("cap"),) * 4,
                                         out_specs=P("cap"),
                                         check_vma=False))
        _cache_put(_JIT_CACHE, jit_key, program)
    shard = NamedSharding(mesh, P("cap"))
    args = [jax.device_put(x, shard) for x in (planes, tre, tim, starts)]
    return program, args


def sharded_fc_sweep(capbufs, fc_list: Sequence[float],
                     f_search_set: np.ndarray, mesh: Mesh,
                     fs_programmed: float = 1.92e6,
                     ds_comb_arm: int = DS_COMB_ARM,
                     max_peaks: int = MAX_PEAKS,
                     fc_prog_list: Sequence[float] = None,
                     return_tables: bool = False):
    """Scan B captures (one per center frequency) data-parallel over the
    ``cap`` mesh axis. Returns the candidate peak list per capture.

    B must be a multiple of the mesh size. Each capture gets its own
    frequency-shifted templates and fold schedule (fc-dependent k_factor
    arithmetic), built on host in float64 and sharded alongside it.

    ``capbufs`` may be complex (B, n_cap), or (B, 2, n_cap) re/im planes
    — uint8 radio bytes or float — on the host or already on the device
    (the wideband channelizer's output, the pipelined sweep's chunks).
    Planes convert on device, so device-resident input never moves
    through the host.

    ``fc_prog_list`` carries the tuner's actually-programmed carriers
    (defaults to fc_list) — the k_factor arithmetic uses it exactly as
    the per-fc path does.

    ``return_tables=True`` returns the DEVICE peak-table array (D2H
    copy already started) instead of peak lists — a pipelined sweep
    (search/pipeline.py) collects it a batch later via
    :func:`tables_to_peaks` so the fetch overlaps the next batch's work.
    """
    program, args = sweep_call(capbufs, fc_list, f_search_set, mesh,
                               fs_programmed, ds_comb_arm, max_peaks,
                               fc_prog_list)
    tables_dev = program(*args)
    if return_tables:
        tables_dev.copy_to_host_async()
        return tables_dev
    fcp = list(fc_list) if fc_prog_list is None else list(fc_prog_list)
    return tables_to_peaks(np.asarray(tables_dev), _host_captures(capbufs),
                           fc_list, f_search_set, fs_programmed,
                           ds_comb_arm, max_peaks, fc_prog_list=fcp)


def _host_captures(capbufs):
    """Lazy per-capture host accessor for the rare table-full fallback
    (a device-resident batch is fetched one capture at a time)."""
    if isinstance(capbufs, jax.Array):
        return lambda b: np.asarray(capbufs[b])
    return np.asarray(capbufs)


def tables_to_peaks(tables: np.ndarray, capbufs, fc_list: Sequence[float],
                    f_search_set: np.ndarray, fs_programmed: float = 1.92e6,
                    ds_comb_arm: int = DS_COMB_ARM,
                    max_peaks: int = MAX_PEAKS,
                    fc_prog_list: Sequence[float] = None
                    ) -> List[List[Cell]]:
    """Host tail of the DP scan: per-capture peak tables -> Cell
    candidates, with the unbounded host rescan fallback when a device
    table filled up (mirrors search/cell_search.py's fallback for the
    fused single-capture path; reference peak loop
    src/CellSearch.cpp:471-569).

    ``capbufs`` may be the (B, 2, n)/(B, n) capture array, or a callable
    ``b -> one capture`` ((2, n) planes or (n,) complex) so callers
    holding large batches (search/pipeline.py) don't materialize a copy
    for the rare fallback."""
    fcp = list(fc_list) if fc_prog_list is None else list(fc_prog_list)
    out: List[List[Cell]] = []
    for b, fc in enumerate(fc_list):
        cells = peaks_to_cells(tables[b], f_search_set, fc, fcp[b],
                               fs_programmed)
        if len(cells) >= max_peaks:
            # Device peak table full: the fixed-trip loop may have
            # truncated a denser capture — redo this capture with the
            # unbounded host scan.
            from lte_cell_scanner.ops.peak import peak_search
            from lte_cell_scanner.ops.xcorr import xcorr_pss
            from lte_cell_scanner.search.cell_search import \
                detection_threshold

            cap_b = (_to_complex(np.asarray(capbufs(b))[None], 0)
                     if callable(capbufs)
                     else _to_complex(np.asarray(capbufs), b))
            r = xcorr_pss(cap_b,
                          f_search_set,
                          ds_comb_arm, fc, fcp[b],
                          fs_programmed, backend="numpy")
            z_th1 = detection_threshold(r.sp_incoherent, r.n_comb_xc,
                                        ds_comb_arm)
            cells = peak_search(r.xc_incoherent_collapsed_pow,
                                r.xc_incoherent_collapsed_frq, z_th1,
                                f_search_set, fc, fcp[b],
                                r.xc_incoherent_single, ds_comb_arm,
                                fs_programmed)
        out.append(cells)
    return out


def sharded_search_sweep(capbufs: np.ndarray, fc_list: Sequence[float],
                         f_search_set: np.ndarray, mesh: Mesh,
                         fs_programmed: float = 1.92e6,
                         thresh2_n_sigma: float = None,
                         dedup_cells: bool = True,
                         fc_prog_list: Sequence[float] = None):
    """Full cell search of a whole fc sweep: DP-sharded scan + batched
    device decode of EVERY candidate in the sweep.

    The scan runs data-parallel over the ``cap`` mesh axis
    (sharded_fc_sweep); all surviving candidates across all captures are
    then decoded in two fixed-shape device dispatches (sync + MIB) over a
    single stacked capture buffer — the per-candidate chain never touches
    host NumPy. Returns (cells_per_capture, deduped) where ``deduped``
    merges across the sweep like src/CellSearch.cpp:285-319.
    """
    from lte_cell_scanner.constants import THRESH2_N_SIGMA
    from lte_cell_scanner.ops.mib_jax import decode_mib_batch
    from lte_cell_scanner.ops.sync_jax import sss_foe_batch
    from lte_cell_scanner.search.cell_search import dedup

    if thresh2_n_sigma is None:
        thresh2_n_sigma = THRESH2_N_SIGMA
    if not isinstance(capbufs, jax.Array):
        capbufs = np.asarray(capbufs)
    B, n_cap = capbufs.shape[0], capbufs.shape[-1]
    peaks = sharded_fc_sweep(capbufs, fc_list, f_search_set, mesh,
                             fs_programmed, fc_prog_list=fc_prog_list)

    # One flattened capture stack; every candidate carries its base.
    cap_dev = capture_stack(jnp.asarray(_as_planes(capbufs)))
    all_cells, bases = [], []
    for b in range(B):
        for c in peaks[b]:
            all_cells.append(c)
            bases.append(b * n_cap)
    synced = sss_foe_batch(all_cells, None, 0.0, 0.0, fs_programmed,
                           thresh2_n_sigma, cap_dev=cap_dev, n_cap=n_cap,
                           cap_bases=bases)
    alive = [(c, base) for c, base in zip(synced, bases) if c.n_id_1 >= 0]
    decoded = []
    for cp in ("normal", "extended"):
        group = [(c, base) for c, base in alive if c.cp_type == cp]
        if not group:
            continue
        res = decode_mib_batch([c for c, _ in group], None, 0.0, 0.0,
                               fs_programmed, cap_dev=cap_dev, n_cap=n_cap,
                               cap_bases=[base for _, base in group])
        decoded.extend(zip(res, (base for _, base in group)))
    good = [(c, base) for c, base in decoded if c.n_rb_dl >= 0]

    per_cap: List[List[Cell]] = [[] for _ in range(B)]
    for c, base in good:
        per_cap[base // n_cap].append(c)
    good_cells = [c for c, _ in good]
    return per_cap, (dedup(good_cells) if dedup_cells else good_cells)
