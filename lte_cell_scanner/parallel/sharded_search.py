"""Multi-chip sharding of the PSS scan over a jax.sharding.Mesh.

The reference is single-machine (OpenMP over correlation lags,
src/searcher.cpp:152-154). The device scaling axes, per the structure
of the algorithm:

- ``seq``  — the 80 ms capture folds into n_comb_xc half-frame segments
  that are combined *incoherently* (src/searcher.cpp:263-308). Each device
  takes a contiguous run of fold segments (its slice of the capture plus a
  small halo for the 137-tap correlation window and k_factor drift),
  computes its partial (3, 9600, n_f) fold sums, and a single ``psum``
  over the mesh produces the full incoherent table on every device.
  Capture duration then scales linearly with devices.
- ``hyp``  — the frequency-hypothesis grid is embarrassingly parallel:
  each device correlates its slice of f_search_set and an ``all_gather``
  reassembles the hypothesis axis before the collapse.
- ``cap``  — whole captures (the fc sweep) are data-parallel via a leading
  batch axis.

The greedy peak cancellation stays on host (inherently sequential over a
tiny 3x9600 table).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lte_cell_scanner import platform
from lte_cell_scanner.constants import HALF_FRAME, PSS_TD_LEN
from lte_cell_scanner.ops.xcorr import (
    XcorrResult,
    fold_start_indices,
    n_comb_sp_for,
    shifted_templates,
)
from lte_cell_scanner.ops.xcorr_jax import (
    _delay_spread,
    correlate_conv,
    win_sum,
)

# Blocks start _LEFT_PAD samples before their first fold segment (fold
# positions drift by |k-1| * n_cap < ~16 samples at 100 ppm, in either
# direction) and extend far enough past the last segment for the 137-tap
# correlation window, the 274-sample power window, and the same drift.
_LEFT_PAD = 64
_RIGHT_PAD = 280


# Input layout of the shard_map program (order matches _sharded_scan_fn):
# blocks, local_starts, valid, valid_sp, sp_off, tpl_re, tpl_im.
_IN_SPECS = (P("seq", None, None), P("seq", "hyp", None),
             P("seq", None), P("seq", None), P("seq"),
             P("hyp", None), P("hyp", None))


def make_search_mesh(n_seq: int, n_hyp: int = 1):
    """Build an (seq, hyp) mesh from the first n_seq*n_hyp devices.

    With jax.distributed initialized, jax.devices() enumerates the GLOBAL
    device list, so the same mesh spans every participating process —
    ``seq`` is laid out process-major so each host owns a contiguous run
    of fold segments and the psum's cross-host leg (DCN in a real pod,
    gloo in the CPU dryrun) carries only the (3, 9600, n_f_local) partial
    fold tables.
    """
    devs = np.array(jax.devices()[: n_seq * n_hyp]).reshape(n_seq, n_hyp)
    return Mesh(devs, axis_names=("seq", "hyp"))


def _stage_inputs(mesh: Mesh, args, specs=_IN_SPECS):
    """Host arrays -> device arrays on the mesh.

    Single-process: jnp.asarray (jit moves them). Multi-process: each
    process materializes only its addressable shards via
    make_array_from_callback (a plain numpy arg would fail — no process
    holds all of a multi-host array's devices).
    """
    if jax.process_count() == 1:
        return [jnp.asarray(a) for a in args]
    out = []
    for a, spec in zip(args, specs):
        a = np.asarray(a)
        sh = NamedSharding(mesh, spec)
        out.append(jax.make_array_from_callback(
            a.shape, sh, lambda idx, a=a: a[idx]))
    return out


def _fetch(x) -> np.ndarray:
    """Replicated device array -> local numpy (multi-process safe)."""
    if jax.process_count() == 1:
        return np.asarray(x)
    return np.asarray(x.addressable_data(0))


def _plan_blocks(n_cap: int, n_seq: int) -> Tuple[int, int, int]:
    """Split the fold segments across seq shards.

    Returns (n_comb_xc, combs_per_shard, block_len). Shard d covers fold
    segments [d*cps, (d+1)*cps) and needs capture samples
    [d*cps*9600, ... + cps*9600 + halo).
    """
    n_lags = n_cap - (PSS_TD_LEN - 1)
    n_comb_xc = (n_lags - 100) // HALF_FRAME
    cps = -(-n_comb_xc // n_seq)  # ceil: last shard may have fewer
    block_len = _LEFT_PAD + cps * HALF_FRAME + PSS_TD_LEN - 1 + _RIGHT_PAD
    return n_comb_xc, cps, block_len


def _shard_inputs(capbuf, f_search_set, fc_requested, fc_programmed,
                  fs_programmed, n_seq, n_hyp, dtype):
    """Host-side prep: per-shard capture blocks, templates, fold offsets."""
    capbuf = np.asarray(capbuf)
    n_cap = capbuf.shape[0]
    n_comb_xc, cps, block_len = _plan_blocks(n_cap, n_seq)
    f_search_set = np.asarray(f_search_set, dtype=np.float64)
    n_f = len(f_search_set)
    if n_f % n_hyp:
        raise ValueError(f"n_f={n_f} must divide over n_hyp={n_hyp} shards")

    cap_ri = np.stack([capbuf.real, capbuf.imag], -1).astype(dtype)
    blocks = np.zeros((n_seq, block_len, 2), dtype=dtype)
    starts = fold_start_indices(f_search_set, n_comb_xc, fc_requested,
                                fc_programmed, fs_programmed)  # (n_f, n_comb)
    local_starts = np.zeros((n_seq, n_f, cps), dtype=np.int32)
    # Masks of valid fold segments per shard (the tail shard may pad).
    # The signal-power estimate folds its own count (n_comb_sp_for) — the
    # correlation count would average zero-padded windows past the
    # capture end and bias the detection threshold low.
    valid = np.zeros((n_seq, cps), dtype=dtype)
    n_sp_eff = min(n_comb_sp_for(n_cap), n_seq * cps)
    valid_sp = np.zeros((n_seq, cps), dtype=dtype)
    sp_off = np.zeros(n_seq, dtype=np.int64)
    for d in range(n_seq):
        base = max(0, d * cps * HALF_FRAME - _LEFT_PAD)
        sp_off[d] = d * cps * HALF_FRAME - base
        chunk = cap_ri[base: base + block_len]
        blocks[d, :len(chunk)] = chunk
        for m in range(cps):
            g = d * cps + m
            if g < n_comb_xc:
                local_starts[d, :, m] = starts[:, g] - base
                valid[d, m] = 1.0
            if g < n_sp_eff:
                valid_sp[d, m] = 1.0
    assert (local_starts >= 0).all(), "halo too small for this ppm range"
    tpl = shifted_templates(f_search_set, fc_requested, fc_programmed,
                            fs_programmed).reshape(-1, PSS_TD_LEN)
    return (blocks, local_starts, valid, valid_sp,
            sp_off.astype(np.int32), tpl.real.astype(dtype),
            tpl.imag.astype(dtype), n_comb_xc, n_sp_eff)


def _sharded_scan_fn(block, local_starts, valid, valid_sp, sp_off, tpl_re,
                     tpl_im, n_comb_xc, ds_comb_arm):
    """Per-shard body (runs under shard_map).

    block: (block_len, 2); local_starts: (n_f_local, cps); valid: (cps,);
    sp_off: () local offset of the shard's first fold segment;
    tpl_*: (3*n_f_local, 137).
    Returns replicated (pow (3,9600), frq-global (3,9600), single, sp-term).
    """
    # shard_map keeps sharded leading axes as size-1 dims; drop them.
    block = block[0]
    local_starts = local_starts[0]
    valid = valid[0]
    valid_sp = valid_sp[0]
    xc_re, xc_im = correlate_conv(block, tpl_re, tpl_im)
    mag2 = xc_re * xc_re + xc_im * xc_im
    mag2 = jax.lax.optimization_barrier(mag2)
    n_f_local = tpl_re.shape[0] // 3
    m3 = mag2.reshape(n_f_local, 3, -1)

    slice_f = jax.vmap(
        lambda row, st: jax.lax.dynamic_slice_in_dim(row, st, HALF_FRAME, axis=1))
    cps = local_starts.shape[1]
    acc = jnp.zeros((n_f_local, 3, HALF_FRAME), mag2.dtype)
    for m in range(cps):
        acc = acc + valid[m] * slice_f(m3, local_starts[:, m])
    # Combine partial fold sums across the sequence shards.
    acc = jax.lax.psum(acc, axis_name="seq")
    single_local = jnp.transpose(acc / n_comb_xc, (1, 2, 0))  # (3,9600,n_f_l)
    # Reassemble the hypothesis axis.
    single = jax.lax.all_gather(single_local, axis_name="hyp", axis=2,
                                tiled=True)                    # (3,9600,n_f)
    inc = _delay_spread(single, ds_comb_arm)
    pow_ = inc.max(axis=2)
    frq = inc.argmax(axis=2).astype(pow_.dtype)

    # Signal power: each shard sums its own fold segments' 274-windows.
    pw = block[:, 0] ** 2 + block[:, 1] ** 2
    n_sp_local = cps * HALF_FRAME
    sp_all = win_sum(pw, 274) / 274.0
    sp = jax.lax.dynamic_slice_in_dim(sp_all, sp_off[0], n_sp_local)
    sp = sp.reshape(cps, HALF_FRAME) * valid_sp[:, None]
    sp_partial = jax.lax.psum(sp.sum(axis=0), axis_name="seq")
    # The block (and hence sp) is replicated over the hyp axis, so every
    # hyp shard computes the identical sp_partial — no extra combine is
    # needed across hyp.
    return pow_, frq, single, inc, sp_partial


def sharded_xcorr_pss(capbuf, f_search_set, ds_comb_arm, fc_requested,
                      fc_programmed, fs_programmed, mesh: Mesh,
                      dtype=np.float32) -> XcorrResult:
    """Run the PSS scan sharded over ``mesh`` axes (seq, hyp)."""
    n_seq = mesh.shape["seq"]
    n_hyp = mesh.shape["hyp"]
    capbuf = np.asarray(capbuf)

    (blocks, local_starts, valid, valid_sp, sp_off, tre, tim, n_comb_xc,
     n_sp_eff) = _shard_inputs(
        capbuf, f_search_set, fc_requested, fc_programmed, fs_programmed,
        n_seq, n_hyp, dtype)

    shard_jit = _shard_program(mesh, n_comb_xc, ds_comb_arm,
                               blocks.shape, local_starts.shape,
                               tre.shape, np.dtype(dtype).name)
    # Template/starts leading axis is (3*n_f) interleaved foi-major, i.e.
    # channel c = foi*3 + t, so a "hyp" split over axis 0 keeps whole
    # hypotheses together.
    staged = _stage_inputs(mesh, (blocks, local_starts, valid, valid_sp,
                                  sp_off, tre, tim))
    pow_, frq, single, inc, sp_folds = shard_jit(*staged)

    sp_inc = np.roll(_fetch(sp_folds).astype(np.float64) / n_sp_eff, 137)

    return XcorrResult(
        xc_incoherent_collapsed_pow=_fetch(pow_).astype(np.float64),
        xc_incoherent_collapsed_frq=_fetch(frq).astype(np.int64),
        xc_incoherent_single=_fetch(single).astype(np.float64),
        xc_incoherent=_fetch(inc).astype(np.float64),
        sp_incoherent=sp_inc,
        n_comb_xc=int(n_comb_xc),
        n_comb_sp=int(n_sp_eff),
    )


@functools.lru_cache(maxsize=32)
def _shard_program(mesh, n_comb_xc, ds_comb_arm, blocks_shape, starts_shape,
                   tpl_shape, dtype_name):
    """Build (and cache) the jitted shard_map program — rebuilding the
    callable per invocation would miss the jit trace cache and retrace
    on every capture."""
    del blocks_shape, starts_shape, tpl_shape, dtype_name  # cache keys only
    fn = functools.partial(_sharded_scan_fn, n_comb_xc=n_comb_xc,
                           ds_comb_arm=ds_comb_arm)
    shard_fn = jax.shard_map(
        fn, mesh=mesh,
        in_specs=_IN_SPECS,
        out_specs=(P(), P(), P(), P(), P()),
        # Outputs are made equal on every shard by the psum/all_gather
        # combination, which the static replication checker cannot prove.
        check_vma=False,
    )
    return platform.jit(shard_fn)
