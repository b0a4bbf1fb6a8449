"""Batched tail-biting Viterbi decoder on device.

The search pipeline decodes one 40-bit MIB per candidate — host NumPy is
fine there. The *tracker* decodes one MIB per tracked cell per 40 ms; at
hundreds of tracked cells per chip the decoder becomes the host
bottleneck (SURVEY §7 anticipated exactly this: "tail-biting Viterbi on
device ... for throughput"). This module runs the same 64-state trellis as
models/convcode.py (reference: src/lte_lib.cpp:520-551 via IT++
decode_tailbite) as a `lax.scan` forward pass + traceback, vectorized over
a batch axis, carrying the (start_state, current_state) joint metric so
all 64 tail-biting hypotheses resolve in one pass.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from lte_cell_scanner import platform
from lte_cell_scanner.models.convcode import N_STATES, trellis


@functools.lru_cache(maxsize=1)
def _tables():
    next_state, outputs, _ = trellis()
    signs = (1.0 - 2.0 * outputs.astype(np.float32))      # (64, 2, 3)
    ns_all = np.arange(N_STATES)
    pred0 = (2 * (ns_all & 31)).astype(np.int32)          # (64,)
    in_bit = (ns_all >> 5).astype(np.int32)               # (64,)
    return signs, pred0, in_bit


_K = 4          # trellis steps fused per joint-pass scan iteration


@functools.lru_cache(maxsize=4)
def _chain_tables(k: int):
    """k-step trellis chains, laid out GATHER-FREE (both structures
    below are pure arithmetic):

    - the predecessor k steps back of state s along chain j is
      ``((s << k) & 63) | j`` (the shift register drops s's top k bits
      and exposes the chain's k input bits as its low bits), so the
      (64, 2^k) metric lookup is a reshape + tile, no index table;
    - the k branch metrics' sum is LINEAR in the k*3 LLRs, so it ships
      as one (k*3, 64*2^k) matrix A: add = llr_flat @ A, one matmul
      (at platform.MATMUL_PRECISION: the sums must equal the host
      decoder's float32 branch metrics, so no TF32).

    Also returns BITS (64, 2^k, k): the decoded input bits of chain j
    ending at s, in forward time order (for the fused traceback).

    Fusing k steps cuts the joint pass's dominant (B, 64, 64) metric
    HBM traffic and the replay/traceback scans' fixed per-step latency
    k-fold; the 2^k-way max fuses into the same pass."""
    signs, pred0, in_bit = _tables()
    signs_flat = signs.reshape(2 * N_STATES, 3)           # (128, 3)
    A = np.zeros((k * 3, N_STATES * 2 ** k), np.float32)
    BITS = np.zeros((N_STATES, 2 ** k, k), np.int32)
    for s in range(N_STATES):
        for j in range(2 ** k):
            cur = s
            for i in range(k):              # walk back from the newest
                # chain j's input bits are the predecessor's low bits:
                # the bit consumed at walk-back step i is j's (k-1-i)-th.
                p = pred0[cur] + ((j >> (k - 1 - i)) & 1)
                step = k - 1 - i            # forward time within chunk
                A[step * 3:(step + 1) * 3, s * 2 ** k + j] += \
                    signs_flat[p * 2 + in_bit[cur]]
                BITS[s, j, step] = in_bit[cur]
                cur = p
            assert cur == ((s << k) & (N_STATES - 1)) | j
    return A, BITS


def _decode_one(d_llr, onehot_tb=True):
    """(3, n) LLR ln(P0/P1) -> (n,) bits. Jittable; vmapped by the batch
    wrapper.

    Two passes: the joint (start_state, current_state) metric pass finds
    the ML tail-biting start WITHOUT storing backpointers (the joint
    trellis's (n, 64, 64) backpointer stack is ~0.5 GB of HBM traffic at
    the MIB batch sizes — it dominated the whole decode program), then a
    single-start replay with the identical tie-breaking (m1 > m0)
    reproduces the same survivor path with an (n, 64) stack.

    Tie semantics: the fused K-step path below breaks EXACT metric ties by argmax over the 2^K
    chain index — lexicographically earliest chain — which is not the
    host decoder's per-step `m1 > m0` greedy rule (convcode.py). Both
    resolve to *an* ML path; decodes match the host path bit-for-bit
    for tie-free LLRs (generic floats — every real/bench input), and
    the MIB CRC guards production against the degenerate all-tied case
    (e.g. zeroed LLRs), where the decoded bits may legitimately differ.

    ``onehot_tb`` exists so tools/bench_viterbi.py can time the two
    tracebacks back-to-back in one process: one-hot contractions (exact
    0/1-weight f32 products, the default) or the batched
    j_t[state]/BITS[s, j] gathers."""
    signs_np, pred0_np, in_bit_np = _tables()
    signs = jnp.asarray(signs_np)
    pred0 = jnp.asarray(pred0_np)
    pred1 = pred0 + 1
    in_bit = jnp.asarray(in_bit_np)
    llrs = jnp.moveaxis(d_llr, 1, 0)

    init = jnp.full((N_STATES, N_STATES), -jnp.inf,
                    dtype=jnp.float32).at[
        jnp.arange(N_STATES), jnp.arange(N_STATES)].set(0.0)

    n = llrs.shape[0]
    if n % _K == 0:
        # Fused k-step passes (see _chain_tables): the joint pass's
        # (64, 64) metric traffic AND the replay/traceback scans' fixed
        # per-step latency both drop k-fold — with NO gathers: the
        # metric lookup is a reshape + tile and the branch-metric sums
        # are one (k*3) @ (k*3, 64*2^k) matmul.
        A_np, BITS_np = _chain_tables(_K)
        A, BITS = jnp.asarray(A_np), jnp.asarray(BITS_np)
        llrs_k = llrs.reshape(-1, _K * llrs.shape[1])
        JK = 2 ** _K
        G = N_STATES // JK           # metric column groups (s % G picks)
        rep = N_STATES // G

        def adds3(llr_flat):
            """(rep, G, JK) branch-metric sums: row s = r*G + g of the
            (64, 2^K) table (state s's 2^K predecessors are column group
            g = s % G of the metric, ((s << K) & 63) | j)."""
            return (llr_flat @ A).reshape(rep, G, JK)

        # All expansion by BROADCAST (a tile/gather would materialize —
        # or worse, scalar-loop — the (.., 64, 2^K) candidate tensor;
        # broadcast + max fuses into one pass). Per-step argmax stacks
        # stay out of the joint pass (the argmax defeats the fused max
        # reduction), so the ML path is recovered by the cheap
        # (64,)-metric single-start replay.
        def fwd(metric, llr_flat):
            cand = metric.reshape(N_STATES, 1, G, JK) + adds3(llr_flat)
            return jnp.max(cand, axis=-1).reshape(N_STATES, N_STATES), \
                None

        metric, _ = jax.lax.scan(fwd, init, llrs_k)
        start = jnp.argmax(jnp.diagonal(metric)).astype(jnp.int32)

        init1 = jnp.full((N_STATES,), -jnp.inf, dtype=jnp.float32).at[
            start].set(0.0)

        def fwd1(m, llr_flat):
            cand = m.reshape(1, G, JK) + adds3(llr_flat)  # (rep, G, JK)
            j = jnp.argmax(cand, axis=-1).astype(jnp.int32)
            return (jnp.max(cand, axis=-1).reshape(N_STATES),
                    j.reshape(N_STATES))

        _, bps = jax.lax.scan(fwd1, init1, llrs_k)        # (n/K, 64)

        if onehot_tb:
            BITS_f = jnp.asarray(BITS_np.astype(np.float32))

            def back(state, j_t):
                # One-hot contractions instead of j_t[state]/BITS[s, j]
                # gathers under the batch vmap; exact at any matmul
                # precision (0/1 weights on small integers).
                oh_s = (jnp.arange(N_STATES) == state).astype(
                    jnp.float32)                            # (64,)
                j = (oh_s @ j_t.astype(jnp.float32)).astype(jnp.int32)
                oh_j = (jnp.arange(JK) == j).astype(jnp.float32)
                bk = jnp.einsum("s,j,sjk->k", oh_s, oh_j, BITS_f)
                prev = ((state << _K) & (N_STATES - 1)) | j
                return prev, bk.astype(jnp.int32)           # (K,) fwd

        else:
            def back(state, j_t):
                j = j_t[state]
                prev = ((state << _K) & (N_STATES - 1)) | j
                return prev, BITS[state, j]                 # (K,) fwd

        _, bits = jax.lax.scan(back, start, bps, reverse=True)
        return bits.reshape(-1).astype(jnp.int32)

    # pragma: no cover - lengths not divisible by the fused step
    def fwd(metric, llr_t):
        bm = signs @ llr_t                                # (64, 2)
        m0 = metric[:, pred0] + bm[pred0, in_bit]
        m1 = metric[:, pred1] + bm[pred1, in_bit]
        return jnp.where(m1 > m0, m1, m0), None

    metric, _ = jax.lax.scan(fwd, init, llrs)
    start = jnp.argmax(jnp.diagonal(metric)).astype(jnp.int32)

    init1 = jnp.full((N_STATES,), -jnp.inf, dtype=jnp.float32).at[
        start].set(0.0)

    def fwd1(m, llr_t):
        bm = signs @ llr_t
        m0 = m[pred0] + bm[pred0, in_bit]
        m1 = m[pred1] + bm[pred1, in_bit]
        take1 = m1 > m0
        return (jnp.where(take1, m1, m0),
                jnp.where(take1, pred1, pred0).astype(jnp.int32))

    _, bps = jax.lax.scan(fwd1, init1, llrs)

    def back(state, bp_t):
        bit = state >> 5
        return bp_t[state], bit

    _, bits = jax.lax.scan(back, start, bps, reverse=True)
    return bits.astype(jnp.int32)


@platform.jit
def _decode_batch_xla(d_llr: jnp.ndarray) -> jnp.ndarray:
    return jax.vmap(_decode_one)(d_llr.astype(jnp.float32))


def lte_conv_decode_batch(d_llr):
    """Decode a batch: (B, 3, n) LLRs -> (B, n) bits (a NumPy array for
    NumPy input, a jnp array for traced/device input). Decodes are
    bit-identical to the host decoder for tie-free LLRs (see
    _decode_one). Host input (the tracker's per-cycle batches, whose
    size varies cycle to cycle) is zero-padded to a power-of-two batch
    of at least 128 rows, so a run compiles a handful of programs, not
    one per batch size."""
    if isinstance(d_llr, np.ndarray):
        B = d_llr.shape[0]
        Bp = max(128, 1 << max(B - 1, 0).bit_length())
        x = np.zeros((Bp,) + d_llr.shape[1:], np.float32)
        x[:B] = d_llr
        return np.asarray(_decode_batch_xla(x))[:B]
    return _decode_batch_xla(d_llr)
