"""PHY-layer table & codec tests (36.211/36.212 properties + reference parity)."""

import numpy as np
import pytest

from lte_cell_scanner.models.pn import lte_pn, lte_pn_batch
from lte_cell_scanner.models.pss import pss_fd, pss_td, pss_td_all
from lte_cell_scanner.models.sss import sss_fd
from lte_cell_scanner.models.rs import RSDL
from lte_cell_scanner.models.crc import lte_calc_crc
from lte_cell_scanner.models.convcode import lte_conv_encode, lte_conv_decode
from lte_cell_scanner.models.ratematch import lte_conv_ratematch, lte_conv_deratematch
from lte_cell_scanner.models.modulation import lte_modulate, lte_demodulate
from lte_cell_scanner.utils.dsp import sigpower


def _pn_direct(c_init, length):
    """Literal bit-by-bit Gold generator for cross-checking."""
    x1 = [1] + [0] * 30
    x2 = [(c_init >> t) & 1 for t in range(31)]
    out = []
    for _ in range(1600 + length):
        out.append(x1[0] ^ x2[0])
        x1 = x1[1:] + [x1[0] ^ x1[3]]
        x2 = x2[1:] + [x2[0] ^ x2[1] ^ x2[2] ^ x2[3]]
    return np.array(out[1600:], dtype=np.uint8)


def test_pn_matches_direct():
    for c_init in (0, 1, 12345, (1 << 31) - 1):
        np.testing.assert_array_equal(lte_pn(c_init, 100), _pn_direct(c_init, 100))


def test_pn_batch_consistent():
    inits = np.array([3, 77, 100000], dtype=np.uint64)
    batch = lte_pn_batch(inits, 50)
    for i, ci in enumerate(inits):
        np.testing.assert_array_equal(batch[i], lte_pn(int(ci), 50))


def test_pss_properties():
    for t in range(3):
        fd = pss_fd(t)
        assert fd.shape == (62,)
        np.testing.assert_allclose(np.abs(fd), 1.0, atol=1e-12)
        td = pss_td(t)
        assert td.shape == (137,)
        # CP property: first 9 samples repeat the last 9.
        np.testing.assert_allclose(td[:9], td[128:], atol=1e-12)
        # Unit power on the occupied samples: idft scaling preserves power.
        assert abs(sigpower(td[9:]) - 1.0) < 1e-6
    # The three sequences are distinct.
    assert not np.allclose(pss_fd(0), pss_fd(1))
    # Zadoff-Chu values: check a couple against the closed form.
    n = 5
    assert np.isclose(pss_fd(0)[n], np.exp(-1j * np.pi * 25 * n * (n + 1) / 63))


def test_sss_properties():
    s = sss_fd(0, 0, 0)
    assert s.shape == (62,)
    assert set(np.unique(s)) <= {-1, 1}
    # Different n_id_1 / slot give different sequences.
    assert not np.array_equal(sss_fd(0, 0, 0), sss_fd(1, 0, 0))
    assert not np.array_equal(sss_fd(0, 0, 0), sss_fd(0, 0, 10))
    # All 168*3 sequences in slot 0 are distinct.
    seqs = {tuple(sss_fd(n1, n2, 0)) for n1 in range(168) for n2 in range(3)}
    assert len(seqs) == 168 * 3


def test_rs_dl():
    rs = RSDL(n_id_cell=271, n_rb_dl=6, cp_type="normal")
    r = rs.get_rs(0, 0)
    assert r.shape == (12,)
    np.testing.assert_allclose(np.abs(r), 1.0, atol=1e-12)
    # v-shift: port0 sym0 shift = mod(0 + 271, 6) = 1
    assert rs.get_shift(0, 0, 0) == (0 + 271) % 6
    assert rs.get_shift(0, 4, 0) == (3 + 271) % 6
    assert rs.get_shift(0, 0, 1) == (3 + 271) % 6
    # Ports 2/3 have RS only on symbol 1.
    assert np.isnan(rs.get_shift(0, 0, 2))
    assert rs.get_shift(1, 1, 2) == (3 * 1 + 271) % 6
    # RS differ between slots.
    assert not np.allclose(rs.get_rs(0, 0), rs.get_rs(1, 0))


def test_crc16_known_value():
    # CRC of all zeros is zero.
    np.testing.assert_array_equal(lte_calc_crc(np.zeros(24, dtype=np.uint8), "crc16"),
                                  np.zeros(16, dtype=np.uint8))
    # Linearity: crc(a ^ b) == crc(a) ^ crc(b)
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2, 24).astype(np.uint8)
    b = rng.integers(0, 2, 24).astype(np.uint8)
    np.testing.assert_array_equal(
        lte_calc_crc(a ^ b), lte_calc_crc(a) ^ lte_calc_crc(b))
    # Single leading 1 bit: remainder of x^39 mod g(x).
    one = np.zeros(24, dtype=np.uint8)
    one[-1] = 1  # message = 1 -> CRC = x^16 mod g = low bits of poly
    crc = lte_calc_crc(one, "crc16")
    # x^16 mod (x^16+x^12+x^5+1) = x^12+x^5+1
    expect = np.zeros(16, dtype=np.uint8)
    expect[[3, 10, 15]] = 1  # MSB-first positions of x^12, x^5, x^0
    np.testing.assert_array_equal(crc, expect)


def test_convcode_roundtrip():
    rng = np.random.default_rng(2)
    for n in (40, 64, 120):
        c = rng.integers(0, 2, n).astype(np.uint8)
        d = lte_conv_encode(c)
        assert d.shape == (3, n)
        # Noiseless LLRs: +5 for bit 0, -5 for bit 1.
        llr = 5.0 * (1.0 - 2.0 * d.astype(np.float64))
        decoded = lte_conv_decode(llr)
        np.testing.assert_array_equal(decoded, c)


def test_convcode_tailbiting_state():
    # First output bits must depend on the *last* input bits (tail-biting).
    c = np.zeros(40, dtype=np.uint8)
    d0 = lte_conv_encode(c)
    c2 = c.copy()
    c2[-1] = 1
    d1 = lte_conv_encode(c2)
    assert (d0[:, 0] != d1[:, 0]).any()


def test_convcode_noisy():
    rng = np.random.default_rng(3)
    c = rng.integers(0, 2, 40).astype(np.uint8)
    d = lte_conv_encode(c)
    tx = 1.0 - 2.0 * d.astype(np.float64)
    # 3 dB SNR BPSK
    noisy = tx + rng.standard_normal(tx.shape) * 0.5
    llr = 8.0 * noisy
    np.testing.assert_array_equal(lte_conv_decode(llr), c)


def test_ratematch_roundtrip():
    rng = np.random.default_rng(4)
    n_c, n_e = 40, 480
    d = rng.standard_normal((3, n_c))
    e = lte_conv_ratematch(d, n_e)
    assert e.shape == (n_e,)
    back = lte_conv_deratematch(e, n_c)
    np.testing.assert_allclose(back, d, atol=1e-12)


def test_ratematch_counts():
    # 480 rate-matched bits from 120 coded bits: every bit appears exactly 4x.
    e = lte_conv_ratematch(np.arange(120, dtype=np.float64).reshape(3, 40), 480)
    vals, counts = np.unique(e, return_counts=True)
    assert len(vals) == 120
    assert (counts == 4).all()


def test_modulation_roundtrip():
    rng = np.random.default_rng(5)
    for mod in ("qpsk", "qam16", "qam64"):
        from lte_cell_scanner.models.modulation import bits_per_symbol
        bits = rng.integers(0, 2, 8 * 6).astype(np.uint8)
        syms = lte_modulate(bits, mod)
        assert abs(sigpower(syms)) < 2.0  # unit average over full constellation
        llr = lte_demodulate(syms, 1e-2, mod)
        hard = (llr < 0).astype(np.uint8)
        np.testing.assert_array_equal(hard, bits)


def test_qpsk_llr_formula():
    syms = np.array([0.3 + 0.2j, -0.1 - 0.4j])
    llr = lte_demodulate(syms, 0.5, "qpsk")
    np.testing.assert_allclose(llr[0], 2 * np.sqrt(2) * 0.3 / 0.5)
    np.testing.assert_allclose(llr[3], 2 * np.sqrt(2) * -0.4 / 0.5)


def test_mib_chain_end_to_end():
    """PBCH codec chain: encode -> ratematch -> QPSK -> AWGN -> decode.

    Mirrors Matlab/mib_test.m.
    """
    rng = np.random.default_rng(6)
    mib = rng.integers(0, 2, 24).astype(np.uint8)
    crc = lte_calc_crc(mib, "crc16")
    c = np.concatenate([mib, crc])
    d = lte_conv_encode(c)
    e = lte_conv_ratematch(d.astype(np.float64), 1920)
    syms = lte_modulate(e.astype(np.uint8), "qpsk")
    noisy = syms + (rng.standard_normal(len(syms)) + 1j * rng.standard_normal(len(syms))) * np.sqrt(0.05)
    llr = lte_demodulate(noisy, 0.1, "qpsk")
    d_est = lte_conv_deratematch(llr, 40)
    c_est = lte_conv_decode(d_est)
    np.testing.assert_array_equal(c_est, c)
    np.testing.assert_array_equal(lte_calc_crc(c_est[:24], "crc16"), c_est[24:])


def test_device_viterbi_matches_host():
    from lte_cell_scanner.models.convcode import (lte_conv_decode,
                                                  lte_conv_encode)
    from lte_cell_scanner.models.convcode_jax import lte_conv_decode_batch

    rng = np.random.default_rng(11)
    B, n = 12, 40
    bits = rng.integers(0, 2, (B, n)).astype(np.uint8)
    llrs = []
    for b in range(B):
        d = lte_conv_encode(bits[b]).astype(np.float64)
        y = (1.0 - 2.0 * d) + rng.standard_normal(d.shape)  # 0 dB AWGN
        llrs.append(2 * y)
    llrs = np.stack(llrs)
    dev = np.asarray(lte_conv_decode_batch(llrs))
    for b in range(B):
        np.testing.assert_array_equal(dev[b], lte_conv_decode(llrs[b]))


def test_matlab_compat_helpers():
    from lte_cell_scanner.utils.dsp import and_reduce, diff, flatten, last

    np.testing.assert_array_equal(diff([1, 4, 9]), [3, 5])
    assert and_reduce([True, True]) and not and_reduce([True, False])
    assert last([1, 2, 7]) == 7
    np.testing.assert_array_equal(
        flatten([[np.arange(2), np.arange(2) + 2]]), np.arange(4))


@pytest.mark.parametrize("batch", [1, 150])
def test_device_viterbi_batch_padding(batch):
    """Host batches are zero-padded to a power of two (>= 128 rows) so
    the tracker's varying batch sizes share a few compiled programs;
    the padding must not leak into the decodes, and NumPy in gives
    NumPy out of the original length."""
    from lte_cell_scanner.models.convcode import (lte_conv_decode,
                                                  lte_conv_encode)
    from lte_cell_scanner.models.convcode_jax import lte_conv_decode_batch

    rng = np.random.default_rng(17)
    bits = rng.integers(0, 2, (batch, 40)).astype(np.uint8)
    llrs = np.stack([2 * ((1.0 - 2.0 * lte_conv_encode(b).astype(
        np.float64)) + rng.standard_normal((3, 40))) for b in bits])
    llrs = llrs.astype(np.float32)
    dev = lte_conv_decode_batch(llrs)
    assert isinstance(dev, np.ndarray) and dev.shape == (batch, 40)
    for b in range(batch):
        np.testing.assert_array_equal(dev[b], lte_conv_decode(llrs[b]))
