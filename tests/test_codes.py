"""Coding toolbox unit tests: FEC, whitening, CRC, Gray, interleaver.

Mirrors the reference's unit coverage (whitening_test.cpp, roundtrip_test.cpp,
odd_symbol_count_test.cpp) plus exhaustive LUT and property checks.
"""
import base64

import numpy as np
import pytest

from lora_sdr_lightweight_standalone_library_clean.ops import codes
import oracle


# ---------------------------------------------------------------------------
# Hamming / parity FEC
# ---------------------------------------------------------------------------

def test_hamming84_known_values():
    # encode(0xD) = 0x8D etc.; derived from the parity equations
    assert codes.encode_hamming84(np.uint8(0x0)) == 0x00
    assert codes.encode_hamming84(np.uint8(0x1)) == 0xD1
    assert codes.encode_hamming84(np.uint8(0x2)) == 0x72
    assert codes.encode_hamming84(np.uint8(0xD)) == 0x8D
    assert codes.encode_hamming84(np.uint8(0xF)) == 0xFF


def test_hamming84_roundtrip_all():
    nib = np.arange(16, dtype=np.uint8)
    enc = codes.encode_hamming84(nib)
    dec, err, bad = codes.decode_hamming84(enc, return_flags=True)
    np.testing.assert_array_equal(dec, nib)
    assert not err.any()
    assert not bad.any()


def test_hamming84_single_bit_correction():
    for nib in range(16):
        cw = int(codes.encode_hamming84(np.uint8(nib)))
        for bit in range(8):
            corrupted = np.uint8(cw ^ (1 << bit))
            dec, err, bad = codes.decode_hamming84(corrupted,
                                                   return_flags=True)
            assert int(dec) == nib, (nib, bit)
            assert bool(err)
            assert not bool(bad)


def test_hamming84_double_bit_flags_bad():
    cw = int(codes.encode_hamming84(np.uint8(0x5)))
    n_bad = 0
    for b1 in range(8):
        for b2 in range(b1 + 1, 8):
            _, err, bad = codes.decode_hamming84(
                np.uint8(cw ^ (1 << b1) ^ (1 << b2)), return_flags=True)
            assert bool(err)
            n_bad += bool(bad)
    assert n_bad > 0  # double errors are detected as uncorrectable


def test_hamming74_roundtrip_and_correction():
    nib = np.arange(16, dtype=np.uint8)
    enc = codes.encode_hamming74(nib)
    dec, err = codes.decode_hamming74(enc, return_flags=True)
    np.testing.assert_array_equal(dec, nib)
    assert not err.any()
    for n in range(16):
        cw = int(codes.encode_hamming74(np.uint8(n)))
        for bit in range(7):
            dec, err = codes.decode_hamming74(np.uint8(cw ^ (1 << bit)),
                                              return_flags=True)
            assert int(dec) == n


def test_parity_codes_roundtrip_and_detect():
    nib = np.arange(16, dtype=np.uint8)
    for enc_fn, chk_fn, width in [
        (codes.encode_parity54, codes.check_parity54, 5),
        (codes.encode_parity64, codes.check_parity64, 6),
    ]:
        cw = enc_fn(nib)
        dec, err = chk_fn(cw, return_flags=True)
        np.testing.assert_array_equal(dec, nib)
        assert not err.any()
        # single-bit flip is detected
        for n in range(16):
            c = int(enc_fn(np.uint8(n)))
            for bit in range(width):
                _, err = chk_fn(np.uint8(c ^ (1 << bit)), return_flags=True)
                assert bool(np.all(err)), (width, n, bit)


# ---------------------------------------------------------------------------
# Gray code
# ---------------------------------------------------------------------------

def test_gray_roundtrip_16bit_sample():
    vals = np.concatenate([np.arange(0, 4096, dtype=np.uint16),
                           np.array([0xFFFF, 0x8000, 0x1234], np.uint16)])
    g = codes.binary_to_gray16(vals)
    np.testing.assert_array_equal(codes.gray_to_binary16(g), vals)
    # adjacent values differ by exactly one bit
    diff = g[1:4096] ^ g[:4095]
    popcount = np.array([bin(int(x)).count("1") for x in diff])
    assert (popcount == 1).all()


# ---------------------------------------------------------------------------
# Whitening
# ---------------------------------------------------------------------------

def test_whitening_lfsr_golden_and_involution():
    # Golden pair from the reference unit test (tests/whitening_test.cpp:30-31)
    plain = np.frombuffer(base64.b64decode("3q2+73AN"), np.uint8)
    expect = np.frombuffer(base64.b64decode("IVKQECzy"), np.uint8)
    w = codes.whiten_sx1272_lfsr(plain, 0, 4)
    np.testing.assert_array_equal(w, expect)
    np.testing.assert_array_equal(codes.whiten_sx1272_lfsr(w, 0, 4), plain)


def test_whitening_lfsr_bitofs_and_rdd_modes():
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, 64).astype(np.uint8)
    for rdd in (1, 2, 3, 4):
        for ofs in (0, 1, 7):
            w = codes.whiten_sx1272_lfsr(data, ofs, rdd)
            np.testing.assert_array_equal(
                codes.whiten_sx1272_lfsr(w, ofs, rdd), data)


def test_whitening_sx1232_involution():
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, 300).astype(np.uint8)
    w = codes.whiten_sx1232(data)
    assert not np.array_equal(w, data)
    np.testing.assert_array_equal(codes.whiten_sx1232(w), data)


def test_whitening_seq_involution():
    rng = np.random.default_rng(2)
    data = rng.integers(0, 256, 100).astype(np.uint8)
    for rdd in (1, 4):
        w = codes.whiten_sx1272(data, 0, rdd)
        np.testing.assert_array_equal(codes.whiten_sx1272(w, 0, rdd), data)


# ---------------------------------------------------------------------------
# CRC
# ---------------------------------------------------------------------------

# Known answers produced by the reference's sx1272DataChecksum itself
# (compiled from include/lora_phy/LoRaCodes.hpp:92-105 and executed).
CRC_KNOWN = [
    (b"Hello", 0x4377),
    (b"World", 0x301A),
    (bytes(range(1, 9)), 0xC90F),
    (bytes(8), 0x170B),
    (b"\xff" * 8, 0x7F2B),
]


@pytest.mark.parametrize("payload,crc", CRC_KNOWN)
def test_crc_known_answers(payload, crc):
    assert codes.sx1272_data_checksum(np.frombuffer(payload, np.uint8)) == crc


def test_crc_whitening_chain():
    # de-whitened buffer's trailing CRC verifies (whitening_test.cpp:37-49)
    plain = np.frombuffer(base64.b64decode("3q2+73AN"), np.uint8)
    crc = codes.sx1272_data_checksum(plain[:-2])
    assert crc == (int(plain[-2]) | (int(plain[-1]) << 8))


def test_crc_table_step_equivalence():
    for res in (0x0000, 0x1234, 0xFFFF, 0x8001):
        direct = codes.crc16sx(res)
        table = ((res << 8) & 0xFFFF) ^ int(codes.crc16_table()[res >> 8])
        assert direct == table


def test_checksum8():
    assert codes.checksum8(np.zeros(4, np.uint8)) == 0
    # reference-executed known answer
    assert codes.checksum8(np.array([1, 2, 3], np.uint8)) == 0x44
    a = codes.checksum8(np.array([1, 2, 3], np.uint8))
    b = codes.checksum8(np.array([1, 2, 4], np.uint8))
    assert a != b


def test_header_checksum_matrix():
    # exercise every input bit; compare against the scalar parity equations
    def scalar(h0, h1):
        a = [(h0 >> (4 + i)) & 1 for i in range(4)]
        b = [(h0 >> i) & 1 for i in range(4)]
        c = [(h1 >> i) & 1 for i in range(4)]
        res = (a[0] ^ a[1] ^ a[2] ^ a[3]) << 4
        res |= (a[3] ^ b[1] ^ b[2] ^ b[3] ^ c[0]) << 3
        res |= (a[2] ^ b[0] ^ b[3] ^ c[1] ^ c[3]) << 2
        res |= (a[1] ^ b[0] ^ b[2] ^ c[0] ^ c[1] ^ c[2]) << 1
        res |= a[0] ^ b[1] ^ c[0] ^ c[1] ^ c[2] ^ c[3]
        return res

    rng = np.random.default_rng(3)
    for _ in range(64):
        h0, h1 = int(rng.integers(256)), int(rng.integers(16))
        assert codes.header_checksum([h0, h1]) == scalar(h0, h1)
    # reference-executed known answer: headerChecksum({0x12, 0x34}) == 0x1B
    assert codes.header_checksum([0x12, 0x34]) == 0x1B


# ---------------------------------------------------------------------------
# Diagonal interleaver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ppm", [7, 8, 9, 10, 11, 12])
@pytest.mark.parametrize("rdd", [1, 2, 3, 4])
def test_interleaver_inverse_and_oracle(ppm, rdd):
    rng = np.random.default_rng(ppm * 10 + rdd)
    cw = rng.integers(0, 1 << (4 + rdd), 3 * ppm).astype(np.uint8)
    sym = codes.diagonal_interleave(cw, ppm, rdd)
    np.testing.assert_array_equal(sym, oracle.interleave_seq(cw, ppm, rdd))
    back = codes.diagonal_deinterleave(sym, ppm, rdd)
    np.testing.assert_array_equal(back, cw)
    np.testing.assert_array_equal(
        oracle.deinterleave_seq(sym, ppm, rdd), cw)


def test_interleaver_batched():
    rng = np.random.default_rng(9)
    cw = rng.integers(0, 256, (4, 2 * 7)).astype(np.uint8)
    sym = codes.diagonal_interleave(cw, 7, 4)
    assert sym.shape == (4, 16)
    for i in range(4):
        np.testing.assert_array_equal(
            sym[i], codes.diagonal_interleave(cw[i], 7, 4))
