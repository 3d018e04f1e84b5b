"""Framed codec tests: explicit header + whitening + FEC + interleave + Gray.

The reference ships all the machinery (LoRaCodes.hpp) but never wires it into
a codec (its encode() is Hamming-only, LoRaEncoder.cpp:6-18); these tests
exercise the frame layer built on top of the golden-verified toolbox pieces.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lora_sdr_lightweight_standalone_library_clean.models import frame
from lora_sdr_lightweight_standalone_library_clean.models.modem import (
    modulate)
from lora_sdr_lightweight_standalone_library_clean.ops import codes
from lora_sdr_lightweight_standalone_library_clean.utils.config import (
    LoraParams)
from lora_sdr_lightweight_standalone_library_clean.utils.errors import (
    InvalidArgumentError)


def rng_bytes(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


CR_BY_RDD = {1: "4/5", 2: "4/6", 3: "4/7", 4: "4/8"}


@pytest.mark.slow
@pytest.mark.parametrize("sf", [7, 8, 9, 10, 11, 12])
@pytest.mark.parametrize("rdd", [1, 2, 3, 4])
def test_roundtrip_all_sf_cr(sf, rdd):
    params = LoraParams(sf=sf, cr=CR_BY_RDD[rdd])
    for length in (1, 5, 16):
        payload = rng_bytes(length, seed=sf * 16 + rdd)
        sym = frame.encode_frame(payload, params)
        assert sym.shape[-1] == frame.frame_symbols(params, length)
        res = frame.decode_frame(np.asarray(sym), params)
        assert bool(res.hdr_ok) and bool(res.crc_ok)
        assert int(res.length) == length
        np.testing.assert_array_equal(np.asarray(res.payload), payload)
        assert int(res.n_err) == 0


@pytest.mark.parametrize("crc", [True, False])
def test_roundtrip_no_crc_and_header_fields(crc):
    params = LoraParams(sf=9, cr="4/7")
    payload = rng_bytes(11, seed=3)
    sym = frame.encode_frame(payload, params, crc=crc)
    hdr = frame.decode_header(np.asarray(sym)[:8], params)
    assert bool(hdr.hdr_ok)
    assert int(hdr.length) == 11
    assert int(hdr.rdd) == 3
    assert bool(hdr.crc_en) == crc
    res = frame.decode_frame(np.asarray(sym), params)
    np.testing.assert_array_equal(np.asarray(res.payload), payload)
    assert bool(res.crc_ok) == (True if crc else bool(res.hdr_ok))


def test_gray_plus_hamming_corrects_one_bin_error():
    """+-1 detection error = 1 gray bit flip; CR4/8 corrects it."""
    params = LoraParams(sf=8, cr="4/8")
    payload = rng_bytes(8, seed=7)
    sym = np.asarray(frame.encode_frame(payload, params)).astype(np.int64)
    n = params.n
    corrupted = sym.copy()
    corrupted[9] = (corrupted[9] + 1) % n          # one payload symbol off
    res = frame.decode_frame(corrupted, params)
    assert bool(res.crc_ok)
    np.testing.assert_array_equal(np.asarray(res.payload), payload)
    assert int(res.n_err) >= 1


def test_header_bin_error_tolerated():
    """Header rides the << 2 reduced grid: +-1 bins never corrupt it."""
    params = LoraParams(sf=7, cr="4/5")
    payload = rng_bytes(6, seed=9)
    sym = np.asarray(frame.encode_frame(payload, params)).astype(np.int64)
    for delta in (-1, 1):
        corrupted = sym.copy()
        corrupted[:8] = (corrupted[:8] + delta) % params.n
        res = frame.decode_frame(corrupted, params)
        assert bool(res.hdr_ok) and bool(res.crc_ok)
        np.testing.assert_array_equal(np.asarray(res.payload), payload)


def test_corrupted_header_detected():
    params = LoraParams(sf=7, cr="4/5")
    sym = np.asarray(frame.encode_frame(rng_bytes(6), params)).astype(int)
    corrupted = sym.copy()
    corrupted[:8] = (corrupted[:8] + params.n // 2) % params.n
    hdr = frame.decode_header(corrupted[:8], params)
    assert not bool(hdr.hdr_ok)
    res = frame.decode_frame(corrupted, params)
    assert not bool(res.crc_ok)


def test_payload_corruption_fails_crc():
    params = LoraParams(sf=7, cr="4/5")  # parity 5/4: detect-only
    payload = rng_bytes(10, seed=11)
    sym = np.asarray(frame.encode_frame(payload, params)).astype(int)
    corrupted = sym.copy()
    corrupted[10] ^= 0x3                            # 2 gray bits
    res = frame.decode_frame(corrupted, params)
    assert bool(res.hdr_ok)
    assert not bool(res.crc_ok)


def test_padded_decoder_batched_variable_lengths():
    """One compiled program decodes a batch of different true lengths."""
    params = LoraParams(sf=7, cr="4/8")
    max_len = 24
    s_max = frame.max_frame_symbols(params, max_len)
    lengths = [3, 10, 24]
    batch = np.zeros((len(lengths), s_max), np.uint16)
    payloads = []
    for i, ln in enumerate(lengths):
        p = rng_bytes(ln, seed=20 + i)
        payloads.append(p)
        s = np.asarray(frame.encode_frame(p, params))
        batch[i, :s.shape[-1]] = s
    dec = jax.jit(lambda s: frame.decode_frame_padded(s, params, max_len))
    res = dec(jnp.asarray(batch))
    assert res.payload.shape == (len(lengths), max_len)
    for i, ln in enumerate(lengths):
        assert bool(res.hdr_ok[i]) and bool(res.crc_ok[i])
        assert int(res.length[i]) == ln
        np.testing.assert_array_equal(
            np.asarray(res.payload[i, :ln]), payloads[i])
        assert np.all(np.asarray(res.payload[i, ln:]) == 0)


def test_padded_decoder_rejects_oversize_and_wrong_rate():
    params = LoraParams(sf=7, cr="4/5")
    max_len = 8
    # advertised length beyond the static bound -> hdr_ok False, not a crash
    big = np.asarray(frame.encode_frame(rng_bytes(16, seed=1), params))
    s_max = frame.max_frame_symbols(params, max_len)
    padded = np.zeros(max(s_max, big.shape[-1]), np.uint16)
    padded[:big.shape[-1]] = big
    res = frame.decode_frame_padded(padded[:s_max], params, max_len)
    assert not bool(res.hdr_ok) and not bool(res.crc_ok)

    # frame encoded at a different rate -> hdr_ok False under this profile
    other = LoraParams(sf=7, cr="4/8")
    sym8 = np.asarray(frame.encode_frame(rng_bytes(4, seed=2), other))
    pad8 = np.zeros(s_max, np.uint16)
    pad8[:min(s_max, sym8.shape[-1])] = sym8[:s_max]
    res8 = frame.decode_frame_padded(pad8, params, max_len)
    assert not bool(res8.hdr_ok)


def test_end_to_end_over_the_air():
    """encode_frame -> modulate -> dechirp -> demod -> decode_frame, the
    decodable chain (tests/e2e_chain_test.cpp:62-114 semantics)."""
    from lora_sdr_lightweight_standalone_library_clean.models.modem \
        import dechirp
    from lora_sdr_lightweight_standalone_library_clean.models.tones \
        import demodulate_tones
    params = LoraParams(sf=8, cr="4/6")
    payload = rng_bytes(14, seed=5)
    sym = frame.encode_frame(payload, params)
    re, im = modulate(sym, params)
    res = demodulate_tones(*dechirp(re, im, params), params)
    out = frame.decode_frame(np.asarray(res.symbols), params)
    assert bool(out.crc_ok)
    np.testing.assert_array_equal(np.asarray(out.payload), payload)


def test_sf_below_seven_rejected():
    with pytest.raises(InvalidArgumentError):
        frame.encode_frame(rng_bytes(4), LoraParams(sf=6))


def test_crc_dynamic_matches_static():
    from lora_sdr_lightweight_standalone_library_clean.models.modem \
        import crc_sx1272
    data = rng_bytes(32, seed=13)
    for ln in (0, 1, 7, 32):
        got = int(frame.crc_sx1272_at(data, jnp.asarray(ln)))
        want = int(np.asarray(crc_sx1272(data[:ln]))) if ln else \
            int(codes.sx1272_data_checksum(data[:0]))
        assert got == want, ln


def test_whitening_actually_applied():
    """Encoded body symbols differ from an unwhitened reconstruction —
    guards against the involution hiding a no-op."""
    params = LoraParams(sf=7, cr="4/8")
    payload = np.zeros(8, np.uint8)                # all-zero exposes the key
    sym = np.asarray(frame.encode_frame(payload, params))
    body = sym[8:]
    assert np.count_nonzero(body) > body.size // 2


def test_frame_wire_format_golden():
    """The on-air frame format is a wire contract: fixed payload 01..08
    must produce these exact symbol sequences (any change to header
    layout, whitening keys, interleaving, Gray direction or FEC order
    breaks interop with previously recorded captures)."""
    payload = np.arange(1, 9, dtype=np.uint8)
    want_sf7_cr48 = [28, 60, 0, 64, 56, 108, 56, 124, 14, 125, 74, 85, 13,
                     20, 66, 113, 113, 92, 0, 108, 67, 126, 93, 23, 105,
                     52, 35, 117, 120, 58, 82, 79]
    got = np.asarray(frame.encode_frame(payload,
                                        LoraParams(sf=7, cr="4/8")))
    np.testing.assert_array_equal(got, want_sf7_cr48)

    want_sf9_cr45 = [224, 140, 64, 220, 12, 72, 480, 236, 451, 415, 258,
                     357, 272, 183, 93, 28, 424, 110]
    got9 = np.asarray(frame.encode_frame(payload,
                                         LoraParams(sf=9, cr="4/5")))
    np.testing.assert_array_equal(got9, want_sf9_cr45)
