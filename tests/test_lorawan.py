"""LoRaWAN MAC tests: MIC known answer, frame roundtrip, error paths.

Mirrors lorawan_mic_test.cpp, lorawan_roundtrip.cpp and the MAC error cases
of error_code_test.cpp.
"""
import numpy as np
import pytest

from lora_sdr_lightweight_standalone_library_clean.models import lorawan
from lora_sdr_lightweight_standalone_library_clean.models.lorawan import (
    Frame, MType, compute_mic, build_frame, parse_frame,
    aes128_encrypt_block, _aes_encrypt_py, _cmac_py)
from lora_sdr_lightweight_standalone_library_clean.utils.errors import (
    RangeError, MicMismatchError)


def test_aes_fips197_known_answer():
    key = bytes(range(16))
    pt = bytes.fromhex("00112233445566778899aabbccddeeff")
    expect = bytes.fromhex("69c4e0d86a7b0430d8cdb78070b4c55a")
    assert aes128_encrypt_block(key, pt) == expect
    assert _aes_encrypt_py(key, pt) == expect  # pure-python fallback too


def test_cmac_rfc4493_known_answers():
    key = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
    # Example 1: empty message
    assert _cmac_py(key, b"") == bytes.fromhex(
        "bb1d6929e95937287fa37d129b756746")
    # Example 2: one full block
    assert _cmac_py(key, bytes.fromhex(
        "6bc1bee22e409f96e93d7e117393172a")) == bytes.fromhex(
        "070a16b46b4d4144f79bdd9dd04a287c")
    # Example 3: 40 bytes (partial last block)
    msg = bytes.fromhex(
        "6bc1bee22e409f96e93d7e117393172aae2d8a571e03ac9c9eb76fac45af8e51"
        "30c81c46a35ce411")
    assert _cmac_py(key, msg) == bytes.fromhex(
        "dfa66747de9ae63030ca32611497c827")


def test_mic_reference_known_answer():
    """compute_mic == 0x82B5C3D6 (lorawan_mic_test.cpp:10-12)."""
    key = bytes([2] * 16)
    msg = bytes([0x40, 0x04, 0x03, 0x02, 0x01, 0x80, 0x01, 0x00, 0x01,
                 0xA6, 0x94, 0x64, 0x26, 0x15])
    assert compute_mic(key, True, 0x01020304, 1, msg) == 0x82B5C3D6


def test_frame_roundtrip():
    """build_frame -> parse_frame (lorawan_roundtrip.cpp:29-72)."""
    key = bytes(range(16))
    rng = np.random.default_rng(7)
    for _ in range(5):
        frame = Frame()
        frame.mhdr.mtype = MType.UNCONFIRMED_DATA_UP
        frame.fhdr.devaddr = 0x01020304
        frame.fhdr.fcnt = int(rng.integers(0, 65536))
        frame.fhdr.fopts = bytes(rng.integers(0, 256, 3).astype(np.uint8))
        frame.payload = bytes(rng.integers(0, 256, 8).astype(np.uint8))
        syms = build_frame(key, frame)
        out = parse_frame(key, np.asarray(syms))
        assert out.payload == frame.payload
        assert out.fhdr.devaddr == frame.fhdr.devaddr
        assert out.fhdr.fcnt == frame.fhdr.fcnt
        assert out.fhdr.fopts == frame.fhdr.fopts
        assert out.mhdr.mtype == frame.mhdr.mtype


def test_single_bit_symbol_flip_is_corrected():
    """A single-bit symbol flip is repaired by Hamming(8,4) so the MIC still
    verifies.  (error_code_test.cpp:156-160 expects -EINVAL here, but the
    reference itself returns success — verified by executing its parse_frame;
    the FEC corrects the flip before the MIC is computed.  See PARITY.md.)"""
    key = bytes(16)
    frame = Frame()
    frame.payload = b"\xaa"
    syms = np.asarray(build_frame(key, frame)).copy()
    syms[0] ^= 1
    out = parse_frame(key, syms)
    assert out.payload == frame.payload


def test_mic_mismatch():
    """An uncorrectable 2-bit corruption changes the decoded byte -> MIC
    failure with errno EINVAL (lorawan.cpp:159-161)."""
    key = bytes(16)
    frame = Frame()
    frame.payload = b"\xaa"
    syms = np.asarray(build_frame(key, frame)).copy()
    syms[0] ^= 0x03
    with pytest.raises(MicMismatchError):
        parse_frame(key, syms)


def test_parse_too_short():
    key = bytes(16)
    with pytest.raises(RangeError):
        parse_frame(key, np.zeros(4, np.uint16))


def test_fopts_overrun():
    """FOpts length nibble exceeding the body -> ERANGE
    (error_code_test.cpp fopts case, lorawan.cpp:172)."""
    key = bytes(16)
    # craft bytes with fctrl low nibble = 5 but no room, then valid MIC
    body = bytes([0, 0, 0, 0, 0, 0x05, 0, 0])
    mic = compute_mic(key, True, 0, 0, body)
    wire = body + mic.to_bytes(4, "little")
    from lora_sdr_lightweight_standalone_library_clean.models.modem import encode
    syms = encode(np.frombuffer(wire, np.uint8)[None])[0]
    with pytest.raises(RangeError):
        parse_frame(key, np.asarray(syms))


def test_build_frame_fopts_cap():
    key = bytes(16)
    frame = Frame()
    frame.fhdr.fopts = bytes(16)  # > 15
    with pytest.raises(RangeError):
        build_frame(key, frame)
