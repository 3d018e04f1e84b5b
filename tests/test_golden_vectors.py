"""Validation against the reference's shipped golden-vector binaries.

These read the fixtures straight from the read-only reference checkout and
skip gracefully when a blob is absent (modulation/AWGN blobs are stripped
from the snapshot, .MISSING_LARGE_BLOBS).
"""
import numpy as np
import pytest

from lora_sdr_lightweight_standalone_library_clean.ops import codes
from lora_sdr_lightweight_standalone_library_clean.utils import vectors
import lora_sdr_lightweight_standalone_library_clean as L

from conftest import reference_golden


def _need(name):
    path = reference_golden(name)
    if path is None:
        pytest.skip(f"reference golden vector {name} not available")
    return path


def test_crc_golden():
    """crc_tests.bin stores placeholder 16-bit byte *sums*, not the SX1272
    CRC ('Hello' -> 500 == sum of its bytes); no reference test reads this
    blob.  Validate the reader and the fixture's internal consistency; the
    real CRC goldens live in test_codes.py (reference-executed answers)."""
    for rec in vectors.read_crc_tests(_need("crc_tests.bin")):
        assert rec["ok"]
        assert rec["crc"] == int(rec["payload"].astype(np.uint32).sum()) & 0xFFFF


def test_hamming_golden():
    recs = vectors.read_hamming_tests(_need("hamming_tests.bin"))
    assert len(recs) == 32
    for rec in recs:
        if rec["mode"] == 0:
            enc = codes.encode_hamming84(np.uint8(rec["in"]))
            dec, err, bad = codes.decode_hamming84(enc, return_flags=True)
            assert int(dec) == rec["expected"] == rec["decoded"]
            assert bool(err) == rec["err"]
            assert bool(bad) == rec["bad"]
        else:
            enc = codes.encode_hamming74(np.uint8(rec["in"]))
            dec, err = codes.decode_hamming74(enc, return_flags=True)
            assert int(dec) == rec["expected"] == rec["decoded"]
            assert bool(err) == rec["err"]


@pytest.mark.slow
def test_sync_word_golden_records():
    recs = vectors.read_sync_word_tests(_need("sync_word_tests.bin"))
    assert len(recs) == 9
    for rec in recs:
        assert rec["sync"] == 0x34
        p = L.LoraParams(sf=rec["sf"], sync_word=rec["sync"])
        re, im = L.modulate(np.zeros((1, 0), np.int32), p)
        dr, di = L.dechirp(re, im, p)
        res = L.demodulate_tones(dr, di, p)
        assert int(res.sync_word[0]) == rec["sync"]


def test_equal_power_lowest_index():
    """SF2 fixture with two equal-power bins -> index 0 wins
    (equal_power_bin_test.cpp:25-35)."""
    path = _need("equal_power_iq.b64")
    iq = vectors.read_b64_iq(path)
    p = L.LoraParams(sf=2)
    rr, ri = L.from_complex(iq[None])
    res = L.demodulate_tones(rr, ri, p)
    assert int(res.symbols[0, 0]) == 0


def test_sync_word_iq_fixture_demod():
    """The reference's 255-sample sync fixture (one byte short, SURVEY §4.4.3)
    still demodulates: the single whole symbol is returned as data."""
    path = _need("sync_word_iq.b64")
    iq = vectors.read_b64_iq(path)
    assert iq.size == 255  # the reference fixture's known defect
    p = L.LoraParams(sf=7)
    rr, ri = L.from_complex(iq[None])
    res = L.demodulate_tones(rr, ri, p)
    assert res.symbols.shape[-1] == 1  # < 2 symbols -> no sync extraction


def test_detection_golden():
    """detection_tests.bin parses and detects consistently.

    Inspection shows the blob's IQ blocks are all noisy bin-0 tones
    regardless of the stored symbol list (placeholder fixture; no reference
    test reads this blob — see PARITY.md).  Validate the reader layout and
    that the detector finds the actual tone under the fixture's ~ -16 dB
    noise floor in every block."""
    recs = vectors.read_detection_tests(_need("detection_tests.bin"))
    assert len(recs) == 6
    from lora_sdr_lightweight_standalone_library_clean.ops.detect import detect_ri
    for rec in recs:
        n = 1 << rec["sf"]
        iq = rec["iq"].astype(np.complex64)
        assert iq.size == len(rec["symbols"]) * n
        zr = iq.real.reshape(-1, n)
        zi = iq.imag.reshape(-1, n)
        det = detect_ri(zr, zi)
        got = np.asarray(det.index)
        np.testing.assert_array_equal(got, np.zeros_like(got))
        assert (np.asarray(det.power) > np.asarray(det.power_avg)).all()


def test_modulation_tests_reader_parity():
    """Reader must parse modulation_tests.bin when present (blob is stripped
    from this snapshot -> exercise the reader on a synthetic file)."""
    path = reference_golden("modulation_tests.bin")
    if path is None:
        import io, struct, tempfile, os
        buf = io.BytesIO()
        buf.write(struct.pack("<I", 1))
        for v in (7, 125, 1, 0, 2):
            buf.write(struct.pack("<I", v << 8))
        buf.write(b"\x00")
        buf.write(bytes([0xAB, 0xCD]))
        buf.write(struct.pack("<I", 2))
        buf.write(np.array([1.0, 2.0, 3.0, 4.0]).tobytes())
        with tempfile.NamedTemporaryFile(suffix=".bin", delete=False) as f:
            f.write(buf.getvalue())
            path = f.name
        recs = vectors.read_modulation_tests(path)
        os.unlink(path)
        assert recs[0]["sf"] == 7 and recs[0]["bw_khz"] == 125
        assert list(recs[0]["payload"]) == [0xAB, 0xCD]
        assert recs[0]["iq"][0] == 1.0 + 2.0j
    else:
        recs = vectors.read_modulation_tests(path)
        assert len(recs) > 0
