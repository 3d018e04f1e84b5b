"""Bit-exact parity against IQ/symbol dumps produced by the reference binary.

Fixtures under tests/vectors/ref_*.npz were generated by running the
reference's ``lora_phy_vector_dump`` (scripts/make_parity_fixtures.py) and
hold: payload, encoded symbols, float32 IQ, the reference full-RX demod
output, and its decoded bytes.
"""
from pathlib import Path

import numpy as np
import pytest

import lora_sdr_lightweight_standalone_library_clean as L
from lora_sdr_lightweight_standalone_library_clean.ops import codes

VEC_DIR = Path(__file__).parent / "vectors"
FIXTURES = sorted(f for f in VEC_DIR.glob("ref_*.npz")
                  if not f.stem.startswith("ref_offsets"))


def _params(d):
    return L.LoraParams(sf=int(d["sf"]), bw=int(d["bw"]), osr=int(d["osr"]),
                        window=str(d["window"]))


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.stem)
def test_full_path_demod_bit_exact(path):
    """My full-RX demodulate on the reference's IQ must reproduce the
    reference's own demod output symbol-for-symbol (including its raw-chirp
    offset estimates)."""
    d = np.load(path)
    p = _params(d)
    rr, ri = L.from_complex(d["iq"][None])
    res = L.demodulate(rr, ri, p)
    mine = np.asarray(res.symbols)[0]
    np.testing.assert_array_equal(mine, d["demod"][: len(mine)])


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.stem)
def test_tones_path_bins(path):
    """Dechirped detection recovers (sym * bw_scale) mod N for every encoded
    symbol — the reference's observed mapping (SURVEY §4.4.2: the core chain
    only roundtrips payloads at bw_scale == 1)."""
    d = np.load(path)
    p = _params(d)
    nsym = d["iq"].size // p.step - 2
    enc = d["encoded"][:nsym].astype(np.int64)
    rr, ri = L.from_complex(d["iq"][None])
    dr, di = L.dechirp(rr, ri, p)
    res = L.demodulate_tones(dr, di, p)
    got = np.asarray(res.symbols)[0]
    np.testing.assert_array_equal(got, (enc * p.bw_scale) % p.n)
    # the sync nibbles suffer the same *bw_scale bin corruption: at bw>125
    # the recovered sync word is ((sw*bs mod N) >> shift) per nibble
    sw0, sw1 = p.sync_nibble_symbols()
    shift = p.sf - 4 if p.sf > 4 else 0
    exp_sync = ((((sw0 * p.bw_scale) % p.n) >> shift & 0xF) << 4) | \
        (((sw1 * p.bw_scale) % p.n) >> shift & 0xF)
    assert int(res.sync_word[0]) == exp_sync


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.stem)
def test_payload_roundtrip_from_reference_iq(path):
    """Payload decodes bit-exactly from the reference's IQ via the tones path
    for bw_scale == 1 (Hamming corrects the clipped codeword MSB)."""
    d = np.load(path)
    p = _params(d)
    if p.bw_scale != 1:
        pytest.skip("reference cannot roundtrip bw>125 at osr=1 (SURVEY §4.4.2)")
    rr, ri = L.from_complex(d["iq"][None])
    dr, di = L.dechirp(rr, ri, p)
    res = L.demodulate_tones(dr, di, p)
    dec, _ = L.decode(res.symbols)
    np.testing.assert_array_equal(np.asarray(dec)[0], d["payload"])


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.stem)
def test_modulate_iq_tolerance(path):
    """IQ-level comparison: exact integer phases vs the reference's float32
    accumulator.  The error budget is the reference's own drift (grows with
    packet length); decode-level equality is asserted separately."""
    d = np.load(path)
    p = _params(d)
    nsym = d["iq"].size // p.step - 2
    enc = d["encoded"][:nsym].astype(np.int32)
    re, im = L.modulate(enc[None], p)
    mine = np.asarray(re)[0] + 1j * np.asarray(im)[0]
    err = np.abs(mine - d["iq"][: mine.size])
    if p.osr > 1:
        # osr>1 flips ±pi at float wrap-boundary ties in most symbols
        # (PARITY.md deviation 2); IQ-level comparison is meaningless there.
        # Decode-level equality is covered by test_full_path_demod_bit_exact.
        pytest.skip("osr>1 wrap-tie phase flips: decode-level parity only")
    budget = {7: 0.02, 8: 0.02, 9: 0.1, 10: 0.3, 11: 0.7, 12: 1.3}[p.sf]
    assert float(err.max()) < budget


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.stem)
def test_reference_decode_chain_replication(path):
    """Replicate the dump runner's post-processing: deinterleave the demod
    symbols and Hamming-decode to the reference's decoded.bin
    (lora_phy_vector_dump.cpp:153-162)."""
    d = np.load(path)
    p = _params(d)
    demod = d["demod"]
    if len(demod) % (4 + 4):
        pytest.skip("dump padded demod buffer")
    deint = codes.diagonal_deinterleave(demod.astype(np.uint16), p.sf, 4)
    nbytes = len(d["decoded"])
    dec = codes.decode_hamming84(deint[: 2 * nbytes])
    got = ((dec[0::2] & 0xF) << 4) | (dec[1::2] & 0xF)
    np.testing.assert_array_equal(got.astype(np.uint8), d["decoded"])


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.stem)
def test_my_iq_self_roundtrip(path):
    """End-to-end self-consistency on MY modulated IQ (not the reference's):
    encode -> modulate -> dechirp -> demod -> decode == payload at
    bw_scale == 1."""
    d = np.load(path)
    p = _params(d)
    if p.bw_scale != 1:
        pytest.skip("bw>125 mapping is non-injective at the symbol level")
    payload = d["payload"]
    syms = L.encode(payload[None])
    re, im = L.modulate(syms, p)
    dr, di = L.dechirp(re, im, p)
    res = L.demodulate_tones(dr, di, p)
    dec, _ = L.decode(res.symbols)
    np.testing.assert_array_equal(np.asarray(dec)[0], payload)
    assert int(res.sync_word[0]) == 0x12


OFFSET_FIXTURES = sorted(VEC_DIR.glob("ref_offsets_*.npz"))


@pytest.mark.parametrize("path", OFFSET_FIXTURES, ids=lambda p: p.stem)
def test_estimate_and_compensate_offsets_parity(path):
    """estimate_offsets + compensate_offsets vs the reference probe on the
    same impaired IQ (phy.cpp:81-180) — the last public entry point gains a
    reference diff.  Covers the CFO-unit quirk
    (PARITY.md defect 10) by construction: the fixture IQ carries a true
    fractional-bin CFO and the reference's estimate is reproduced verbatim,
    not corrected."""
    d = np.load(path)
    p = L.LoraParams(sf=int(d["sf"]))
    rr, ri = L.from_complex(d["iq"])
    est = L.estimate_offsets(rr, ri, p)
    assert abs(float(est.cfo) - float(d["ref_cfo"])) < 2e-5, \
        (float(est.cfo), float(d["ref_cfo"]))
    assert abs(float(est.time_offset) - float(d["ref_time_offset"])) < 1e-3
    cr, ci = L.compensate_offsets(rr, ri, p, est)
    want = d["compensated"]
    np.testing.assert_allclose(np.asarray(cr), want.real, atol=2e-4)
    np.testing.assert_allclose(np.asarray(ci), want.imag, atol=2e-4)
