"""Wide streaming RX: continuous BW-250/500 streams -> payloads.

The reference cannot decode BW-250/500 at all (its decimating detector's
symbol map loses the top log2(bw_scale) bits, SURVEY §4.4.2 — down-chirp at
phy.cpp:206-208, detector at LoRaDemod.cpp:158), and its demod only takes
caller-aligned single packets.  These tests prove the deployment-shaped
form of both capabilities at once: packets at arbitrary sample offsets in
continuous sf9/BW250@osr2 and sf12/BW500@osr4 streams — with AWGN and CFO
impairments — are recovered bit-exactly through ``receive_stream``'s wide
mode (auto-enabled at bw_scale > 1, osr >= bw_scale), with sample-exact
reported starts and chunking invariance via carried state.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import lora_sdr_lightweight_standalone_library_clean as L
from lora_sdr_lightweight_standalone_library_clean.models.modem import (
    crc_sx1272)
from lora_sdr_lightweight_standalone_library_clean.models import frame
from lora_sdr_lightweight_standalone_library_clean.parallel.receiver import (
    receive_stream, receive_stream_frames, stream_rx_init,
    stream_frames_init, packet_samples)

P9 = L.LoraParams(sf=9, bw=250000, cr="4/8", osr=2)
P12 = L.LoraParams(sf=12, bw=500000, osr=4)


def crc_frame(body):
    """Payload with the trailing CRC-16 the decode path checks."""
    b = np.asarray(body, np.uint8)
    crc = int(np.asarray(crc_sx1272(jnp.asarray(b[2:]))))
    return np.concatenate([b, [crc & 0xFF, crc >> 8]]).astype(np.uint8)


def build_stream(params, offsets, payload_bytes, length, seed=42,
                 noise=0.05, cfo_bins=0.0):
    """Noisy stream with one CRC-framed packet per offset; optional
    continuous CFO rotation of the whole composed stream (in wide-grid
    bins, i.e. cycles per n*osr samples)."""
    rng = np.random.default_rng(seed)
    plen = packet_samples(params, payload_bytes * 2)
    sr = rng.standard_normal(length).astype(np.float32) * noise
    si = rng.standard_normal(length).astype(np.float32) * noise
    payloads = []
    for g in offsets:
        pl = crc_frame(rng.integers(0, 256, payload_bytes - 2))
        payloads.append(pl)
        re, im = L.modulate(L.encode(pl[None]), params)
        sr[g:g + plen] += np.asarray(re)[0]
        si[g:g + plen] += np.asarray(im)[0]
    if cfo_bins:
        ph = (2.0 * np.pi * cfo_bins / (params.n * params.osr)
              * np.arange(length))
        c, s = np.cos(ph, dtype=np.float32), np.sin(ph, dtype=np.float32)
        sr, si = sr * c - si * s, sr * s + si * c
    return jnp.asarray(sr), jnp.asarray(si), payloads


def assert_recovered(pkts, offsets, payloads, sync_word):
    valid = np.asarray(pkts.valid)
    assert valid.sum() == len(offsets), np.asarray(pkts.start)[valid]
    starts = np.asarray(pkts.start)[valid]
    np.testing.assert_array_equal(np.sort(starts), offsets)
    for k in np.nonzero(valid)[0]:
        j = offsets.index(int(np.asarray(pkts.start)[k]))
        np.testing.assert_array_equal(np.asarray(pkts.payload)[k],
                                      payloads[j])
        assert bool(np.asarray(pkts.crc_ok)[k])
        assert int(np.asarray(pkts.sync_word)[k]) == sync_word


def test_sf9_bw250_stream_recovered_bit_exactly():
    """sf9/BW250@osr2: arbitrary-offset packets under AWGN + CFO decode
    bit-exactly with sample-exact starts through the auto-wide path."""
    offsets = [517, 23003, 46101]
    sr, si, payloads = build_stream(P9, offsets, 8, 65536, cfo_bins=0.2)
    pkts, _ = receive_stream(sr, si, P9, payload_symbols=16, max_packets=8)
    assert_recovered(pkts, offsets, payloads, P9.sync_word)


@pytest.mark.slow
def test_sf9_wide_chunked_equals_single_shot():
    """Chunked wide recovery with carried state matches single-shot,
    including a packet straddling the chunk boundary."""
    plen = packet_samples(P9, 16)
    offsets = [517, 32768 - plen // 2, 65536 - plen - 1003]
    sr, si, payloads = build_stream(P9, offsets, 8, 65536)
    whole, _ = receive_stream(sr, si, P9, payload_symbols=16, max_packets=8)

    state = stream_rx_init(P9, 16)
    got = []
    for lo in range(0, 65536, 16384):
        pkts, state = receive_stream(sr[lo:lo + 16384], si[lo:lo + 16384],
                                     P9, payload_symbols=16, max_packets=8,
                                     state=state)
        v = np.asarray(pkts.valid)
        for k in np.nonzero(v)[0]:
            got.append((int(np.asarray(pkts.start)[k]),
                        bytes(np.asarray(pkts.payload)[k]),
                        bool(np.asarray(pkts.crc_ok)[k])))
    got.sort()
    wv = np.asarray(whole.valid)
    want = sorted(
        (int(np.asarray(whole.start)[k]),
         bytes(np.asarray(whole.payload)[k]),
         bool(np.asarray(whole.crc_ok)[k]))
        for k in np.nonzero(wv)[0])
    assert got == want
    assert [g[0] for g in got] == offsets
    assert all(g[2] for g in got)


@pytest.mark.slow
def test_sf12_bw500_osr4_stream_recovered_bit_exactly():
    """sf12/BW500@osr4 (16384-sample symbols): the heaviest wide config
    streams bit-exactly; the period-4096 sync-residue alias (see
    find_packet_starts ``max_mis``) must produce no duplicate."""
    plen = packet_samples(P12, 8)
    length = ((2 * plen + 3 * 16384) // 4096 + 1) * 4096
    offsets = [517, length - plen - 2003]
    sr, si, payloads = build_stream(P12, offsets, 4, length, cfo_bins=0.1)
    pkts, _ = receive_stream(sr, si, P12, payload_symbols=8, max_packets=8)
    assert_recovered(pkts, offsets, payloads, P12.sync_word)


def test_wide_forced_without_osr_raises():
    z = jnp.zeros(8192, jnp.float32)
    p = L.LoraParams(sf=9, bw=250000, osr=1)
    with pytest.raises(L.errors.InvalidArgumentError):
        receive_stream(z, z, p, payload_symbols=8, max_packets=4, wide=True)


@pytest.mark.slow
def test_wide_frames_stream_mixed_lengths():
    """Header-driven variable-length frames through the wide streaming
    path: mixed lengths at arbitrary offsets on sf9/BW250@osr2."""
    rng = np.random.default_rng(11)
    max_len = 8
    s_max = frame.max_frame_symbols(P9, max_len)
    length = 65536
    # the last frame's MAXIMAL window must complete inside the stream
    # (ownership treats every packet as maximum-length)
    plen_max = packet_samples(P9, s_max)
    pkts_in = [(777, rng.integers(0, 256, 3, dtype=np.uint8)),
               (length - plen_max - 1003,
                rng.integers(0, 256, 8, dtype=np.uint8))]
    sr = rng.standard_normal(length).astype(np.float32) * 0.05
    si = rng.standard_normal(length).astype(np.float32) * 0.05
    for g, payload in pkts_in:
        sym = frame.encode_frame(np.asarray(payload, np.uint8), P9)
        re, im = L.modulate(np.asarray(sym)[None], P9)
        plen = np.asarray(re).shape[-1]
        sr[g:g + plen] += np.asarray(re)[0]
        si[g:g + plen] += np.asarray(im)[0]
    frames, _ = receive_stream_frames(
        jnp.asarray(sr), jnp.asarray(si), P9, max_payload_len=max_len,
        max_packets=8)
    got = {}
    for k in range(frames.valid.shape[0]):
        if bool(frames.valid[k]) and bool(frames.crc_ok[k]):
            ln = int(frames.length[k])
            got[int(frames.start[k])] = np.asarray(
                frames.payload[k, :ln]).tolist()
    assert len(got) == 2
    for g, p in pkts_in:
        assert got[g] == list(p)
