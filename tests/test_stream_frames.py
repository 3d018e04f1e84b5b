"""Header-driven variable-length streaming RX (models/frame.py over
parallel/receiver.py): mixed-length frames, zero-gap back-to-back packets,
sub-packet gaps, and chunking invariance.

The reference has no equivalent — its demod takes caller-sized buffers
(phy.cpp:182-192); the explicit-header machinery it ships but never wires
(LoRaCodes.hpp:16-18,43-67) is what makes these streams receivable.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import lora_sdr_lightweight_standalone_library_clean as L
from lora_sdr_lightweight_standalone_library_clean.models import frame
from lora_sdr_lightweight_standalone_library_clean.parallel.receiver import (
    receive_stream_frames, stream_frames_init, packet_samples)

P = L.LoraParams(sf=7, cr="4/8")
MAX_LEN = 16
S_MAX = frame.max_frame_symbols(P, MAX_LEN)
PLEN_MAX = packet_samples(P, S_MAX)


def build_stream(packets, length=24576, seed=42, noise=0.05):
    """Noisy stream with framed packets: [(offset, payload bytes), ...]."""
    rng = np.random.default_rng(seed)
    sr = rng.standard_normal(length).astype(np.float32) * noise
    si = rng.standard_normal(length).astype(np.float32) * noise
    for g, payload in packets:
        sym = frame.encode_frame(np.asarray(payload, np.uint8), P)
        re, im = L.modulate(np.asarray(sym)[None], P)
        plen = np.asarray(re).shape[-1]
        sr[g:g + plen] += np.asarray(re)[0]
        si[g:g + plen] += np.asarray(im)[0]
    return jnp.asarray(sr), jnp.asarray(si)


def recover(sr, si, **kw):
    return receive_stream_frames(sr, si, P, max_payload_len=MAX_LEN,
                                 max_packets=8, **kw)


def payloads_by_start(frames):
    out = {}
    for k in range(frames.valid.shape[0]):
        if bool(frames.valid[k]) and bool(frames.crc_ok[k]):
            ln = int(frames.length[k])
            out[int(frames.start[k])] = np.asarray(
                frames.payload[k, :ln]).tolist()
    return out


def test_mixed_length_frames_recovered():
    rng = np.random.default_rng(7)
    pkts = [(1000, rng.integers(0, 256, 3, dtype=np.uint8)),
            (9000, rng.integers(0, 256, 16, dtype=np.uint8)),
            (17000, rng.integers(0, 256, 9, dtype=np.uint8))]
    sr, si = build_stream(pkts)
    frames, _ = recover(sr, si)
    got = payloads_by_start(frames)
    assert len(got) == 3
    starts = sorted(got)
    for (g, p), s in zip(pkts, starts):
        assert s == g
        assert got[s] == list(p)


def test_back_to_back_zero_gap():
    """Two frames with ZERO samples between them both recover
    (packets separated by less than one packet length)."""
    rng = np.random.default_rng(3)
    p1 = rng.integers(0, 256, 6, dtype=np.uint8)
    p2 = rng.integers(0, 256, 11, dtype=np.uint8)
    len1 = packet_samples(P, frame.frame_symbols(P, 6))
    g1 = 2048
    pkts = [(g1, p1), (g1 + len1, p2)]       # second starts where first ends
    sr, si = build_stream(pkts)
    frames, _ = recover(sr, si)
    got = payloads_by_start(frames)
    assert got[g1] == list(p1)
    assert got[g1 + len1] == list(p2)


def test_sub_packet_gap_fixed_length_path():
    """receive_stream (fixed length) also survives a gap shorter than one
    packet between consecutive packets."""
    from lora_sdr_lightweight_standalone_library_clean.models.modem \
        import crc_sx1272
    from lora_sdr_lightweight_standalone_library_clean.parallel.receiver \
        import receive_stream
    psyms = 12
    plen = packet_samples(P, psyms)
    rng = np.random.default_rng(11)
    sr = rng.standard_normal(16384).astype(np.float32) * 0.05
    si = rng.standard_normal(16384).astype(np.float32) * 0.05
    payloads = []
    g1 = 1024
    g2 = g1 + plen + plen // 3               # gap = plen/3 < plen
    for g in (g1, g2):
        body = rng.integers(0, 256, 4, dtype=np.uint8)
        crc = int(np.asarray(crc_sx1272(jnp.asarray(body[2:]))))
        pl = np.concatenate([body, [crc & 0xFF, crc >> 8]]).astype(np.uint8)
        payloads.append(pl)
        re, im = L.modulate(L.encode(pl[None]), P)
        sr[g:g + plen] += np.asarray(re)[0]
        si[g:g + plen] += np.asarray(im)[0]
    pkts, _ = receive_stream(jnp.asarray(sr), jnp.asarray(si), P,
                             payload_symbols=psyms, max_packets=8)
    recovered = {int(pkts.start[k]): np.asarray(pkts.payload[k]).tolist()
                 for k in range(8) if bool(pkts.valid[k])
                 and bool(pkts.crc_ok[k])}
    assert recovered[g1] == payloads[0].tolist()
    assert recovered[g2] == payloads[1].tolist()


def test_chunked_equals_single_shot_frames():
    """Variable-length recovery is invariant to chunking, including a frame
    straddling the chunk boundary.  (Ownership treats frames as maximal
    length, so every start needs start + PLEN_MAX inside the stream.)"""
    rng = np.random.default_rng(5)
    # non-overlapping on air; the second frame straddles the 8192 boundary
    pkts = [(2000, rng.integers(0, 256, 5, dtype=np.uint8)),
            (6000, rng.integers(0, 256, 14, dtype=np.uint8)),
            (14000, rng.integers(0, 256, 8, dtype=np.uint8))]
    sr, si = build_stream(pkts, length=24576)
    whole, _ = recover(sr, si)
    want = payloads_by_start(whole)
    assert len(want) == 3

    state = stream_frames_init(P, MAX_LEN)
    got = {}
    for lo in range(0, 24576, 4096):
        frames, state = recover(sr[lo:lo + 4096], si[lo:lo + 4096],
                                state=state)
        got.update(payloads_by_start(frames))
    assert got == want


def test_oversize_frame_flagged_not_crashed():
    """A frame longer than the static bound surfaces as hdr_ok=False."""
    rng = np.random.default_rng(9)
    big = rng.integers(0, 256, MAX_LEN + 8, dtype=np.uint8)
    sym = frame.encode_frame(big, P)
    re, im = L.modulate(np.asarray(sym)[None], P)
    sr = np.zeros(24576, np.float32)
    si = np.zeros(24576, np.float32)
    n = np.asarray(re).shape[-1]
    sr[3000:3000 + n] = np.asarray(re)[0]
    si[3000:3000 + n] = np.asarray(im)[0]
    frames, _ = recover(jnp.asarray(sr), jnp.asarray(si))
    k = int(np.argmax(np.asarray(frames.valid)))
    assert bool(frames.valid[k])
    assert not bool(frames.hdr_ok[k]) and not bool(frames.crc_ok[k])


def test_jit_and_retrace_stability():
    f = jax.jit(functools.partial(receive_stream_frames, params=P,
                                  max_payload_len=MAX_LEN, max_packets=8))
    rng = np.random.default_rng(1)
    pkts = [(2024, rng.integers(0, 256, 7, dtype=np.uint8))]
    sr, si = build_stream(pkts, length=8192)
    flush = jnp.zeros(8192, jnp.float32)
    state = stream_frames_init(P, MAX_LEN)
    frames, state = f(sr, si, state=state)
    with jax.checking_leaks():
        frames2, _ = f(flush, flush, state=state)  # fresh data, same shapes
    got = payloads_by_start(frames)
    got.update(payloads_by_start(frames2))         # maximal-window ownership
    assert got[2024] == list(pkts[0][1])
