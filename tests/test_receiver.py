"""End-to-end streaming RX: continuous stream -> payloads.

The flagship capability test: K packets at arbitrary (sub-symbol, even
sub-stride) sample offsets inside a long noisy stream are recovered
bit-exactly; recovery is invariant to chunking (carried state) and to
sharding the scan over an 8-device 'sp' mesh.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import lora_sdr_lightweight_standalone_library_clean as L
from lora_sdr_lightweight_standalone_library_clean.models.modem import (
    crc_sx1272)
from lora_sdr_lightweight_standalone_library_clean.parallel import mesh as M
from lora_sdr_lightweight_standalone_library_clean.parallel.receiver import (
    receive_stream, stream_rx_init, packet_samples)

needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="needs 8 virtual devices")

P = L.LoraParams(sf=7)
PAYLOAD_BYTES = 8
PSYMS = PAYLOAD_BYTES * 2
PLEN = packet_samples(P, PSYMS)


def crc_frame(body: np.ndarray) -> np.ndarray:
    """Payload with the trailing CRC-16 the decode path checks
    (phy.cpp:252-259: CRC over payload[2:-2], little-endian trailer)."""
    b = np.asarray(body, np.uint8)
    crc = int(np.asarray(crc_sx1272(jnp.asarray(b[2:]))))
    return np.concatenate([b, [crc & 0xFF, crc >> 8]]).astype(np.uint8)


def build_stream(offsets, seed=42, length=16384, noise=0.05):
    """Noisy stream with one CRC-framed packet at each sample offset."""
    rng = np.random.default_rng(seed)
    sr = rng.standard_normal(length).astype(np.float32) * noise
    si = rng.standard_normal(length).astype(np.float32) * noise
    bodies = rng.integers(0, 256, (len(offsets), PAYLOAD_BYTES - 2))
    payloads = np.stack([crc_frame(b) for b in bodies])
    for k, g in enumerate(offsets):
        re, im = L.modulate(L.encode(payloads[k:k + 1]), P)
        sr[g:g + PLEN] += np.asarray(re)[0]
        si[g:g + PLEN] += np.asarray(im)[0]
    return jnp.asarray(sr), jnp.asarray(si), payloads


def recover(sr, si, **kw):
    pkts, st = receive_stream(sr, si, P, payload_symbols=PSYMS,
                              max_packets=8, **kw)
    return pkts, st


def test_arbitrary_offset_packets_recovered_bit_exactly():
    offsets = [512, 5003, 9000, 11777]      # aligned + sub-stride offsets
    sr, si, payloads = build_stream(offsets)
    pkts, _ = recover(sr, si)
    valid = np.asarray(pkts.valid)
    assert valid.sum() == len(offsets)
    starts = np.asarray(pkts.start)[valid]
    np.testing.assert_array_equal(np.sort(starts), offsets)
    for k, g in enumerate(starts):
        exp = payloads[offsets.index(g)]
        np.testing.assert_array_equal(np.asarray(pkts.payload)[k], exp)
        assert bool(np.asarray(pkts.crc_ok)[k])
        assert int(np.asarray(pkts.sync_word)[k]) == P.sync_word


def test_chunked_equals_single_shot():
    """Chunking with carried state recovers the same packets, each exactly
    once, including packets straddling chunk boundaries."""
    # chunk boundary at 8192: plant one packet straddling it
    offsets = [512, 8192 - PLEN // 2, 13056]
    sr, si, payloads = build_stream(offsets)

    whole, _ = recover(sr, si)

    state = stream_rx_init(P, PSYMS)
    got = []
    for lo in range(0, 16384, 4096):
        pkts, state = receive_stream(
            sr[lo:lo + 4096], si[lo:lo + 4096], P,
            payload_symbols=PSYMS, max_packets=8, state=state)
        v = np.asarray(pkts.valid)
        for k in np.nonzero(v)[0]:
            got.append((int(np.asarray(pkts.start)[k]),
                        bytes(np.asarray(pkts.payload)[k]),
                        bool(np.asarray(pkts.crc_ok)[k])))
    got.sort()
    wv = np.asarray(whole.valid)
    want = sorted(
        (int(np.asarray(whole.start)[k]), bytes(np.asarray(whole.payload)[k]),
         bool(np.asarray(whole.crc_ok)[k]))
        for k in np.nonzero(wv)[0])
    assert got == want
    assert [g[0] for g in got] == offsets
    assert all(g[2] for g in got)
    # the straddling packet was recovered by the chunk where it completes
    assert got[1][0] + PLEN > 8192


@pytest.mark.slow
@needs_8
def test_sharded_scan_equals_unsharded():
    offsets = [512, 5003, 11777]
    sr, si, payloads = build_stream(offsets)
    want, _ = recover(sr, si)
    mesh = M.make_mesh(8, dp=1, sp=8)
    got, _ = recover(sr, si, mesh=mesh)
    np.testing.assert_array_equal(np.asarray(got.valid),
                                  np.asarray(want.valid))
    np.testing.assert_array_equal(np.asarray(got.start),
                                  np.asarray(want.start))
    np.testing.assert_array_equal(np.asarray(got.payload),
                                  np.asarray(want.payload))
    np.testing.assert_array_equal(np.asarray(got.crc_ok),
                                  np.asarray(want.crc_ok))


def test_noise_only_stream_recovers_nothing():
    rng = np.random.default_rng(7)
    sr = jnp.asarray(rng.standard_normal(8192).astype(np.float32) * 0.3)
    si = jnp.asarray(rng.standard_normal(8192).astype(np.float32) * 0.3)
    pkts, _ = recover(sr, si)
    assert not np.asarray(pkts.valid).any()


@pytest.mark.slow
def test_capacity_earliest_packets_win():
    """More packets than max_packets: the earliest ones are recovered and
    reported valid, deterministically."""
    offsets = [2560 * k for k in range(6)]          # 6 non-overlapping
    sr, si, payloads = build_stream(offsets, length=20480)
    pkts, _ = receive_stream(sr, si, P, payload_symbols=PSYMS,
                             max_packets=3)
    valid = np.asarray(pkts.valid)
    assert valid.sum() == 3
    np.testing.assert_array_equal(np.asarray(pkts.start)[valid], offsets[:3])
    for k in range(3):
        np.testing.assert_array_equal(np.asarray(pkts.payload)[k],
                                      payloads[k])


def test_jit_stability():
    """receive_stream is fully jittable; repeated calls with fresh data do
    not retrace (static shapes only)."""
    import functools
    f = jax.jit(functools.partial(receive_stream, params=P,
                                  payload_symbols=PSYMS, max_packets=4))
    sr, si, payloads = build_stream([2048])
    pkts, st = f(sr, si)
    sr2, si2, payloads2 = build_stream([4096], seed=9)
    pkts2, st2 = f(sr2, si2, state=st)
    assert np.asarray(pkts.valid).sum() == 1
    assert np.asarray(pkts2.valid).sum() == 1
    np.testing.assert_array_equal(np.asarray(pkts2.payload)[0], payloads2[0])
    # second chunk's global start accounts for the carried offset
    assert int(np.asarray(pkts2.start)[0]) == 16384 + 4096


@pytest.mark.parametrize("d", [14, 15, 16, 17])
def test_half_stride_misaligned_packets_recovered(d):
    """Packets whose start falls about half a stride from every scan
    window: the second sync window then carries the first sync chirp's
    tail and sits near 5 dB SNR, which the default gate must admit."""
    offsets = [1024 + d, 6144 + d, 11264 + d]
    sr, si, payloads = build_stream(offsets)
    pkts, _ = recover(sr, si)
    valid = np.asarray(pkts.valid)
    np.testing.assert_array_equal(np.sort(np.asarray(pkts.start)[valid]),
                                  offsets)
    assert bool(np.all(np.asarray(pkts.crc_ok)[valid]))
