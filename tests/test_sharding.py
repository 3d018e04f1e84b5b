"""Multi-device sharding tests on the forced 8-device CPU mesh.

Validates the multi-device parallelism: data-parallel packet sharding
over 'dp' and overlap-save stream scanning over 'sp' with ppermute halos.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import lora_sdr_lightweight_standalone_library_clean as L
from lora_sdr_lightweight_standalone_library_clean.parallel import mesh as M
from lora_sdr_lightweight_standalone_library_clean.parallel.streaming import (
    stream_scan, find_sync_starts)


needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="needs 8 virtual devices")


@needs_8
def test_dp_sharded_pipeline_matches_single_device():
    p = L.LoraParams(sf=7)
    rng = np.random.default_rng(11)
    payloads = rng.integers(0, 256, (8, 16)).astype(np.uint8)

    def pipeline(payloads):
        syms = L.encode(payloads)
        re, im = L.modulate(syms, p)
        dr, di = L.dechirp(re, im, p)
        res = L.demodulate_tones(dr, di, p)
        dec, crc = L.decode(res.symbols)
        return dec

    want = np.asarray(jax.jit(pipeline)(payloads))

    mesh = M.make_mesh(8)
    sharded = M.shard_packets(jnp.asarray(payloads), mesh)
    got = jax.jit(pipeline)(sharded)
    assert len(got.devices()) == 8  # stayed sharded over dp
    np.testing.assert_array_equal(np.asarray(got), want)
    np.testing.assert_array_equal(want, payloads)


@needs_8
def test_stream_scan_halo_exchange():
    """Sub-symbol-stride scan sharded over 'sp' must equal the unsharded
    scan — including windows that straddle block boundaries (halo)."""
    p = L.LoraParams(sf=7)
    rng = np.random.default_rng(12)
    # stream: 4 packets of 6 data symbols back to back
    payloads = rng.integers(0, 256, (4, 3)).astype(np.uint8)
    syms = L.encode(payloads)
    re, im = L.modulate(syms, p)
    stream_r = jnp.asarray(np.asarray(re).reshape(-1))
    stream_i = jnp.asarray(np.asarray(im).reshape(-1))

    stride = p.step // 2
    want = stream_scan(stream_r, stream_i, p, stride=stride)

    mesh = M.make_mesh(8, dp=1, sp=8)
    got = jax.jit(
        lambda r, i: stream_scan(r, i, p, mesh=mesh, stride=stride)
    )(stream_r, stream_i)
    gi, wi = np.asarray(got.index), np.asarray(want.index)
    gp, wp = np.asarray(got.power), np.asarray(want.power)
    # power spectra identical to float accumulation noise everywhere
    np.testing.assert_allclose(gp, wp, rtol=1e-4, atol=1e-4)
    # symbol-aligned windows (real tones) must match bit-exactly — these are
    # the windows that straddle nothing or use the halo's real content
    np.testing.assert_array_equal(gi[0::2], wi[0::2])
    # half-aligned windows have flat junk spectra; batch-shape-dependent
    # f32 reduction order may flip exact ties there
    flips = (gi[1::2] != wi[1::2])
    assert flips.mean() < 0.15
    assert np.allclose(gp[1::2][flips], wp[1::2][flips], atol=1e-4)


def test_find_sync_starts():
    """Symbol-aligned scan of back-to-back packets flags exactly the packet
    starts."""
    p = L.LoraParams(sf=7)
    payloads = np.arange(8, dtype=np.uint8).reshape(2, 4)
    syms = L.encode(payloads)
    re, im = L.modulate(syms, p)
    stream_r = jnp.asarray(np.asarray(re).reshape(-1))
    stream_i = jnp.asarray(np.asarray(im).reshape(-1))
    scan = stream_scan(stream_r, stream_i, p)
    mask = np.asarray(find_sync_starts(scan, p))
    pkt_windows = syms.shape[-1] + 2
    expected = np.zeros_like(mask)
    expected[0] = expected[pkt_windows] = True
    np.testing.assert_array_equal(mask, expected)


def test_find_sync_starts_noise_only():
    """A pure-noise stream must yield zero sync starts at the default gate
   : noise windows have ~0 dB SNR at every bin."""
    p = L.LoraParams(sf=7)
    rng = np.random.default_rng(99)
    total = 64 * p.step
    stream_r = jnp.asarray(rng.normal(0, 0.3, total).astype(np.float32))
    stream_i = jnp.asarray(rng.normal(0, 0.3, total).astype(np.float32))
    scan = stream_scan(stream_r, stream_i, p)
    mask = np.asarray(find_sync_starts(scan, p))
    assert not mask.any()


def test_find_sync_starts_zero_stream():
    """All-zero samples (e.g. the zero halo past the end of the stream) must
    never pass the power gate — the 20*log10(0) = -inf artifact is clamped."""
    p = L.LoraParams(sf=7)
    z = jnp.zeros(32 * p.step, jnp.float32)
    scan = stream_scan(z, z, p)
    mask = np.asarray(find_sync_starts(scan, p))
    assert not mask.any()
    # and a real packet followed by dead air still flags only its start
    syms = L.encode(np.arange(4, dtype=np.uint8)[None])
    re, im = L.modulate(syms, p)
    sr = jnp.concatenate([re.reshape(-1), jnp.zeros(16 * p.step)])
    si = jnp.concatenate([im.reshape(-1), jnp.zeros(16 * p.step)])
    scan = stream_scan(sr, si, p)
    mask = np.asarray(find_sync_starts(scan, p))
    assert mask[0] and mask.sum() == 1


@needs_8
def test_mesh_shapes():
    m = M.make_mesh(8)
    assert m.shape == {"dp": 8, "sp": 1}
    m2 = M.make_mesh(8, dp=2, sp=4)
    assert m2.shape == {"dp": 2, "sp": 4}
    with pytest.raises(ValueError):
        M.make_mesh(8, dp=3, sp=3)
