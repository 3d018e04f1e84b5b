"""Payload-level roundtrip proof for ALL seven stock profiles at a
self-consistent osr.

The reference's N-bin decimating detector maps symbols to ``sym*bw_scale
mod N``, losing the top log2(bw_scale) bits — its own e2e chain fails for
every BW-250/500 profile at osr=1 (verified defect, SURVEY §4.4.2), and
its demod down-chirp is generated at osr=1 (phy.cpp:206-208) so higher
osr never fixes it.  ``demodulate_wide`` detects over the full
(N*osr)-point spectrum where the map is injective for osr >= bw_scale.

BW-125 profiles roundtrip on the standard (reference-faithful) tones path
at osr=1; BW-250/500 roundtrip through demodulate_wide at osr=bw_scale —
with noise, CFO and sub-sample timing offsets applied.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import lora_sdr_lightweight_standalone_library_clean as L


def roundtrip(params, payloads, impair=None, wide=False):
    syms = L.encode(payloads)
    re, im = L.modulate(jnp.asarray(syms), params)
    if impair is not None:
        re, im = impair(re, im)
    dr, di = L.dechirp(re, im, params)
    demod = L.demodulate_wide if wide else L.demodulate_tones
    res = demod(dr, di, params)
    dec, _ = L.decode(res.symbols)
    return np.asarray(dec), int(np.asarray(res.sync_word)[0])


@pytest.mark.parametrize("profile", L.STOCK_PROFILES,
                         ids=[p["name"] for p in L.STOCK_PROFILES])
def test_all_profiles_payload_roundtrip(profile):
    """Every stock profile decodes its payloads bit-exactly at SOME
    self-consistent osr: bw125@osr1 standard path, bw>125@osr=bw_scale
    wide path."""
    base = L.params_from_profile(profile)
    bs = base.bw_scale
    params = L.LoraParams(sf=base.sf, bw=base.bw, cr=base.cr, osr=bs,
                          window=base.window)
    rng = np.random.default_rng(base.sf)
    payloads = rng.integers(0, 256, (4, 12)).astype(np.uint8)
    dec, sync = roundtrip(params, payloads, wide=bs > 1)
    np.testing.assert_array_equal(dec, payloads)
    assert sync == params.sync_word


@pytest.mark.slow
@pytest.mark.parametrize("sf,bw,osr", [(9, 250000, 2), (12, 500000, 4)])
def test_wide_roundtrip_with_impairments(sf, bw, osr):
    """Wide receiver under AWGN + CFO + sub-sample time shift."""
    from lora_sdr_lightweight_standalone_library_clean.ops import channel
    params = L.LoraParams(sf=sf, bw=bw, osr=osr)
    rng = np.random.default_rng(7)
    payloads = rng.integers(0, 256, (8, 8)).astype(np.uint8)

    def impair(re, im):
        key = jax.random.PRNGKey(3)
        return channel.apply_channel(key, re, im, snr_db=25.0,
                                     cfo_bins=0.2,
                                     time_offset=2, n_step=params.step)

    dec, sync = roundtrip(params, payloads, impair=impair, wide=True)
    np.testing.assert_array_equal(dec, payloads)


def test_wide_requires_enough_osr():
    params = L.LoraParams(sf=9, bw=250000, osr=1)
    z = jnp.zeros(4 * params.step)
    with pytest.raises(L.errors.InvalidArgumentError):
        L.demodulate_wide(z, z, params)


def test_wide_matches_tones_at_bw125():
    """At bw_scale == 1 the wide receiver degenerates to the standard one:
    same symbols, same sync word."""
    params = L.LoraParams(sf=8)
    rng = np.random.default_rng(4)
    payloads = rng.integers(0, 256, (3, 8)).astype(np.uint8)
    re, im = L.modulate(L.encode(payloads), params)
    dr, di = L.dechirp(re, im, params)
    a = L.demodulate_tones(dr, di, params)
    b = L.demodulate_wide(dr, di, params)
    np.testing.assert_array_equal(np.asarray(a.symbols),
                                  np.asarray(b.symbols))
    np.testing.assert_array_equal(np.asarray(a.sync_word),
                                  np.asarray(b.sync_word))
