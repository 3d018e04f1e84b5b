"""Pre-dechirped ("tones") demodulation path — golden-vector parity.

Re-design of the reference's legacy vector path ``lora_demodulate``
(``src/phy/LoRaDemod.cpp:50-197``): callers dechirp externally and this
function performs peak normalization, the 2-symbol CFO/timing estimate with
the *explicit lowest-index tie-break* (LoRaDemod.cpp:102-111), per-symbol CFO
derotation, windowing, detection, and sync-word nibble extraction.  This is
the exact path the reference perf harness times (tests/performance_test.cpp:
112-125) and the path the golden IQ vectors validate.

Batched over leading axes; pure function of (iq planes, params).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from ..ops.detect import detect_ri
from ..utils.config import LoraParams
from .modem import (_estimate_core, _timing_shifted_windows, window_table,
                    TWO_PI, DemodResult)

__all__ = ["demodulate_tones"]


def demodulate_tones(iq_r, iq_i, params: LoraParams,
                     normalize: bool = True) -> DemodResult:
    """Demodulate pre-dechirped samples (LoRaDemod.cpp:50-197).

    Matches the reference exactly, including:
     - peak normalization into [-1, 1] only when max(|I|,|Q|) > 1
       (LoRaDemod.cpp:60-78); with device arrays the scratch buffer of the C
       API is unnecessary, so the -ERANGE path does not exist here.
     - equal-power lowest-index tie-break during estimation
       (LoRaDemod.cpp:102-111).
     - sync-word extraction only when >= 2 symbols are present
       (LoRaDemod.cpp:166-193); with fewer symbols all detections are data.
    """
    n, osr, step = params.n, params.osr, params.step
    sample_count = iq_r.shape[-1]
    total = sample_count // step
    have_sync = total >= 2
    cut = total * step
    iq_r = iq_r[..., :cut]
    iq_i = iq_i[..., :cut]

    if normalize:
        # one reduction pass for the peak; the scale multiplies the (much
        # smaller) estimator slice and symbol windows instead of
        # materializing a normalized copy of the whole stream
        max_amp = jnp.maximum(
            jnp.max(jnp.abs(iq_r), axis=-1), jnp.max(jnp.abs(iq_i), axis=-1))
        scale = jnp.where(max_amp > 1.0, 1.0 / max_amp, 1.0)[..., None]
    else:
        scale = jnp.ones(iq_r.shape[:-1] + (1,), jnp.float32)

    est_syms = min(total, 2)
    est = _estimate_core(iq_r[..., : est_syms * step] * scale,
                         iq_i[..., : est_syms * step] * scale,
                         params, est_syms, tie_break_idx=True)
    t_off = jnp.round(est.time_offset).astype(jnp.int32)
    rate = -TWO_PI * est.cfo / np.float32(n)

    zr, zi = _timing_shifted_windows(iq_r, iq_i, t_off, total, step, osr, n)
    zr = zr * scale[..., None]
    zi = zi * scale[..., None]

    s_idx = jnp.arange(total, dtype=jnp.float32) * np.float32(n)
    start = rate[..., None] * (
        s_idx + t_off.astype(jnp.float32)[..., None] / np.float32(osr))

    idx, power, power_avg = _rotate_detect(zr, zi, rate, start, params)
    if have_sync:
        sw0, sw1 = idx[..., 0], idx[..., 1]
        shift = params.sf - 4 if params.sf > 4 else 0
        sync = ((((sw0 >> shift) & 0xF) << 4) | ((sw1 >> shift) & 0xF))
        symbols = idx[..., 2:]
    else:
        sync = jnp.zeros(idx.shape[:-1], jnp.int32)
        symbols = idx
    return DemodResult(
        symbols=symbols.astype(jnp.uint16),
        sync_word=sync.astype(jnp.uint8),
        cfo=est.cfo,
        time_offset=est.time_offset,
        power=power,
        power_avg=power_avg,
    )


def _rotate_detect(zr, zi, rate, start, params: LoraParams):
    """CFO-rotate by ``start + rate * i`` (phy.cpp:218-227), window, and
    detect each symbol window."""
    n = params.n
    ph = start[..., None] + rate[..., None, None] * jnp.arange(
        n, dtype=jnp.float32)
    c, s = jnp.cos(ph), jnp.sin(ph)
    fr = zr * c - zi * s
    fi = zr * s + zi * c
    win = window_table(n, params.window)
    if win is not None:
        w = jnp.asarray(win)
        fr = fr * w
        fi = fi * w
    det = detect_ri(fr, fi)
    return det.index, det.power, det.power_avg
