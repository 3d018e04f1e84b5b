"""Sequential float32 oracle emulating the reference C implementation.

``gen_chirp_f32`` reproduces ``genChirp`` (ChirpGenerator.hpp:24-51) with
explicit float32 rounding at every step; it was validated bit-level
(max |diff| ~7e-7) against IQ dumped by the reference binary.  Used for
differential testing of the vectorized closed-form implementation without
shipping multi-MB IQ fixtures.
"""
from __future__ import annotations

import numpy as np

F32 = np.float32
PI = F32(3.14159265358979323846)


def gen_chirp_f32(n, osr, nn, f0, down, ampl, phase, bw_scale):
    """Sequential genChirp with float32 arithmetic. Returns (iq, phase)."""
    fmin = F32(-PI * F32(bw_scale) / F32(osr))
    fmax = F32(PI * F32(bw_scale) / F32(osr))
    fstep = F32((F32(2) * PI * F32(bw_scale)) / F32(n * osr * osr))
    f = F32(fmin + F32(f0))
    out = np.zeros(nn, np.complex64)
    for i in range(nn):
        f = F32(f + fstep)
        if f > fmax:
            f = F32(f - F32(fmax - fmin))
        phase = F32(phase - f) if down else F32(phase + f)
        out[i] = complex(np.cos(F32(phase)), np.sin(F32(phase)))
    phase = F32(phase - F32(np.floor(phase / (F32(2) * PI))) * F32(2) * PI)
    return ampl * out, phase


def modulate_f32(symbols, sf, osr, bw_scale, sync=0x12, ampl=1.0):
    """Sequential lora_modulate (LoRaMod.cpp:8-43) with float32 phases."""
    n = 1 << sf
    step = n * osr
    shift = sf - 4 if sf > 4 else 0
    sw0 = ((sync >> 4) << shift) & 0xFFFF
    sw1 = ((sync & 0x0F) << shift) & 0xFFFF
    phase = F32(0.0)
    chunks = []
    for s in [sw0, sw1] + list(symbols):
        f0 = F32((F32(2) * PI * F32(s) * F32(bw_scale)) / F32(n * osr))
        c, phase = gen_chirp_f32(n, osr, step, f0, False, ampl, phase,
                                 bw_scale)
        chunks.append(c)
    return np.concatenate(chunks)


def interleave_seq(codewords, ppm, rdd):
    """Direct per-bit diagonal interleaver (LoRaCodes.hpp:376-393 spec)."""
    cw = np.asarray(codewords, np.uint16)
    nb = 4 + rdd
    nblk = len(cw) // ppm
    out = np.zeros(nblk * nb, np.uint16)
    for blk in range(nblk):
        for bit in range(nb):
            sym = 0
            for c in range(ppm):
                src = (c + bit) % ppm
                b = (int(cw[blk * ppm + src]) >> bit) & 1
                sym |= b << c
            out[blk * nb + bit] = sym
    return out


def deinterleave_seq(symbols, ppm, rdd):
    """Direct per-bit diagonal deinterleaver (LoRaCodes.hpp:396-412 spec)."""
    sym = np.asarray(symbols, np.uint16)
    nb = 4 + rdd
    nblk = len(sym) // nb
    out = np.zeros(nblk * ppm, np.uint8)
    for blk in range(nblk):
        for bit in range(nb):
            s = int(sym[blk * nb + bit])
            for c in range(ppm):
                dst = (c + bit) % ppm
                out[blk * ppm + dst] |= (s & 1) << bit
                s >>= 1
    return out


def stream_scan_ref(sr, si, sf, osr, bw_scale, stride):
    """Per-window complex128 np.fft reference of ``stream_scan``.

    Window w starts at sample w*stride of the stream followed by one
    symbol of zeros; its phase-0 decimated samples are multiplied by the
    reference down-chirp (genChirp with f0=0, down=True: no frequency wrap
    occurs, so its phase is -(m*fmin + fstep*m*(m+1)/2) after m steps) and
    transformed.  Returns (index, power dB, noise dB, second-largest
    |bin|^2 / largest) per window.
    """
    n = 1 << sf
    step = n * osr
    x = np.asarray(sr, np.float64) + 1j * np.asarray(si, np.float64)
    ext = np.concatenate([x, np.zeros(step)])
    windows = x.size // stride
    m = np.arange(0, step, osr, dtype=np.int64) + 1     # steps at i*osr
    num = np.mod(m * n * osr - m * (m + 1), 2 * n * osr * osr)
    dc = np.exp(1j * np.pi * bw_scale * num / (n * osr * osr))
    out = []
    for lo in range(0, windows, 4096):
        w = np.arange(lo, min(lo + 4096, windows))
        z = ext[w[:, None] * stride + np.arange(n)[None, :] * osr] * dc
        mag2 = np.abs(np.fft.fft(z, axis=-1)) ** 2
        top2 = np.sort(mag2, axis=-1)[:, -2:]
        scale = 20.0 * np.log10(n)
        with np.errstate(divide="ignore"):
            out.append((np.argmax(mag2, axis=-1),
                        10.0 * np.log10(top2[:, 1]) - scale,
                        10.0 * np.log10(np.maximum(mag2.sum(-1) - top2[:, 1],
                                                   0.0)) - scale,
                        top2[:, 0] / top2[:, 1]))
    return tuple(np.concatenate(c) for c in zip(*out))


def timing_shifted_windows_ref(x, t_off, step, osr):
    """Per-symbol windows with the reference's timing-shift clamps
    (phy.cpp:209-216): symbol s reads from s*step + t_off unless that
    window would leave the buffer, in which case it reads from s*step.
    Returns (S, step) full-rate windows and (S, step/osr) decimated ones."""
    count = x.shape[-1]
    rows = []
    for s in range(count // step):
        base = s * step
        if t_off > 0 and base + t_off + step <= count:
            base += t_off
        elif t_off < 0 and -t_off <= base:
            base += t_off
        rows.append(x[base:base + step])
    full = np.stack(rows)
    return full, full[:, ::osr]
