"""Overlap-save streaming detection across a device mesh.

Sequence-parallel analog for a DSP stream (SURVEY §5.7): a continuous IQ
stream is split into contiguous time blocks sharded over the mesh's ``sp``
axis.  Each device scans every symbol-aligned window that *starts* in its
block (deterministic ownership), which requires a halo of the next block's
leading samples — exchanged with a single ``ppermute`` between devices,
never through host memory.

The per-window work (dechirp -> DFT -> argmax) reuses the batched detector,
so the hot loop is identical to the single-chip path; the only collective
traffic is the halo (2 sync symbols worth of samples) and any small metric
reductions — which is why near-linear scaling is expected (BASELINE.md).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops.chirp import downchirp_ri
from ..ops.detect import detect_ri
from ..utils.config import LoraParams

__all__ = ["StreamScan", "stream_scan", "find_sync_starts",
           "find_packet_starts"]


class StreamScan(NamedTuple):
    """Per symbol-offset detection over the stream (leading axes preserved).

    ``index[w]``/``power[w]`` describe the window starting at sample
    ``w * step``."""

    index: jnp.ndarray
    power: jnp.ndarray
    power_avg: jnp.ndarray


def _scan_downchirp(params: LoraParams):
    """Down-chirp for the decimated scan grid: the full-rate base
    down-chirp sampled at the phase-0 decimation points.

    At osr > 1 the osr=1 down-chirp is NOT the conjugate of the decimated
    base up-chirp: the reference's genChirp phase at oversampled index
    m = i*osr carries a residual linear term pi*bs*i/(N*osr) from its
    m*(m+1) numerator (ops/chirp.py:63-91), so dechirping decimated
    windows with the osr=1 chirp leaves a -bs*(osr-1)/(2*osr)-bin tone
    offset — half a bin at bs=osr=2 — smearing every detection.  The
    decimated full-rate down-chirp cancels the phase exactly (wrap terms
    contribute whole turns on the phase-0 grid: W(i*osr) is a multiple of
    osr), leaving a pure integer-bin tone (sym*bs) mod n.  At osr == 1
    this IS downchirp_ri(sf, bs)."""
    dcr, dci = downchirp_ri(params.sf, params.bw_scale, params.osr)
    return dcr[::params.osr], dci[::params.osr]


def _stride_windows(ext, total: int, step: int, stride: int, n: int,
                    osr: int):
    """All stride-aligned decimated windows of ``ext`` — gather-free.

    Stride-aligned windows are regular: phase j (j in [0, step/stride))
    windows are a plain reshape of ``ext[j*stride:]``.  The phases are
    interleaved back so window w corresponds to start w*stride.  Output
    (..., W, n) where W = total // stride.
    """
    phases = step // stride
    windows = total // stride
    per = -(-windows // phases)       # step-aligned windows per phase
    need = (phases - 1) * stride + per * step
    if need > ext.shape[-1]:
        pad = [(0, 0)] * (ext.ndim - 1) + [(0, need - ext.shape[-1])]
        ext = jnp.pad(ext, pad)
    cols = []
    for j in range(phases):
        sl = lax.slice_in_dim(ext, j * stride, j * stride + per * step,
                              axis=-1)
        w = sl.reshape(sl.shape[:-1] + (per, n, osr))[..., 0]
        cols.append(w)
    # (..., per, phases, n) -> (..., W, n) with w = p*phases + j
    stacked = jnp.stack(cols, axis=-2)
    all_w = stacked.reshape(stacked.shape[:-3] + (per * phases, n))
    return all_w[..., :windows, :]


def _scan_block(iq_r, iq_i, halo_r, halo_i, params: LoraParams, stride: int):
    """Detect every stride-aligned window starting in [block]; windows whose
    tail crosses the block edge read from the halo."""
    n, osr, step = params.n, params.osr, params.step
    ext_r = jnp.concatenate([iq_r, halo_r], axis=-1)
    ext_i = jnp.concatenate([iq_i, halo_i], axis=-1)
    total = iq_r.shape[-1]
    zr = _stride_windows(ext_r, total, step, stride, n, osr)
    zi = _stride_windows(ext_i, total, step, stride, n, osr)
    dcr, dci = _scan_downchirp(params)
    dcr = jnp.asarray(dcr)
    dci = jnp.asarray(dci)
    fr = zr * dcr - zi * dci
    fi = zr * dci + zi * dcr
    det = detect_ri(fr, fi)
    return det.index, det.power, det.power_avg


def stream_scan(iq_r, iq_i, params: LoraParams, mesh: Mesh | None = None,
                axis: str = "sp", stride: int | None = None) -> StreamScan:
    """Dechirp-detect every ``stride``-aligned window of a continuous stream.

    ``stride`` defaults to a full symbol; a sub-symbol stride (e.g. step//2)
    finds packets at arbitrary half-symbol alignments — those windows cross
    block boundaries, which is exactly what the halo exchange covers.

    With a mesh, the time axis must divide evenly over ``axis``; each shard
    fetches a one-symbol halo from its right neighbour via ``ppermute`` and
    scans the windows *starting* in its block (deterministic ownership).
    Without a mesh, runs the identical computation single-device.
    """
    step = params.step
    if stride is None:
        stride = step
    total = iq_r.shape[-1]
    if total % stride != 0:
        raise ValueError(
            f"stream length {total} not a multiple of stride {stride}")

    if mesh is None:
        halo_r = jnp.zeros(iq_r.shape[:-1] + (step,), jnp.float32)
        idx, p, pav = _scan_block(iq_r, iq_i, halo_r, halo_r, params, stride)
        return StreamScan(idx, p, pav)

    n_shards = mesh.shape[axis]
    if (total // stride) % n_shards != 0:
        raise ValueError(
            f"{total // stride} windows not divisible by {n_shards} shards")

    def block_fn(br, bi):
        # br: (..., block) local shard. Fetch right-neighbour's leading
        # `step` samples; the last shard gets zeros (end of stream).
        lead_r = lax.slice_in_dim(br, 0, step, axis=-1)
        lead_i = lax.slice_in_dim(bi, 0, step, axis=-1)
        perm = [(i, (i - 1) % n_shards) for i in range(n_shards)]
        halo_r = lax.ppermute(lead_r, axis, perm)
        halo_i = lax.ppermute(lead_i, axis, perm)
        my = lax.axis_index(axis)
        is_last = (my == n_shards - 1)
        halo_r = jnp.where(is_last, jnp.zeros_like(halo_r), halo_r)
        halo_i = jnp.where(is_last, jnp.zeros_like(halo_i), halo_i)
        idx, p, pav = _scan_block(br, bi, halo_r, halo_i, params, stride)
        return idx, p, pav

    spec_in = P(*([None] * (iq_r.ndim - 1) + [axis]))
    spec_out = P(*([None] * (iq_r.ndim - 1) + [axis]))
    fn = shard_map(block_fn, mesh=mesh, in_specs=(spec_in, spec_in),
                   out_specs=(spec_out, spec_out, spec_out))
    idx, p, pav = fn(iq_r, iq_i)
    return StreamScan(idx, p, pav)


def find_sync_starts(scan: StreamScan, params: LoraParams,
                     power_gate_db: float = 10.0,
                     stride: int | None = None,
                     noise_floor_db: float = -200.0) -> jnp.ndarray:
    """Boolean mask of windows that look like the start of a packet's sync
    prelude: two sync-symbol detections one symbol apart matching the
    configured sync-word nibbles, with fundamental power above the noise
    floor by ``power_gate_db``.  ``stride`` must match the stream_scan call
    (default: one symbol).

    Both power and noise floor are clamped to ``noise_floor_db`` before the
    gate: dead windows (all-zero samples, e.g. the zero halo past the end of
    the stream) produce ``20*log10(0) = -inf`` on both sides, which would
    otherwise make the SNR test NaN/True for noise-free garbage; clamped,
    a dead window scores 0 dB SNR and never passes the gate."""
    step = params.step
    if stride is None:
        stride = step
    hop = step // stride  # windows per symbol
    sw0, sw1 = params.sync_nibble_symbols()
    bs = params.bw_scale
    n = params.n
    idx = scan.index
    p = jnp.maximum(scan.power, noise_floor_db)
    pav = jnp.maximum(scan.power_avg, noise_floor_db)
    strong = (p - pav) > power_gate_db
    m0 = (idx == (sw0 * bs) % n) & strong
    m1 = (idx == (sw1 * bs) % n) & strong
    nxt = jnp.concatenate(
        [m1[..., hop:], jnp.zeros(m1.shape[:-1] + (hop,), bool)], axis=-1)
    return m0 & nxt


def find_packet_starts(scan: StreamScan, params: LoraParams,
                       stride: int | None = None,
                       power_gate_db: float = 3.0,
                       noise_floor_db: float = -200.0,
                       dedupe_tol: int = 2,
                       max_mis: int | None = None):
    """Sync detection for packets at *arbitrary* sample offsets.

    A chirp misaligned by ``d`` samples dechirps to a tone shifted by ``d``
    bins, so exact-bin matching (``find_sync_starts``) only sees aligned
    packets.  Here the signature is the *bin difference* of the two
    consecutive sync symbols — invariant to the shared misalignment — and
    the misalignment itself is then read off the first sync bin, giving a
    sample-accurate corrected start for every packet:

        d    = signed_mod(idx - sw0*bs, n) / bs        (bins)
        start = window_pos - d * osr                    (samples)

    A window misaligned by ``d`` has d corrupt samples.  Where they are
    noise its tone SNR is ~20*log10((n-d)/sqrt(d*n)) dB, about 8 dB at
    d = n/8; the second sync window's corrupt samples are the tail of the
    first sync chirp, whose leakage leaves it at ~5 dB there (4.98 dB
    measured at sf7, d = 14).  Pure-noise windows sit near -14 dB.  The
    default stride (step/4) bounds d at n/8, and the default 3 dB gate
    keeps ~2 dB of margin at that worst case (a 5 dB gate missed 12 of 384
    random-offset sf7 packets).
    Windows adjacent to a true start flag with the same corrected
    position; consecutive duplicates (within ``dedupe_tol`` samples) keep
    only the first.  Exact for bw_scale == 1; for
    bw_scale > 1 at osr == 1 the bin map is non-injective (the reference's
    own BW-250/500 round-trip defect, SURVEY §4.4.2) and recovery needs
    osr == bw_scale.

    ``max_mis`` (samples) drops flags whose measured misalignment exceeds
    it.  At bw_scale > 1 the bin residue is only unambiguous within
    +-n*osr/(2*bs) samples: a window further than that from a true start
    can pass the gate (large-SF processing gain) yet alias its corrected
    position by a whole period, creating a duplicate recovery at a shifted
    start.  A true start's *nearest* window sits within stride/2, so the
    wide streaming receiver passes ``max_mis ~ stride/2 + slack`` — alias
    windows reporting a small residue lie near a full period of true
    misalignment, where the sync tone has decayed below the power gate.

    Returns:
      (keep, start): boolean mask over windows and int32 corrected start
      positions in samples (valid where ``keep``).
    """
    step = params.step
    if stride is None:
        stride = max(step // 4, 1)
    hop = step // stride
    sw0, sw1 = params.sync_nibble_symbols()
    bs = params.bw_scale
    n = params.n
    idx = scan.index
    p = jnp.maximum(scan.power, noise_floor_db)
    pav = jnp.maximum(scan.power_avg, noise_floor_db)
    strong = (p - pav) > power_gate_db

    def shift_back(x, k):
        pad = jnp.zeros(x.shape[:-1] + (k,), x.dtype)
        return jnp.concatenate([x[..., k:], pad], axis=-1)

    idx_next = shift_back(idx, hop)
    want_diff = ((sw1 - sw0) * bs) % n
    diff = (idx_next - idx) % n
    flagged = strong & shift_back(strong, hop) & (diff == want_diff)

    # misalignment from the first sync bin, as a signed mod-n residue;
    # a decimated-grid chirp shifts bs/osr bins per oversampled sample,
    # so d = d_bins * osr / bs — multiply BEFORE the floor division so
    # the correction is sample-exact whenever bs divides osr * d_bins
    # (all bw125 cases and the osr == bw_scale wide configs)
    d_bins = (idx - (sw0 * bs)) % n
    d_signed = jnp.where(d_bins > n // 2, d_bins - n, d_bins)
    d_samples = (d_signed * params.osr) // bs
    if max_mis is not None:
        flagged = flagged & (jnp.abs(d_samples) <= max_mis)
    w = jnp.arange(idx.shape[-1], dtype=jnp.int32) * stride
    start = w - d_samples

    # drop duplicate flags of the same packet at the neighbouring window
    prev_flag = jnp.concatenate(
        [jnp.zeros(flagged.shape[:-1] + (1,), bool), flagged[..., :-1]],
        axis=-1)
    prev_start = jnp.concatenate(
        [jnp.zeros(start.shape[:-1] + (1,), jnp.int32), start[..., :-1]],
        axis=-1)
    dup = prev_flag & (jnp.abs(start - prev_start) <= dedupe_tol)
    keep = flagged & ~dup
    return keep, start
