#!/usr/bin/env python3
"""Smoke test of the LoRa PHY main path on a GPU.

Run from the repository root, in one process per machine:

    python3 chip_smoke.py [--seed N]      # one card: phases (a)-(d)
    python3 chip_smoke.py --cards 4       # four cards: the mesh paths only

One card:
  (a) packet pipeline, all seven stock profiles at the benchmark's batches
      (8192 packets at sf7 down to 256 at sf12, 32-byte CRC-framed
      payloads): encode -> modulate_dechirped -> demodulate_tones -> decode,
      and modulate -> channel (CFO + AWGN) -> demodulate / dechirp +
      demodulate_tones -> decode.  Payloads, CRCs and sync words must come
      back (at bw_scale > 1 the decimating tones path maps each symbol to
      bin sym*bw_scale mod N, the reference's own behaviour, PARITY.md
      defect 2, which is checked instead), and the symbols of the first 256
      packets must equal those of the same function on the CPU backend;
  (b) golden parity: every tests/vectors/ref_*.npz through demodulate and
      estimate_offsets on the card, at the CPU suite's tolerances;
  (c) the wide receiver, demodulate_wide, for sf9/BW250@osr2 and
      sf12/BW500@osr4: payloads must round-trip;
  (d) streaming: receive_stream over a 2^22-sample capture in 4 chunks
      with 64 packets at random offsets plus AWGN (sf7, and sf9/BW250@osr2
      wide), every packet recovered; stream_scan at sf7 and sf12, stride
      step/4, over 2^24 samples against the complex128 np.fft reference;
      one runners.tx -> runners.stream_rx round trip through main(argv).

Four cards (--cards 4): dp=4 packet sharding at sf7 with 4 x 8192 packets,
and sp=4 stream_scan + receive_stream with ppermute halos over 2^24
samples, each compared with its one-card result.

Each phase prints its compile time, steady wall time (median of repeats,
ended by block_until_ready), peak_bytes_in_use and the card.  Any failed
check raises and the process exits non-zero before the last line, which is
one JSON object naming the device.  Where JAX finds no GPU the script
refuses to run.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from functools import partial
from pathlib import Path

import numpy as np

# the CPU reference runs in this same process
if os.environ.get("JAX_PLATFORMS") and \
        "cpu" not in os.environ["JAX_PLATFORMS"].split(","):
    os.environ["JAX_PLATFORMS"] += ",cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import lora_sdr_lightweight_standalone_library_clean as L  # noqa: E402
from lora_sdr_lightweight_standalone_library_clean.models.modem import (  # noqa: E402,E501
    crc_sx1272, window_table)
from lora_sdr_lightweight_standalone_library_clean.ops import channel  # noqa: E402,E501
from lora_sdr_lightweight_standalone_library_clean.parallel.mesh import (  # noqa: E402,E501
    make_mesh, shard_packets)
from lora_sdr_lightweight_standalone_library_clean.parallel.receiver import (  # noqa: E402,E501
    receive_stream, stream_rx_init, packet_samples)
from lora_sdr_lightweight_standalone_library_clean.parallel.streaming import (  # noqa: E402,E501
    stream_scan)
from lora_sdr_lightweight_standalone_library_clean.runners import (  # noqa: E402,E501
    stream_rx as stream_rx_cli, tx as tx_cli)

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "tests"))
import oracle  # noqa: E402  (numpy references shared with the tests)

BATCHES = {7: 8192, 8: 4096, 9: 2048, 10: 1024, 11: 512, 12: 256}
PAYLOAD_BYTES = 32
CPU_PACKETS = 256
WIDE = (("sf9_bw250_osr2", dict(sf=9, bw=250000, cr="4/8", osr=2), 512),
        ("sf12_bw500_osr4", dict(sf=12, bw=500000, cr="4/5", osr=4), 32))


class Smoke:
    """Timing, reporting and device bookkeeping shared by the phases."""

    def __init__(self, seed: int, card: str):
        self.rng = np.random.default_rng(seed)
        self.seed = seed
        self.card = card
        self.gpu = jax.devices()[0]
        self.cpu = jax.devices("cpu")[0]

    def run(self, label, fn, *args, repeats=5):
        """Compile ``fn`` for ``args``, run it ``repeats`` times, print the
        compile time, the median wall time and peak device memory, and
        return the last result."""
        t0 = time.perf_counter()
        compiled = jax.jit(fn).lower(*args).compile()
        compile_s = time.perf_counter() - t0
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = jax.block_until_ready(compiled(*args))
            times.append(time.perf_counter() - t0)
        self.report(label, compile_s, statistics.median(times))
        return out

    def report(self, label, compile_s, steady_s, extra=""):
        peak = (self.gpu.memory_stats() or {}).get("peak_bytes_in_use")
        print(f"{label}: compile {compile_s:.3f} s | steady {steady_s * 1e3:.3f}"
              f" ms | peak_bytes_in_use {peak}{extra} | {self.card}",
              flush=True)

    def on_cpu(self, fn, *args):
        """``fn`` on the CPU backend over host copies of ``args``."""
        return jax.jit(fn)(*jax.device_put(args, self.cpu))


def card_name() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.splitlines()[0].strip()


def result_line(devices) -> str:
    """The last line of a passing run."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def crc_payloads(rng, batch: int, nbytes: int = PAYLOAD_BYTES) -> np.ndarray:
    """Random payloads whose last two bytes are the CRC decode checks
    (over bytes 2..n-3, phy.cpp:252-259)."""
    body = rng.integers(0, 256, (batch, nbytes - 2)).astype(np.uint8)
    crc = np.asarray(crc_sx1272(jnp.asarray(body[:, 2:]))).astype(np.int64)
    return np.concatenate([body, (crc & 0xFF)[:, None], (crc >> 8)[:, None]],
                          axis=1).astype(np.uint8)


def expect_equal(what, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = (int(np.sum(got != want)) if got.shape == want.shape
               else f"shape {got.shape} vs {want.shape}")
        raise AssertionError(f"{what}: {bad} mismatches")


def check_decoded(what, p, payloads, syms, sync, dec, ok, wide=False):
    """Payload, CRC and sync word where the receiver is injective (bw_scale
    == 1, or the wide receiver); else the reference's sym*bw_scale mod N
    bin map of the decimating detector (PARITY.md defect 2)."""
    enc = np.asarray(L.encode(payloads)).astype(np.int64)
    if wide or p.bw_scale == 1:
        expect_equal(f"{what} payload", dec, payloads)
        expect_equal(f"{what} crc_ok", ok, np.ones(len(payloads), bool))
        expect_equal(f"{what} sync", sync, np.full(len(payloads), 0x12))
    else:
        expect_equal(f"{what} bins", syms, (enc * p.bw_scale) % p.n)
        sw = [((s * p.bw_scale) % p.n) >> (p.sf - 4) & 0xF
              for s in p.sync_nibble_symbols()]
        expect_equal(f"{what} sync", sync,
                     np.full(len(payloads), sw[0] << 4 | sw[1]))


def full_rx_spectrum(x, p, cfo, time_offset, s):
    """float64 |X|^2 / max of symbol window ``s`` of one full-RX packet
    ``x`` (complex), given its offset estimates: timing-shift clamps,
    down-chirp, CFO derotation and window of phy.cpp:206-229."""
    n, t = p.n, int(np.round(time_offset))
    _, win = oracle.timing_shifted_windows_ref(x, t, p.step, p.osr)
    m = np.arange(1, n + 1)
    z = win[s] * np.exp(1j * np.pi * p.bw_scale
                        * np.mod(m * n - m * (m + 1), 2 * n) / n)
    rate = -2.0 * np.pi * float(cfo) / n
    z = z * np.exp(1j * rate * (s * n + t / p.osr + np.arange(n)))
    w = window_table(n, p.window)
    mag2 = np.abs(np.fft.fft(z if w is None else z * w)) ** 2
    return mag2 / mag2.max()


def compare_full_rx(what, p, re, im, got, want, tol=1e-4):
    """demodulate on the card against the CPU backend, symbol for symbol.

    The full-RX path estimates offsets on the raw sync chirps (PARITY.md
    defect 1), so its windows can hold bins tied to float32 rounding: a
    differing detection passes only where float64 shows both picks within
    ``tol`` of the window's peak power, or where the timing estimate sits
    within ``tol`` of a rounding boundary.  Returns the count of such
    ties."""
    gs, gsync, _, gt = (np.asarray(a) for a in got)
    cs, csync, ccfo, ct = (np.asarray(a) for a in want)
    ties, unexplained = 0, []
    for b in np.nonzero((gs != cs).any(-1) | (gsync != csync))[0]:
        x = re[b].astype(np.float64) + 1j * im[b].astype(np.float64)
        if np.round(gt[b]) != np.round(ct[b]):
            if abs(abs(ct[b] - np.floor(ct[b])) - 0.5) < tol:
                ties += 1
            else:
                unexplained.append((int(b), "time_offset"))
            continue
        for s in np.nonzero(gs[b] != cs[b])[0]:
            r = full_rx_spectrum(x, p, ccfo[b], ct[b], s + 2)
            if min(r[gs[b, s]], r[cs[b, s]]) > 1 - tol:
                ties += 1
            else:
                unexplained.append((int(b), int(s)))
        if gsync[b] != csync[b]:
            if any(np.sort(full_rx_spectrum(x, p, ccfo[b], ct[b], s))[-2]
                   > 1 - tol for s in (0, 1)):
                ties += 1
            else:
                unexplained.append((int(b), "sync"))
    if unexplained:
        raise AssertionError(f"{what}: detections differ from the CPU "
                             f"without a float64 tie at {unexplained[:8]}")
    return ties


# ---------------------------------------------------------------------------
# (a) packet pipeline
# ---------------------------------------------------------------------------

def phase_packets(sm: Smoke, profiles=L.STOCK_PROFILES, batches=BATCHES,
                  cpu_packets=CPU_PACKETS):
    for prof in profiles:
        p = L.params_from_profile(prof)
        b = batches[p.sf]
        name = f"(a) {prof['name']} batch {b}"
        payloads = crc_payloads(sm.rng, b)

        def tones_chain(pl):
            dr, di = L.modulate_dechirped(L.encode(pl), p)
            res = L.demodulate_tones(dr, di, p)
            return (res.symbols, res.sync_word) + L.decode(res.symbols)

        out = sm.run(f"{name} tones chain", tones_chain,
                     jax.device_put(payloads, sm.gpu))
        check_decoded(f"{name} tones chain", p, payloads, *out)
        ref = sm.on_cpu(tones_chain, payloads[:cpu_packets])
        expect_equal(f"{name} tones chain vs cpu", out[0][:cpu_packets], ref[0])

        def channel_iq(pl, key):
            re, im = L.modulate(L.encode(pl), p)
            return channel.apply_channel(key, re, im, snr_db=10.0,
                                         cfo_bins=0.05, n_step=p.step)

        key = jax.random.PRNGKey(sm.seed)
        re, im = sm.run(f"{name} modulate+channel", channel_iq,
                        jax.device_put(payloads, sm.gpu), key, repeats=1)

        def full_rx(r, i):
            res = L.demodulate(r, i, p)
            return res.symbols, res.sync_word, res.cfo, res.time_offset

        out = sm.run(f"{name} demodulate", full_rx, re, im)
        if not all(np.isfinite(np.asarray(x)).all() for x in out[2:]):
            raise AssertionError(f"{name} demodulate: non-finite offsets")
        # the full-RX path cannot decode its own modulation (PARITY.md
        # defect 1): its detections are checked against the CPU here and
        # against the reference binary's fixtures in (b)
        host = (np.asarray(re[:cpu_packets]), np.asarray(im[:cpu_packets]))
        ref = sm.on_cpu(full_rx, *host)
        ties = compare_full_rx(f"{name} demodulate vs cpu", p, *host,
                               [a[:cpu_packets] for a in out], ref)
        print(f"{name} demodulate vs cpu: equal but for {ties} float64 "
              f"ties", flush=True)

        def channel_tones(r, i):
            res = L.demodulate_tones(*L.dechirp(r, i, p), p)
            return (res.symbols, res.sync_word) + L.decode(res.symbols)

        out = sm.run(f"{name} channel tones chain", channel_tones, re, im)
        check_decoded(f"{name} channel tones chain", p, payloads, *out)
        ref = sm.on_cpu(channel_tones, *host)
        expect_equal(f"{name} channel tones vs cpu", out[0][:cpu_packets],
                     ref[0])


# ---------------------------------------------------------------------------
# (b) golden parity against the reference binary's dumps
# ---------------------------------------------------------------------------

def phase_golden(sm: Smoke):
    vectors = REPO / "tests" / "vectors"
    fixtures = sorted(f for f in vectors.glob("ref_*.npz")
                      if not f.stem.startswith("ref_offsets"))
    offsets = sorted(vectors.glob("ref_offsets_*.npz"))
    if not fixtures or not offsets:
        raise AssertionError(f"no parity fixtures under {vectors}")
    for path in fixtures:
        d = np.load(path)
        p = L.LoraParams(sf=int(d["sf"]), bw=int(d["bw"]), osr=int(d["osr"]),
                         window=str(d["window"]))
        rr, ri = L.from_complex(d["iq"][None])
        syms = sm.run(f"(b) {path.stem} demodulate",
                      lambda r, i: L.demodulate(r, i, p).symbols,
                      *jax.device_put((rr, ri), sm.gpu), repeats=3)
        syms = np.asarray(syms)[0]
        expect_equal(f"(b) {path.stem} symbols", syms, d["demod"][:len(syms)])
    for path in offsets:
        d = np.load(path)
        p = L.LoraParams(sf=int(d["sf"]))
        rr, ri = jax.device_put(L.from_complex(d["iq"]), sm.gpu)

        def est_comp(r, i):
            est = L.estimate_offsets(r, i, p)
            return est, L.compensate_offsets(r, i, p, est)

        est, (cr, ci) = sm.run(f"(b) {path.stem} estimate_offsets", est_comp,
                               rr, ri, repeats=3)
        # the bounds of tests/test_parity.py: float32 estimator arithmetic
        # against the reference's own float32 run
        cfo_err = abs(float(est.cfo) - float(d["ref_cfo"]))
        t_err = abs(float(est.time_offset) - float(d["ref_time_offset"]))
        iq_err = float(np.max(np.abs(
            np.asarray(cr) + 1j * np.asarray(ci) - d["compensated"])))
        print(f"(b) {path.stem}: |cfo err| {cfo_err:.3e} (bound 2e-5) | "
              f"|t err| {t_err:.3e} (bound 1e-3) | max |iq err| "
              f"{iq_err:.3e} (bound 2e-4 per plane)", flush=True)
        if cfo_err >= 2e-5 or t_err >= 1e-3:
            raise AssertionError(f"(b) {path.stem}: offsets out of bounds")
        np.testing.assert_allclose(np.asarray(cr), d["compensated"].real,
                                   atol=2e-4)
        np.testing.assert_allclose(np.asarray(ci), d["compensated"].imag,
                                   atol=2e-4)


# ---------------------------------------------------------------------------
# (c) wide receiver
# ---------------------------------------------------------------------------

def phase_wide(sm: Smoke, wide=WIDE):
    for label, prof, b in wide:
        p = L.LoraParams(**prof)
        payloads = crc_payloads(sm.rng, b)

        def chain(pl):
            dr, di = L.modulate_dechirped(L.encode(pl), p)
            res = L.demodulate_wide(dr, di, p)
            return (res.symbols, res.sync_word) + L.decode(res.symbols)

        out = sm.run(f"(c) {label} batch {b} wide chain", chain,
                     jax.device_put(payloads, sm.gpu))
        check_decoded(f"(c) {label}", p, payloads, *out, wide=True)


# ---------------------------------------------------------------------------
# (d) streaming
# ---------------------------------------------------------------------------

def plant_stream(sm: Smoke, p, length, n_packets, payload_bytes=16,
                 noise=0.05):
    """A noisy capture with CRC-framed packets at random, non-overlapping
    sample offsets.  Returns (re, im, sorted offsets, payloads)."""
    plen = packet_samples(p, payload_bytes * 2)
    slack = length - n_packets * (plen + p.step) - p.step
    if slack < 0:
        raise ValueError("capture too short for the packets")
    cuts = np.sort(sm.rng.integers(0, slack, n_packets))
    offsets = cuts + np.arange(n_packets) * (plen + p.step) + 1
    payloads = crc_payloads(sm.rng, n_packets, payload_bytes)
    re, im = (np.asarray(a) for a in L.modulate(L.encode(payloads), p))
    sr = (sm.rng.standard_normal(length) * noise).astype(np.float32)
    si = (sm.rng.standard_normal(length) * noise).astype(np.float32)
    for k, g in enumerate(offsets):
        sr[g:g + plen] += re[k]
        si[g:g + plen] += im[k]
    return sr, si, offsets, payloads


def make_rx(p, payload_bytes, mesh=None, max_packets=64):
    """One jitted receive_stream, reused across passes so the timed pass
    does not trace again."""
    return jax.jit(partial(receive_stream, params=p,
                           payload_symbols=payload_bytes * 2,
                           max_packets=max_packets, mesh=mesh))


def receive_all(rx, p, sr, si, chunks, payload_bytes):
    """``rx`` over ``chunks`` equal chunks with carried state.  Returns the
    recovered (start, payload, crc_ok, sync) rows and the wall time of the
    chunk loop."""
    size = sr.shape[-1] // chunks
    state = stream_rx_init(p, payload_bytes * 2)
    rows, t0 = [], time.perf_counter()
    for c in range(chunks):
        sl = slice(c * size, (c + 1) * size)
        pkts, state = rx(sr[sl], si[sl], state=state)
        if int(pkts.n_dropped):
            raise AssertionError("receive_stream dropped owned packets")
        v = np.asarray(pkts.valid)
        rows += list(zip(np.asarray(pkts.start)[v].tolist(),
                         np.asarray(pkts.payload)[v].tolist(),
                         np.asarray(pkts.crc_ok)[v].tolist(),
                         np.asarray(pkts.sync_word)[v].tolist()))
    return rows, time.perf_counter() - t0


def check_recovered(what, rows, offsets, payloads, sync_word=0x12):
    got = sorted(rows)
    want = sorted((int(g), pl.tolist(), True, sync_word)
                  for g, pl in zip(offsets, payloads))
    if got != want:
        missing = {r[0] for r in want} - {r[0] for r in got}
        raise AssertionError(f"{what}: {len(got)} recovered of {len(want)}"
                             f" planted; starts missing {sorted(missing)}")


def compare_scans(what, got, want):
    """Argmax where the winning bin is clear of the runner-up; power and
    noise floor in dB (tolerances of tests/test_stream_scan.py)."""
    gi, gp, ga = (np.asarray(a) for a in got)
    idx, power, noise, ratio = want
    clear = ratio < 1.0 - 1e-3
    expect_equal(f"{what} index", gi[clear], idx[clear])
    np.testing.assert_allclose(gp, power, atol=1e-3, rtol=0)
    np.testing.assert_allclose(ga, noise, atol=5e-3, rtol=0)


def phase_stream(sm: Smoke, length=1 << 22, chunks=4, n_packets=64,
                 scan_length=1 << 24):
    for label, p in (("sf7", L.LoraParams(sf=7)),
                     ("sf9_bw250_osr2 wide",
                      L.LoraParams(sf=9, bw=250000, cr="4/8", osr=2))):
        sr, si, offsets, payloads = plant_stream(sm, p, length, n_packets)
        sr, si = jax.device_put((sr, si), sm.gpu)
        rx = make_rx(p, 16)
        t0 = time.perf_counter()
        rows, _ = receive_all(rx, p, sr, si, chunks, 16)  # compiles
        first = time.perf_counter() - t0
        rows, wall = receive_all(rx, p, sr, si, chunks, 16)
        sm.report(f"(d) receive_stream {label}: {length} samples, {chunks} "
                  f"chunks", first - wall, wall,
                  f" | {length / wall / 1e6:.3f} Msamples/s")
        check_recovered(f"(d) receive_stream {label}", rows, offsets,
                        payloads)

    for sf in (7, 12):
        p = L.LoraParams(sf=sf)
        stride = p.step // 4
        sr, si, _, _ = plant_stream(sm, p, scan_length, 8)
        got = sm.run(f"(d) stream_scan sf{sf} stride step/4: {scan_length} "
                     f"samples",
                     lambda r, i: stream_scan(r, i, p, stride=stride),
                     *jax.device_put((sr, si), sm.gpu))
        compare_scans(f"(d) stream_scan sf{sf}", got, oracle.stream_scan_ref(
            sr, si, sf, 1, p.bw_scale, stride))

    payload = bytes(sm.rng.integers(0, 256, 12, dtype=np.uint8)).hex().upper()
    with tempfile.TemporaryDirectory() as tmp:
        iq = os.path.join(tmp, "iq.f32")
        if tx_cli.main([f"--payload={payload}", "--sf=7", "--framed",
                        f"--out={iq}"]):
            raise AssertionError("(d) runners.tx failed")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = stream_rx_cli.main([f"--in={iq}", "--sf=7", "--framed",
                                     "--payload-bytes=16"])
    want = f"0 1 {payload} len=12 hdr_ok=1"
    if rc or out.getvalue().strip() != want:
        raise AssertionError(f"(d) runners.stream_rx printed "
                             f"{out.getvalue()!r}, want {want!r}")
    print(f"(d) runners.tx -> runners.stream_rx: {want}", flush=True)


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def phase_four_cards(sm: Smoke, batch=4 * 8192, scan_length=1 << 24,
                     n_packets=64):
    devices = jax.devices()[:4]
    p = L.LoraParams(sf=7)
    payloads = crc_payloads(sm.rng, batch)

    def tones_chain(pl):
        dr, di = L.modulate_dechirped(L.encode(pl), p)
        res = L.demodulate_tones(dr, di, p)
        return (res.symbols, res.sync_word) + L.decode(res.symbols)

    # uncommitted inputs on the default card: the one-card runs stay there,
    # the mesh runs reshard them
    dp_mesh = make_mesh(4, dp=4, sp=1, devices=devices)
    one = sm.run(f"dp=1 sf7 batch {batch} tones chain", tones_chain,
                 jnp.asarray(payloads))
    four = sm.run(f"dp=4 sf7 batch {batch} tones chain", tones_chain,
                  shard_packets(jnp.asarray(payloads), dp_mesh))
    check_decoded("dp=4 tones chain", p, payloads, *four)
    for k, what in enumerate(("symbols", "sync", "payload", "crc_ok")):
        expect_equal(f"dp=4 vs dp=1 {what}", four[k], one[k])

    sp_mesh = make_mesh(4, dp=1, sp=4, devices=devices)
    stride = p.step // 4
    sr, si, offsets, pls = plant_stream(sm, p, scan_length, n_packets)
    r1, i1 = jnp.asarray(sr), jnp.asarray(si)
    one = sm.run(f"sp=1 stream_scan sf7: {scan_length} samples",
                 lambda r, i: stream_scan(r, i, p, stride=stride), r1, i1)
    four = sm.run(f"sp=4 stream_scan sf7: {scan_length} samples",
                  lambda r, i: stream_scan(r, i, p, mesh=sp_mesh,
                                           stride=stride), r1, i1)
    ref = oracle.stream_scan_ref(sr, si, 7, 1, 1, stride)
    compare_scans("sp=1 stream_scan", one, ref)
    compare_scans("sp=4 stream_scan", four, ref)
    for mesh, label in ((None, "sp=1"), (sp_mesh, "sp=4")):
        rx = make_rx(p, 16, mesh=mesh)
        t0 = time.perf_counter()
        rows, _ = receive_all(rx, p, r1, i1, 4, 16)
        first = time.perf_counter() - t0
        rows, wall = receive_all(rx, p, r1, i1, 4, 16)
        sm.report(f"{label} receive_stream sf7: {scan_length} samples, 4 "
                  f"chunks", first - wall, wall,
                  f" | {scan_length / wall / 1e6:.3f} Msamples/s")
        check_recovered(f"{label} receive_stream", rows, offsets, pls)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of every generated input")
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the multi-card mesh paths")
    args = ap.parse_args(argv)
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform "
              f"{devices[0].platform!r})", file=sys.stderr)
        return 1
    if len(devices) < args.cards:
        print(f"chip_smoke: --cards {args.cards} needs {args.cards} GPUs, "
              f"found {len(devices)}", file=sys.stderr)
        return 1
    card = card_name()
    print(f"card: {card} | jax {jax.__version__} | {devices[0].device_kind}"
          f" x {len(devices)}", flush=True)
    sm = Smoke(args.seed, card)
    t0 = time.perf_counter()
    if args.cards == 4:
        phase_four_cards(sm)
        used = devices[:4]
    else:
        phase_packets(sm)
        phase_golden(sm)
        phase_wide(sm)
        phase_stream(sm)
        used = devices[:1]
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s | {card}",
          flush=True)
    print(result_line(used))
    return 0


if __name__ == "__main__":
    sys.exit(main())
