#!/usr/bin/env python3
"""Benchmark: packets/s through the reference perf pipeline, on a GPU.

Mirrors tests/performance_test.cpp:112-125 — per packet: modulate +
dechirp multiply + tones-path demodulate (32-byte payload, 64 data + 2
sync symbols) — batched over thousands of packets and iterated on the
device via ``lax.fori_loop``, so per-call dispatch and synchronisation are
amortized over the whole run.

Prints ONE JSON line:

    {"metric": "packets_per_sec_sf7", "value": N, "unit": "pps",
     "vs_baseline": N / 4036.5, "device": {...}, "card": "..."}

Baseline: 4036.5 pps, the reference binary measured on a 2-vCPU Xeon
(BASELINE.md).  Per-profile rows with samples/s/card, detection TFLOP/s
and roofline share go to stderr, each naming the card and its power
limit; a CSV compatible with scripts/compare_perf.py (ns/symbol in the
cycles column) is written to logs/performance_<RUN_ID>.csv.

Also measured per profile (secondary rails): the full-RX ``demodulate``
path and the overlap-save ``stream_scan`` throughput, plus a check that
the tones path detects the same symbols on the card as on the CPU backend.
A run that finds no GPU, or a GPU missing from the peak table, fails.

Flags:
  --profile      capture a jax.profiler trace of one sf7 step to
                 logs/trace/ (jax.profiler.ProfileData reads it)
  --quick        headline profile only (sf7_bw125_cr45)

Exits non-zero when more than one profile fails or the headline profile
is missing, so the metric cannot silently shrink to a subset.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import lora_sdr_lightweight_standalone_library_clean as L
from lora_sdr_lightweight_standalone_library_clean.parallel.streaming import (
    stream_scan, find_packet_starts)
from lora_sdr_lightweight_standalone_library_clean.parallel.mesh import (
    make_mesh, shard_packets)
from lora_sdr_lightweight_standalone_library_clean.ops.dft import (
    FACTOR_THRESHOLD, dft_factors)

BASELINE_PPS = {
    "sf7_bw125_cr45": 4036.5,
    "sf7_bw125_cr47": 3879.9,
    "sf8_bw125_cr45": 2245.2,
    "sf9_bw250_cr48": 1007.4,
    "sf10_bw250_cr47": 496.5,
    "sf11_bw500_cr45": 231.4,
    "sf12_bw500_cr45": 121.0,
}

PAYLOAD_SIZE = 32
SYMS = PAYLOAD_SIZE * 2 + 2          # data + sync symbols per packet
# Published peaks by JAX device_kind.  Source: NVIDIA H100 Tensor Core GPU
# data sheet, SXM5 part, dense rates at the 700 W limit.  The DFT matmuls
# run at HIGHEST precision, i.e. plain float32, so f32_flops is their peak.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "f32_flops": 67e12, "tf32_flops": 495e12},
}


def card_name() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.splitlines()[0].strip()


def detection_flops(n: int, symbols: int) -> int:
    """FLOPs of the per-symbol detection DFT (the dominant compute):
    8*N^2 per symbol dense, 8*N*(n1+n2) four-step (ops/dft.py)."""
    if n <= FACTOR_THRESHOLD:
        per = 8 * n * n
    else:
        n1, n2 = dft_factors(n)
        per = 8 * n * (n1 + n2)
    return symbols * per


def make_loop(params: L.LoraParams):
    """Device-side loop: each iteration feeds the previous iteration's
    detected symbols back into modulate, a genuine sequential dependency
    XLA cannot elide, with zero host round-trips inside.  ``iters`` is a
    dynamic argument (lax.fori_loop lowers to a while op) so the same
    executable serves the short and long timing runs."""

    @jax.jit
    def loop(symbols, iters):
        def body(_, syms):
            # modulate -> external dechirp
            dr, di = L.modulate_dechirped(syms, params)
            res = L.demodulate_tones(dr, di, params)
            return res.symbols.astype(syms.dtype)
        out = lax.fori_loop(0, iters, body, symbols)
        return jnp.sum(out.astype(jnp.int32))

    return loop


def make_full_rx_loop(params: L.LoraParams):
    """Same but through the dechirping full-RX ``demodulate`` path
    (phy.cpp:182-243)."""

    @jax.jit
    def loop(symbols, iters):
        def body(_, syms):
            re, im = L.modulate(syms, params)
            res = L.demodulate(re, im, params)
            # the offset estimator locks to the sync bins, shifting every
            # detection by a constant; feed raw detections back masked to
            # codeword range to keep the chain data-dependent
            return (res.symbols & 0xFF).astype(syms.dtype)
        out = lax.fori_loop(0, iters, body, symbols)
        return jnp.sum(out.astype(jnp.int32))

    return loop


def make_e2e_loop(params: L.LoraParams):
    """Full user-visible chain per iteration: encode -> modulate(+dechirp)
    -> demodulate -> decode (payload AND crc verdict consumed) — the
    end-to-end throughput a user of the library actually gets (the
    headline excludes the codec, like the reference pipeline does)."""

    @jax.jit
    def loop(payload, iters):
        def body(_, p):
            syms = L.encode(p)
            dr, di = L.modulate_dechirped(syms, params)
            res = L.demodulate_tones(dr, di, params)
            out, crc_ok = L.decode(res.symbols)
            # crc_ok folded in via a data-dependent zero so the CRC
            # matmul cannot be dead-code-eliminated
            eps = (jnp.sum(crc_ok.astype(jnp.float32)) * 1e-30)
            return out + eps.astype(out.dtype)
        out = lax.fori_loop(0, iters, body, payload)
        return jnp.sum(out.astype(jnp.int32))

    return loop


def slope_time(loop, args, iters_short: int = 4, target: float = 1.0,
               iters_cap: int = 2048) -> float:
    """Per-iteration device time via a two-point slope.

    Each call pays a constant dispatch and synchronisation cost besides
    the device work; timing a short and a long loop and taking the slope
    cancels that constant.  ``loop(args..., iters)`` must accept a dynamic
    count."""
    int(loop(*args, iters_short))             # compile + warm
    t0 = time.perf_counter()
    int(loop(*args, iters_short))
    wall_short = time.perf_counter() - t0
    iters = int(min(iters_cap,
                    max(iters_short * 2,
                        iters_short * target / max(wall_short, 1e-6))))
    int(loop(*args, iters))
    t0 = time.perf_counter()
    int(loop(*args, iters))
    wall_long = time.perf_counter() - t0
    return (wall_long - wall_short) / (iters - iters_short)


def bench_profile(profile: dict, batch: int):
    """Packets/s through the device-looped pipeline + secondary rails."""
    params = L.params_from_profile(profile)
    payloads = np.tile(np.arange(PAYLOAD_SIZE, dtype=np.uint8), (batch, 1))
    symbols = jnp.asarray(np.asarray(L.encode(payloads)))

    dt = slope_time(make_loop(params), (symbols,))
    pps = batch / dt
    full_dt = slope_time(make_full_rx_loop(params), (symbols,))
    full_pps = batch / full_dt
    e2e_dt = slope_time(make_e2e_loop(params), (jnp.asarray(payloads),))
    e2e_pps = batch / e2e_dt
    return pps, full_pps, e2e_pps, dt


def make_wide_loop(params: L.LoraParams):
    """Device loop through the injective wide receiver (modulate + dechirp
    + demodulate_wide) — the BW-250/500 capability the reference lacks."""

    @jax.jit
    def loop(symbols, iters):
        def body(_, syms):
            dr, di = L.modulate_dechirped(syms, params)
            res = L.demodulate_wide(dr, di, params)
            return res.symbols.astype(syms.dtype)
        out = lax.fori_loop(0, iters, body, symbols)
        return jnp.sum(out.astype(jnp.int32))

    return loop


WIDE_PROFILES = (
    {"name": "sf9_bw250_osr2_wide", "sf": 9, "bw": 250000, "cr": "4/8",
     "osr": 2, "base": "sf9_bw250_cr48"},
    {"name": "sf12_bw500_osr4_wide", "sf": 12, "bw": 500000, "cr": "4/5",
     "osr": 4, "base": "sf12_bw500_cr45"},
)


def bench_wide(profile: dict, batch: int):
    """pps + ns/sym of a wide profile (osr = bw_scale full-rate RX)."""
    params = L.params_from_profile(profile, osr=profile["osr"])
    rng = np.random.default_rng(3)
    symbols = jnp.asarray(
        rng.integers(0, params.n, (batch, PAYLOAD_SIZE * 2)).astype(np.uint16))
    dt = slope_time(make_wide_loop(params), (symbols,))
    return batch / dt, dt


def _stage_loops(params: L.LoraParams):
    """Single-stage device loops for the per-stage time breakdown.  Each
    body keeps a data dependency on the previous iteration so XLA cannot
    hoist the stage out of the fori_loop."""
    rng = np.random.default_rng(0)
    payloads = rng.integers(0, 256, (1, PAYLOAD_SIZE)).astype(np.uint8)
    syms0 = np.asarray(L.encode(payloads))

    def dep_int(x, val):
        # fold a 0-valued scalar derived from ``val`` into integer state
        return x + (jnp.sum(val[..., :1]) * 1e-30).astype(x.dtype)

    @jax.jit
    def mod_loop(syms, iters):
        def body(_, s):
            re, _ = L.modulate(s, params)
            return dep_int(s, re)
        return jnp.sum(lax.fori_loop(0, iters, body, syms))

    @jax.jit
    def dechirp_loop(re, im, iters):
        def body(_, c):
            dr, di = L.dechirp(re + c, im, params)
            return jnp.sum(dr[..., :1]) * 1e-30 + jnp.sum(di[..., :1]) * 0
        return lax.fori_loop(0, iters, body, jnp.float32(0))

    @jax.jit
    def estimate_loop(re, im, iters):
        step = params.step
        def body(_, c):
            est = L.estimate_offsets(re[..., :2 * step] + c,
                                     im[..., :2 * step], params)
            return jnp.sum(est.cfo) * 1e-30
        return lax.fori_loop(0, iters, body, jnp.float32(0))

    @jax.jit
    def rx_loop(dr, di, iters):
        def body(_, c):
            res = L.demodulate_tones(dr + c, di, params)
            return jnp.sum(res.symbols).astype(jnp.float32) * 1e-30
        return lax.fori_loop(0, iters, body, jnp.float32(0))

    @jax.jit
    def decode_loop(syms, iters):
        def body(_, s):
            payload, crc_ok = L.decode(s)
            # depend on BOTH outputs so the CRC matmul cannot be DCE'd
            return dep_int(dep_int(s, payload),
                           crc_ok.astype(jnp.float32)[..., None])
        return jnp.sum(lax.fori_loop(0, iters, body, syms))

    return syms0, mod_loop, dechirp_loop, estimate_loop, rx_loop, decode_loop


def bench_stages(profile: dict, batch: int):
    """Per-stage time breakdown of the packet pipeline.

    Stages: modulate / dechirp multiply / 2-symbol offset estimate /
    demodulate_tones (estimate + fused RX) / codec decode.  Times are per
    batch step; the sum approximates the combined loop (stages share HBM
    residency in the fused pipeline, so the whole is usually faster)."""
    params = L.params_from_profile(profile)
    syms0, mod_loop, dechirp_loop, est_loop, rx_loop, dec_loop = \
        _stage_loops(params)
    symbols = jnp.asarray(np.tile(syms0, (batch, 1)))
    re, im = L.modulate(symbols, params)
    dr, di = L.dechirp(re, im, params)

    out = {}
    out["modulate"] = slope_time(mod_loop, (symbols,))
    out["dechirp"] = slope_time(dechirp_loop, (re, im))
    out["estimate"] = slope_time(est_loop, (dr, di))
    out["demod_tones"] = slope_time(rx_loop, (dr, di))
    out["decode"] = slope_time(dec_loop, (symbols,))
    return out


def bench_stream(params: L.LoraParams, n_packets: int = 64,
                 tile: int = 16, stride_div: int = 4) -> float:
    """Msamples/s of the overlap-save stream scan at the deployment config:
    sub-symbol stride (step/4, the receive_stream default) + arbitrary-offset
    packet-start detection, timed with the two-point slope."""
    stride = max(params.step // stride_div, 1)
    payloads = np.tile(np.arange(4, dtype=np.uint8), (n_packets, 1))
    syms = L.encode(payloads)
    re, im = L.modulate(jnp.asarray(syms), params)
    sr = jnp.tile(re.reshape(-1), tile)
    si = jnp.tile(im.reshape(-1), tile)

    @jax.jit
    def loop(r, i, iters):
        def body(_, acc):
            # 1e-30 * acc never changes any f32 signal sample, but makes
            # each iteration's input data-dependent so XLA cannot hoist
            # the (otherwise loop-invariant) scan out of the while body
            eps = acc.astype(jnp.float32) * 1e-30
            scan = stream_scan(r + eps, i + eps, params, stride=stride)
            hits, _ = find_packet_starts(scan, params, stride=stride)
            return acc + jnp.sum(hits.astype(jnp.int32))
        return lax.fori_loop(0, iters, body, jnp.int32(0))

    dt = slope_time(loop, (sr, si), iters_short=8)
    return sr.shape[-1] / max(dt, 1e-9) / 1e6


def bench_stream_rx_wide(sf: int = 9, bw: int = 250000, osr: int = 2,
                         n_packets: int = 6, payload_bytes: int = 8) -> tuple:
    """Msamples/s of the END-TO-END wide streaming receiver: scan +
    candidate selection + extraction + demodulate_wide + decode on a
    continuous BW-250/500 stream — the deployment-shaped capability the
    reference cannot express at all (SURVEY §4.4.2).  Returns
    (Msamples/s, recovered, planted)."""
    from lora_sdr_lightweight_standalone_library_clean.parallel.receiver \
        import receive_stream, packet_samples
    params = L.LoraParams(sf=sf, bw=bw, osr=osr)
    psyms = payload_bytes * 2
    plen = packet_samples(params, psyms)
    gap = plen + params.step
    length = -((n_packets * gap + plen) // -4096) * 4096
    rng = np.random.default_rng(5)
    sr = rng.standard_normal(length).astype(np.float32) * 0.05
    si = rng.standard_normal(length).astype(np.float32) * 0.05
    payloads = rng.integers(0, 256, (n_packets, payload_bytes)).astype(np.uint8)
    re, im = L.modulate(jnp.asarray(np.asarray(L.encode(payloads))), params)
    re, im = np.asarray(re), np.asarray(im)
    for k in range(n_packets):
        g = 517 + k * gap
        sr[g:g + plen] += re[k]
        si[g:g + plen] += im[k]
    sr_j, si_j = jnp.asarray(sr), jnp.asarray(si)

    @jax.jit
    def loop(r, i, iters):
        def body(_, acc):
            eps = acc.astype(jnp.float32) * 1e-30
            pkts, _ = receive_stream(r + eps, i + eps, params,
                                     payload_symbols=psyms,
                                     max_packets=2 * n_packets)
            return acc + jnp.sum(pkts.valid.astype(jnp.int32))
        return lax.fori_loop(0, iters, body, jnp.int32(0))

    recovered = int(loop(sr_j, si_j, 1))
    dt = slope_time(loop, (sr_j, si_j), iters_short=4)
    return length / max(dt, 1e-9) / 1e6, recovered, n_packets


def bench_mesh(profile: dict, dp: int, iters: int = 6):
    """Per-card packet throughput at dp=1 and dp=N through the
    device-looped pipeline, with the batch sharded over a ('dp', 'sp')
    mesh.  The dp direction has no cross-device collectives
    (tests/test_distributed.py), so its scaling is bounded by per-card
    dispatch, not by interconnect traffic."""
    params = L.params_from_profile(profile)
    n = 1 << profile["sf"]
    results = {}
    for d in sorted({1, dp}):
        if d > len(jax.devices()):
            results[d] = None
            continue
        batch = max(256 // d, 32) * d
        mesh = make_mesh(n_devices=d, dp=d, sp=1)
        payloads = np.tile(np.arange(PAYLOAD_SIZE, dtype=np.uint8),
                           (batch, 1))
        symbols = shard_packets(jnp.asarray(np.asarray(L.encode(payloads))),
                                mesh)
        dt = slope_time(make_loop(params), (symbols,), iters_short=iters,
                        target=0.5)
        results[d] = batch / dt * SYMS * n * params.osr / d
    eff = None
    if results.get(1) and results.get(dp) and dp > 1:
        eff = results[dp] / results[1]
    return results, eff


def bench_mesh_sp(sp: int, iters: int = 6):
    """Per-card throughput of the sp-sharded overlap-save stream scan
    against the same scan on one card.  This is the only path with a
    collective: each shard fetches its right neighbour's leading symbol
    with a ``ppermute`` halo exchange (parallel/streaming.py)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    params = L.params_from_profile(L.STOCK_PROFILES[0])
    stride = params.step                   # symbol-aligned scan grid
    windows = 512 * sp                     # divides evenly over shards
    length = windows * stride
    rng = np.random.default_rng(2)
    sr = jnp.asarray(rng.standard_normal(length).astype(np.float32))
    si = jnp.asarray(rng.standard_normal(length).astype(np.float32))
    results = {}
    for d in sorted({1, sp}):
        if d > len(jax.devices()):
            results[d] = None
            continue
        if d == 1:
            mesh = None
            r, i = sr, si
        else:
            mesh = make_mesh(n_devices=d, dp=1, sp=d)
            shard = NamedSharding(mesh, P("sp"))
            r = jax.device_put(sr, shard)
            i = jax.device_put(si, shard)

        @jax.jit
        def loop(r, i, iters, mesh=mesh):
            def body(_, acc):
                eps = acc.astype(jnp.float32) * 1e-30
                scan = stream_scan(r + eps, i + eps, params, mesh=mesh,
                                   stride=stride)
                return acc + jnp.sum(scan.index)
            return lax.fori_loop(0, iters, body, jnp.int32(0))

        dt = slope_time(loop, (r, i), iters_short=iters, target=0.5)
        results[d] = length / dt / d
    eff = None
    if results.get(1) and results.get(sp) and sp > 1:
        eff = results[sp] / results[1]
    return results, eff


def cpu_parity(profile: dict, batch: int = 256) -> str:
    """The tones chain on the card against the same function on the CPU
    backend: detected symbols and sync words must be identical."""
    params = L.params_from_profile(profile)
    rng = np.random.default_rng(1)
    payloads = rng.integers(0, 256, (batch, PAYLOAD_SIZE)).astype(np.uint8)

    def chain(pl):
        dr, di = L.modulate_dechirped(L.encode(pl), params)
        res = L.demodulate_tones(dr, di, params)
        return res.symbols, res.sync_word

    want = jax.jit(chain)(jax.device_put(payloads, jax.devices("cpu")[0]))
    got = jax.jit(chain)(jax.device_put(payloads, jax.devices()[0]))
    bad = sum(int(np.sum(np.asarray(g) != np.asarray(w)))
              for g, w in zip(got, want))
    return "OK" if not bad else f"MISMATCH({bad})"


def run_mesh(spec: str, run_id: str, card: str):
    axis, _, val = spec.partition("=")
    nd = int(val)
    if axis == "sp":
        res, eff = bench_mesh_sp(nd)
    else:
        res, eff = bench_mesh(L.STOCK_PROFILES[0], nd)
    for d, sps in sorted(res.items()):
        if sps:
            print(f"mesh {axis}={d}: {sps / 1e6:,.0f} Msamples/s/card | "
                  f"{card}", file=sys.stderr)
    if eff is not None:
        print(f"per-card scaling {axis}={nd} vs {axis}=1: {eff * 100:.1f}% "
              f"(target >= 80%, BASELINE.md) | {card}", file=sys.stderr)
    os.makedirs("logs", exist_ok=True)
    with open(f"logs/scaling_{run_id}_{axis}{nd}.json", "w") as f:
        json.dump({axis: nd, "card": card,
                   "collectives": ("ppermute halo exchange"
                                   if axis == "sp" else "none"),
                   "samples_per_sec_per_card":
                   {str(k): v for k, v in res.items()},
                   "efficiency": eff}, f)
    return axis, nd, eff


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="capture a profiler trace of one sf7 step")
    ap.add_argument("--quick", action="store_true",
                    help="headline profile only")
    ap.add_argument("--stages", action="store_true",
                    help="per-stage time breakdown (sf7 + sf12) to stderr")
    ap.add_argument("--mesh", default=None, metavar="dp=N",
                    help="also run a multi-card scaling rail: --mesh dp=4 "
                         "(packet data-parallel, collective-free) or "
                         "--mesh sp=4 (sp-sharded stream scan with its "
                         "ppermute halo exchange); needs N cards")
    ap.add_argument("--mesh-only", action="store_true",
                    help="run ONLY the --mesh scaling rail")
    args = ap.parse_args()

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"bench: no GPU found (JAX platform "
                 f"{devices[0].platform!r})")
    kind = devices[0].device_kind
    if kind not in PEAKS:
        sys.exit(f"bench: no published peaks for device_kind {kind!r}; "
                 f"add it to PEAKS with its source")
    peaks = PEAKS[kind]
    card = card_name()
    device = {"platform": devices[0].platform, "kind": kind,
              "count": len(devices)}

    run_id = os.environ.get("RUN_ID", "run")
    # batch sized so each profile's IQ working set stays comfortable in HBM
    batches = {7: 8192, 8: 4096, 9: 2048, 10: 1024, 11: 512, 12: 256}
    profiles = L.STOCK_PROFILES
    if args.quick:
        profiles = [p for p in profiles if p["name"] == "sf7_bw125_cr45"]

    if args.mesh_only:
        axis, nd, eff = run_mesh(args.mesh or f"dp={len(devices)}", run_id,
                                 card)
        rec = {"metric": f"scaling_efficiency_{axis}{nd}",
               "value": round(eff or 0.0, 4), "unit": "ratio (per card)",
               "vs_baseline": round((eff or 0.0) / 0.8, 2),
               "device": device, "card": card}
        print(json.dumps(rec))
        return

    results = {}
    failures = []
    for profile in profiles:
        name = profile["name"]
        try:
            pps, full_pps, e2e_pps, dt = bench_profile(
                profile, batches[profile["sf"]])
        except Exception as e:  # keep the headline metric alive
            print(f"{name}: FAILED {type(e).__name__}: {e} | {card}",
                  file=sys.stderr)
            failures.append(name)
            continue
        parity = cpu_parity(profile)
        params = L.params_from_profile(profile)
        n = params.n
        batch = batches[profile["sf"]]
        sps = pps * SYMS * n * params.osr
        fl = detection_flops(n, SYMS) * batch
        tf = fl / dt / 1e12
        # each iteration writes the dechirped planes and reads them back
        nbytes = 4 * batch * SYMS * params.step * 4
        bounds = {"f32 compute": fl / peaks["f32_flops"],
                  "HBM": nbytes / peaks["hbm_bytes_per_s"]}
        bound = max(bounds, key=bounds.get)
        ns_sym = dt / (batch * SYMS) * 1e9
        results[name] = dict(pps=pps, full_pps=full_pps, e2e_pps=e2e_pps,
                             ns_sym=ns_sym, parity=parity)
        print(f"{name}: {pps:,.0f} pps ({pps / BASELINE_PPS[name]:,.1f}x "
              f"baseline) | e2e {e2e_pps:,.0f} pps | "
              f"full-rx {full_pps:,.0f} pps | "
              f"{sps / 1e6:,.0f} Msamp/s/card | detect {tf:.2f} TF/s | "
              f"roofline {bounds[bound] / dt * 100:.1f}% ({bound}-bound) | "
              f"{ns_sym:,.0f} ns/sym | cpu-parity {parity} | {card}",
              file=sys.stderr)

    # wide-receiver rail: BW-250/500 at osr = bw_scale (the capability the
    # reference cannot express; they process osr x the samples of osr1)
    wide_rows = {}
    if not args.quick:
        for wp in WIDE_PROFILES:
            try:
                wbatch = max(batches[wp["sf"]] // (2 * wp["osr"]), 16)
                wpps, wdt = bench_wide(wp, wbatch)
                ns_sym = wdt / (wbatch * SYMS) * 1e9
                base = results.get(wp["base"], {})
                rel = (f" ({ns_sym / base['ns_sym']:.1f}x osr1 ns/sym)"
                       if base else "")
                wide_rows[wp["name"]] = dict(sf=wp["sf"],
                                             n=(1 << wp["sf"]) * wp["osr"],
                                             pps=wpps, ns_sym=ns_sym)
                print(f"{wp['name']}: {wpps:,.0f} pps | {ns_sym:,.0f} "
                      f"ns/sym{rel} | {card}", file=sys.stderr)
            except Exception as e:
                print(f"{wp['name']}: FAILED {type(e).__name__}: {e} | "
                      f"{card}", file=sys.stderr)

    if args.stages:
        for prof in (profiles[0], profiles[-1]):
            try:
                st = bench_stages(prof, batches[prof["sf"]])
                total = sum(st.values())
                row = " | ".join(
                    f"{k} {v * 1e3:.2f} ms ({v / total * 100:.0f}%)"
                    for k, v in st.items())
                print(f"stages {prof['name']} (batch "
                      f"{batches[prof['sf']]}): {row} | {card}",
                      file=sys.stderr)
            except Exception as e:
                print(f"stages {prof['name']}: FAILED "
                      f"{type(e).__name__}: {e} | {card}", file=sys.stderr)

    # wide streaming-RX rail: end-to-end BW-250 stream -> payloads
    stream_rows = {}
    if not args.quick:
        try:
            wsps, rec, planted = bench_stream_rx_wide()
            stream_rows["stream_rx_wide_sf9_msps"] = dict(sf=9, pps=wsps)
            stream_rows["stream_rx_wide_sf9_recovered"] = dict(sf=9, pps=rec)
            print(f"stream_rx_wide sf9_bw250_osr2: {wsps:,.0f} Msamples/s "
                  f"end-to-end ({rec}/{planted} packets recovered) | {card}",
                  file=sys.stderr)
        except Exception as e:
            print(f"stream_rx_wide: FAILED {type(e).__name__}: {e} | {card}",
                  file=sys.stderr)

    # stream-scan rail at the deployment stride (step/4)
    try:
        p0 = L.params_from_profile(profiles[0])
        s7 = bench_stream(p0)
        stream_rows["stream_scan_sf7"] = dict(sf=7, pps=s7)
        row = f"stream_scan sf7 stride/4: {s7:,.0f} Msamples/s"
        if not args.quick:
            p12 = L.params_from_profile(profiles[-1])
            s12 = bench_stream(p12, n_packets=8, tile=4)
            stream_rows["stream_scan_sf12"] = dict(sf=12, pps=s12)
            row += f" | sf12: {s12:,.0f} Msamples/s"
        print(f"{row} | {card}", file=sys.stderr)
    except Exception as e:
        print(f"stream_scan: FAILED {type(e).__name__}: {e} | {card}",
              file=sys.stderr)

    if args.mesh:
        run_mesh(args.mesh, run_id, card)

    if args.profile:
        os.makedirs("logs/trace", exist_ok=True)
        params = L.params_from_profile(profiles[0])
        payloads = np.tile(np.arange(PAYLOAD_SIZE, dtype=np.uint8),
                           (batches[7], 1))
        symbols = jnp.asarray(np.asarray(L.encode(payloads)))
        loop = make_loop(params)
        int(loop(symbols, 2))
        with jax.profiler.trace("logs/trace"):
            int(loop(symbols, 2))
        print(f"profiler trace written to logs/trace/ | {card}",
              file=sys.stderr)

    os.makedirs("logs", exist_ok=True)
    with open(f"logs/performance_{run_id}.csv", "w") as f:
        f.write("run_id,profile,sf,N,pps,cycles_per_symbol\n")
        for profile in profiles:
            name = profile["name"]
            if name in results:
                r = results[name]
                f.write(f"{run_id},{name},{profile['sf']},"
                        f"{1 << profile['sf']},{r['pps']:.1f},"
                        f"{r['ns_sym']:.1f}\n")
                # the e2e chain rides the same schema with its own ns/sym
                e2e_ns = 1e9 / (r['e2e_pps'] * SYMS)
                f.write(f"{run_id},{name}_e2e,{profile['sf']},"
                        f"{1 << profile['sf']},{r['e2e_pps']:.1f},"
                        f"{e2e_ns:.1f}\n")
        for name, r in wide_rows.items():
            f.write(f"{run_id},{name},{r['sf']},{r['n']},"
                    f"{r['pps']:.1f},{r['ns_sym']:.1f}\n")
        for name, r in stream_rows.items():
            f.write(f"{run_id},{name},{r['sf']},{1 << r['sf']},"
                    f"{r['pps']:.4f},\n")

    headline = results.get("sf7_bw125_cr45", {}).get("pps", 0.0)
    print(json.dumps({
        "metric": "packets_per_sec_sf7",
        "value": round(headline, 1),
        "unit": "pps",
        "vs_baseline": round(headline / BASELINE_PPS["sf7_bw125_cr45"], 2),
        "device": device,
        "card": card,
    }))
    bad_parity = [n for n, r in results.items() if r["parity"] != "OK"]
    if len(failures) > 1 or not headline:
        print(f"bench: {len(failures)} profiles failed: {failures}",
              file=sys.stderr)
        sys.exit(1)
    if bad_parity:
        print(f"bench: card vs CPU parity failed: {bad_parity}",
              file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
