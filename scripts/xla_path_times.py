#!/usr/bin/env python3
"""Time the XLA-compiled hot-path stages on a GPU beside their HBM bound.

For each stage: the median wall time of one jitted call (ended by
block_until_ready), the bytes the stage must move (its inputs read once and
its outputs written once, computed from the shapes), and that traffic over
the H100's 3.35 TB/s (NVIDIA data sheet, SXM).  A large device copy is
timed in the same process as the bandwidth this card actually reaches.
Also times the DFT at HIGHEST against default matmul precision, and the two
osr == 1 TX synthesis paths.

    python scripts/xla_path_times.py          # needs a GPU; ~2 min
"""
from __future__ import annotations

import contextlib
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import lora_sdr_lightweight_standalone_library_clean as L  # noqa: E402
from lora_sdr_lightweight_standalone_library_clean.ops import dft  # noqa: E402
from lora_sdr_lightweight_standalone_library_clean.ops.chirp import (  # noqa: E402
    modulate_ri)
from lora_sdr_lightweight_standalone_library_clean.ops.detect import (  # noqa: E402
    detect_ri)
from lora_sdr_lightweight_standalone_library_clean.parallel.streaming import (  # noqa: E402,E501
    stream_scan)

HBM_BYTES_PER_S = 3.35e12
SYMS = 66                     # 32-byte payload: 64 data + 2 sync symbols
SIZES = ((7, 8192), (12, 256))


def median_time(fn, *args, repeats=20):
    f = jax.jit(fn)
    jax.block_until_ready(f(*args))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def row(name, seconds, nbytes):
    bound = nbytes / HBM_BYTES_PER_S
    print(f"{name}: {seconds * 1e3:.4f} ms | {nbytes} B | HBM bound "
          f"{bound * 1e3:.4f} ms | {bound / seconds * 100:.1f}% of bound",
          flush=True)


@contextlib.contextmanager
def default_dft_precision():
    """Trace the DFT matmuls at the default precision instead of HIGHEST."""
    saved = dft._mm
    dft._mm = lambda eq, a, b: jnp.einsum(eq, a, b)
    try:
        yield
    finally:
        dft._mm = saved


def main() -> int:
    if jax.devices()[0].platform != "gpu":
        print("xla_path_times: no GPU found", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.splitlines()[0].strip()
    print(f"card: {card} | jax {jax.__version__}", flush=True)
    rng = np.random.default_rng(0)

    big = jnp.zeros(1 << 28, jnp.float32)               # 1 GiB
    row("copy 1 GiB (x + 1)", median_time(lambda x: x + 1, big), 2 * big.nbytes)
    del big

    for sf, batch in SIZES:
        p = L.LoraParams(sf=sf)
        syms = jnp.asarray(rng.integers(0, 256, (batch, SYMS - 2)), jnp.int32)
        plane = batch * SYMS * p.step * 4
        row(f"modulate_dechirped sf{sf} batch {batch}",
            median_time(lambda s: L.modulate_dechirped(s, p), syms), 2 * plane)
        for method in ("vpu", "mxu"):
            row(f"modulate_ri method={method} sf{sf} batch {batch}",
                median_time(lambda s, m=method: modulate_ri(s, p, method=m),
                            syms), 2 * plane)
        diff = max(float(jnp.max(jnp.abs(a - b))) for a, b in zip(
            modulate_ri(syms, p, method="vpu"),
            modulate_ri(syms, p, method="mxu")))
        print(f"max |vpu - mxu| IQ sf{sf}: {diff:.3e}", flush=True)
        re, im = L.modulate(syms, p)
        dr, di = L.dechirp(re, im, p)
        row(f"demodulate_tones sf{sf} batch {batch}",
            median_time(lambda r, i: L.demodulate_tones(r, i, p).symbols,
                        dr, di), 2 * plane)
        row(f"demodulate sf{sf} batch {batch}",
            median_time(lambda r, i: L.demodulate(r, i, p).symbols, re, im),
            2 * plane)
        zr = dr.reshape(-1, p.n)
        zi = di.reshape(-1, p.n)
        for label, ctx in (("HIGHEST", contextlib.nullcontext),
                           ("default", default_dft_precision)):
            with ctx():
                row(f"detect_ri {label} sf{sf} {zr.shape[0]} windows",
                    median_time(lambda r, i: detect_ri(r, i).index, zr, zi),
                    2 * zr.nbytes)
                row(f"demodulate_tones {label} sf{sf} batch {batch}",
                    median_time(
                        lambda r, i: L.demodulate_tones(r, i, p).symbols,
                        dr, di), 2 * plane)
        del re, im, dr, di, zr, zi

    length = 1 << 24
    sr = jnp.asarray(rng.standard_normal(length).astype(np.float32))
    si = jnp.asarray(rng.standard_normal(length).astype(np.float32))
    for sf in (7, 12):
        p = L.LoraParams(sf=sf)
        stride = p.step // 4
        windows = length // stride
        row(f"stream_scan sf{sf} stride step/4 {length} samples",
            median_time(lambda r, i: stream_scan(r, i, p, stride=stride),
                        sr, si), 2 * length * 4 + 3 * windows * 4)
    return 0


if __name__ == "__main__":
    sys.exit(main())
