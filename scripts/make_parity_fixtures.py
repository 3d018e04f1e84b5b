#!/usr/bin/env python3
"""Regenerate reference-parity fixtures from a built reference tree.

Builds the reference's ``lora_phy_vector_dump`` (if needed), runs it for a
matrix of profiles, and stores each stage dump as a compressed ``.npz`` under
``tests/vectors/``.  These fixtures carry *behavioural data produced by the
reference binary* (payload bytes, encoded symbols, float32 IQ, the reference's
own full-path demod output, and decoded bytes) so this library's parity
tests run standalone.

Usage:  python scripts/make_parity_fixtures.py [--reference /root/reference]
"""
from __future__ import annotations

import argparse
import subprocess
import tempfile
from pathlib import Path

import numpy as np

CASES = [
    # (tag, sf, bw, osr, window, bytes)
    ("sf7_bw125", 7, 125000, 1, "none", 16),
    ("sf8_bw125", 8, 125000, 1, "none", 16),
    ("sf9_bw250", 9, 250000, 1, "none", 8),
    ("sf10_bw250", 10, 250000, 1, "none", 8),
    ("sf11_bw500", 11, 500000, 1, "none", 4),
    ("sf12_bw500", 12, 500000, 1, "none", 4),
    ("sf7_bw125_osr2", 7, 125000, 2, "none", 16),
    ("sf7_bw125_hann", 7, 125000, 1, "hann", 16),
]


def build_reference(ref: Path, build: Path) -> Path:
    binary = build / "lora_phy_vector_dump"
    if binary.exists():
        return binary
    build.mkdir(parents=True, exist_ok=True)
    subprocess.run(["cmake", "-DCMAKE_BUILD_TYPE=Release", str(ref),
                    "-G", "Ninja"], cwd=build, check=True,
                   capture_output=True)
    subprocess.run(["ninja", "lora_phy_vector_dump"], cwd=build, check=True,
                   capture_output=True)
    return binary


# Probe harness: calls the reference's estimate_offsets +
# compensate_offsets on IQ read from a file and dumps the estimates and
# the compensated IQ.  Our own test code — it exercises the reference's
# public workspace API (include/lora_phy/phy.hpp), it does not copy it.
_PROBE_SRC = r"""
#include <complex>
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "lora_phy/phy.hpp"

int main(int argc, char** argv) {
    if (argc != 4) { std::fprintf(stderr, "probe <sf> <in.f32> <out>\n"); return 2; }
    unsigned sf = std::atoi(argv[1]);
    size_t N = size_t(1) << sf;
    FILE* fi = std::fopen(argv[2], "rb");
    if (!fi) return 3;
    std::fseek(fi, 0, SEEK_END);
    long bytes = std::ftell(fi);
    std::fseek(fi, 0, SEEK_SET);
    size_t count = bytes / (2 * sizeof(float));
    std::vector<std::complex<float>> iq(count);
    if (std::fread(iq.data(), sizeof(float), 2 * count, fi) != 2 * count)
        return 4;
    std::fclose(fi);

    std::vector<uint16_t> symbuf(count / N + 4);
    std::vector<std::complex<float>> fft_in(N), fft_out(N);
    lora_phy::lora_workspace ws{};
    ws.symbol_buf = symbuf.data();
    ws.fft_in = fft_in.data();
    ws.fft_out = fft_out.data();
    lora_phy::lora_params params{};
    params.sf = sf;   // bw/osr/window keep their bw_125 / 1 / none defaults
    if (lora_phy::init(&ws, &params) != 0) return 5;

    lora_phy::estimate_offsets(&ws, iq.data(), count);
    const lora_phy::lora_metrics* m = lora_phy::get_last_metrics(&ws);
    lora_phy::compensate_offsets(&ws, iq.data(), count);

    char path[512];
    std::snprintf(path, sizeof(path), "%s_metrics.txt", argv[3]);
    FILE* fm = std::fopen(path, "w");
    std::fprintf(fm, "%.9g %.9g\n", m->cfo, m->time_offset);
    std::fclose(fm);
    std::snprintf(path, sizeof(path), "%s_comp.f32", argv[3]);
    FILE* fo = std::fopen(path, "wb");
    std::fwrite(iq.data(), sizeof(float), 2 * count, fo);
    std::fclose(fo);
    return 0;
}
"""


def build_probe(ref: Path, build: Path) -> Path:
    """Compile the estimate/compensate probe against the built reference."""
    probe = build / "offset_probe"
    if probe.exists():
        return probe
    src = build / "offset_probe.cpp"
    src.write_text(_PROBE_SRC)
    lib = build / "liblora_phy.a"
    if not lib.exists():
        subprocess.run(["ninja", "lora_phy"], cwd=build, check=True,
                       capture_output=True)
    subprocess.run(
        ["g++", "-O2", "-std=c++17", f"-I{ref}/include", str(src),
         str(lib), "-o", str(probe)], check=True, capture_output=True)
    return probe


def make_offset_fixture(binary_dir: Path, ref: Path, out_dir: Path,
                        seed: int) -> None:
    """Reference estimate_offsets + compensate_offsets outputs on impaired
    IQ (phy.cpp:81-180) — closes the one public entry point without a
    reference diff, including the CFO-unit quirk
    (PARITY.md defect 10)."""
    probe = build_probe(ref, binary_dir)
    rng = np.random.default_rng(seed)
    for sf, cfo_bins, shift in [(7, 0.25, 3), (8, -0.4, -5), (9, 0.1, 0)]:
        n = 1 << sf
        total = 8 * n
        # preamble-like tones + noise, rotated by a fractional-bin CFO and
        # integer-shifted — the impairment family of
        # generate_lora_phy_vectors.py:106-128
        t = np.arange(total)
        base = np.exp(2j * np.pi * (cfo_bins) * t / n).astype(np.complex64)
        base *= 0.8
        base += (rng.standard_normal(total)
                 + 1j * rng.standard_normal(total)).astype(np.complex64) * 0.02
        iq = np.roll(base, shift)
        with tempfile.TemporaryDirectory() as td:
            td = Path(td)
            inter = np.empty(total * 2, np.float32)
            inter[0::2] = iq.real
            inter[1::2] = iq.imag
            inter.tofile(td / "in.f32")
            subprocess.run([str(probe), str(sf), str(td / "in.f32"),
                            str(td / "out")], check=True)
            cfo, toff = np.loadtxt(td / "out_metrics.txt")
            comp = np.fromfile(td / "out_comp.f32", np.float32)
        np.savez_compressed(
            out_dir / f"ref_offsets_sf{sf}.npz",
            sf=sf, cfo_bins=cfo_bins, shift=shift,
            iq=iq.astype(np.complex64),
            ref_cfo=np.float32(cfo), ref_time_offset=np.float32(toff),
            compensated=(comp[0::2] + 1j * comp[1::2]).astype(np.complex64))
        print("wrote", out_dir / f"ref_offsets_sf{sf}.npz")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reference", default="/root/reference")
    ap.add_argument("--build", default="/tmp/refbuild")
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    out_dir = Path(args.out or Path(__file__).resolve().parent.parent /
                   "tests" / "vectors")
    out_dir.mkdir(parents=True, exist_ok=True)
    binary = build_reference(Path(args.reference), Path(args.build))

    for tag, sf, bw, osr, window, nbytes in CASES:
        with tempfile.TemporaryDirectory() as td:
            cmd = [str(binary), f"--sf={sf}", f"--bw={bw}", f"--osr={osr}",
                   f"--seed={args.seed}", f"--bytes={nbytes}", f"--out={td}"]
            if window != "none":
                cmd.append(f"--window={window}")
            subprocess.run(cmd, check=True)
            td = Path(td)
            iq = np.loadtxt(td / "iq_samples.csv", delimiter=",",
                            dtype=np.float32)
            np.savez_compressed(
                out_dir / f"ref_{tag}.npz",
                sf=sf, bw=bw, osr=osr, window=window, seed=args.seed,
                payload=np.fromfile(td / "payload.bin", np.uint8),
                encoded=np.loadtxt(td / "post_interleave.csv",
                                   dtype=np.int64).astype(np.uint16),
                iq=(iq[:, 0] + 1j * iq[:, 1]).astype(np.complex64),
                demod=np.loadtxt(td / "demod_symbols.csv",
                                 dtype=np.int64).astype(np.uint16),
                decoded=np.fromfile(td / "decoded.bin", np.uint8),
            )
            print("wrote", out_dir / f"ref_{tag}.npz")

    make_offset_fixture(Path(args.build), Path(args.reference), out_dir,
                        args.seed)


if __name__ == "__main__":
    main()
