"""CLI runner integration tests (subprocess, mirroring
tests/lorawan_roundtrip.py and the tx->rx wire format)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = "lora_sdr_lightweight_standalone_library_clean"
ENV = dict(os.environ, JAX_PLATFORMS="cpu",
           PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))


def run(mod, *args, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", f"{PKG}.runners.{mod}", *args],
        capture_output=True, text=False, cwd=REPO, env=ENV, timeout=timeout)


@pytest.mark.slow
def test_tx_rx_pipe(tmp_path):
    """tx hex -> IQ file -> rx hex roundtrip (tones path)."""
    payload = "DEADBEEFCAFEF00D"
    iq = tmp_path / "iq.f32"
    r = run("tx", f"--payload={payload}", "--sf=7", f"--out={iq}")
    assert r.returncode == 0, r.stderr.decode()
    assert iq.stat().st_size == (8 * 2 + 2) * 128 * 8  # (16+2 syms)*N*2*f32
    r = run("rx", f"--in={iq}", "--sf=7", "--report-offsets")
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout.decode().strip() == payload
    assert "sync=0x12" in r.stderr.decode()


def test_tx_stdout_rx_stdin(tmp_path):
    r1 = run("tx", "--payload=0011AA", "--sf=8", "--out=-")
    assert r1.returncode == 0
    r2 = subprocess.run(
        [sys.executable, "-m", f"{PKG}.runners.rx", "--in=-", "--sf=8"],
        input=r1.stdout, capture_output=True, cwd=REPO, env=ENV, timeout=240)
    assert r2.returncode == 0, r2.stderr.decode()
    assert r2.stdout.decode().strip() == "0011AA"


@pytest.mark.slow
def test_lorawan_roundtrip_runner():
    """5 random payload roundtrips (tests/lorawan_roundtrip.py:13-22)."""
    rng = np.random.default_rng(21)
    for _ in range(5):
        payload = bytes(rng.integers(0, 256, 8).astype(np.uint8)).hex()
        r = run("lorawan_roundtrip", f"--payload={payload}")
        assert r.returncode == 0, r.stderr.decode()
        assert "OK" in r.stderr.decode()


def test_vector_dump_runner(tmp_path):
    out = tmp_path / "vecs"
    r = run("vector_dump", f"--out={out}", "--sf=7", "--bytes=8", "--seed=3")
    assert r.returncode == 0, r.stderr.decode()
    for name in ["payload.bin", "pre_interleave.csv", "post_interleave.csv",
                 "iq_samples.csv", "demod_symbols.csv", "deinterleave.csv",
                 "decoded.bin"]:
        assert (out / name).exists(), name
    payload = np.fromfile(out / "payload.bin", np.uint8)
    assert payload.size == 8
    syms = np.loadtxt(out / "post_interleave.csv", dtype=np.int64)
    # zero-padded to whole interleaver blocks: ceil(16 nibbles / sf7) = 3
    # blocks * 8 symbols (lora_phy_vector_dump.cpp:95-98,108)
    assert syms.size == 24
    assert (syms[16:] == 0).all()


def test_generate_vectors_manifest(tmp_path):
    """scripts/generate_vectors.py: stage dumps + SHA256 manifest + b64,
    and compare_vectors passes a dir against itself (in-process; mirrors
    scripts/generate_lora_phy_vectors.py + compare_vectors.py)."""
    import importlib.util as ilu
    import json

    spec = ilu.spec_from_file_location(
        "generate_vectors", REPO / "scripts" / "generate_vectors.py")
    gen = ilu.module_from_spec(spec)
    spec.loader.exec_module(gen)
    out = tmp_path / "vecs"
    out.mkdir()
    manifest = gen.generate(out, [7], nbytes=8, seed=3, bw=125000, osr=1,
                            window="none", cfo_bins=0.0, time_offset=0)
    assert json.load(open(out / "manifest.json")) == manifest
    files = {f["name"]: f for f in manifest["configs"][0]["files"]}
    assert "payload.bin" in files and files["payload.bin"]["b64"]
    assert (out / "sf7_bw125" / "payload.bin.b64").exists()
    # self-compare must pass; checksum must actually match the file
    import hashlib
    data = (out / "sf7_bw125" / "payload.bin").read_bytes()
    assert files["payload.bin"]["sha256"] == hashlib.sha256(data).hexdigest()
    # Stage self-consistency: decoded.bin is exactly
    # hamming84(deinterleave(demod)) — the reference dump runner's
    # post-processing (lora_phy_vector_dump.cpp:153-162).  (decoded does
    # NOT equal payload by design: the dump deinterleaves symbols that
    # were never interleaved on encode; demod also carries the full-path
    # offset compensation, so it is not post_interleave either.)
    import numpy as np

    from lora_sdr_lightweight_standalone_library_clean.ops import codes
    demod = np.loadtxt(out / "sf7_bw125" / "demod_symbols.csv", dtype=int)
    deint = codes.diagonal_deinterleave(demod.astype(np.uint16), 7, 4)
    dec = codes.decode_hamming84(deint[:16])
    got = (((dec[0::2] & 0xF) << 4) | (dec[1::2] & 0xF)).astype(np.uint8)
    assert (out / "sf7_bw125" / "decoded.bin").read_bytes() == got.tobytes()


def test_mt19937_payload_bit_exact():
    """Payload RNG is bit-identical to the reference's std::mt19937 +
    uniform_int_distribution<int>(0,255) (lora_phy_vector_dump.cpp:88-92).
    Known answer captured from the built reference binary (seed=3, 8 bytes);
    with it, payload/pre_interleave/post_interleave stage dumps SHA256-match
    the reference's dir-for-dir (scripts/compare_vectors.py)."""
    from lora_sdr_lightweight_standalone_library_clean.runners.vector_dump import (
        _mt19937_payload)
    got = _mt19937_payload(3, 8)
    assert bytes(got).hex() == "8d12b5d74a1f8291"
    assert bytes(_mt19937_payload(1, 4)).hex() != bytes(got[:4]).hex()


def test_awgn_sweep_runner(tmp_path):
    """awgn_sweep CLI: CSV schema + monotone-ish PER waterfall
    (the TEST_PLAN.md:32 tool the reference never shipped)."""
    out = tmp_path / "sweep.csv"
    r = run("awgn_sweep", "--sf=7", "--snr-start=-14", "--snr-stop=-4",
            "--snr-step=5", "--packets=100", "--bytes=4", f"--out={out}")
    assert r.returncode == 0, r.stderr.decode()
    rows = out.read_text().strip().splitlines()
    assert rows[0] == "snr_db,ser,ber,per,crc_ok_rate"
    vals = [list(map(float, row.split(","))) for row in rows[1:]]
    assert len(vals) == 3
    assert vals[0][3] > 0.9      # PER ~1 at -14 dB
    assert vals[-1][3] < 0.05    # PER ~0 at -4 dB


@pytest.mark.slow
def test_stream_rx_runner(tmp_path):
    """stream_rx CLI: multi-packet capture at arbitrary offsets -> one
    line per packet with position, CRC verdict and payload."""
    import jax.numpy as jnp

    import lora_sdr_lightweight_standalone_library_clean as L
    from lora_sdr_lightweight_standalone_library_clean.models.modem import (
        crc_sx1272)

    p = L.LoraParams(sf=7)
    rng = np.random.default_rng(1)

    def frame(body):
        crc = int(np.asarray(crc_sx1272(jnp.asarray(body[2:]))))
        return np.concatenate([body, [crc & 0xFF, crc >> 8]]).astype(np.uint8)

    n_samp = 60000
    sr = rng.standard_normal(n_samp).astype(np.float32) * 0.03
    si = rng.standard_normal(n_samp).astype(np.float32) * 0.03
    offsets = (1000, 40007)
    payloads = []
    for g in offsets:
        pl = frame(rng.integers(0, 256, 6).astype(np.uint8))
        payloads.append(pl)
        re, im = L.modulate(L.encode(pl[None]), p)
        sr[g:g + re.shape[-1]] += np.asarray(re)[0]
        si[g:g + re.shape[-1]] += np.asarray(im)[0]
    iq = np.empty(2 * n_samp, np.float32)
    iq[0::2] = sr
    iq[1::2] = si
    cap = tmp_path / "capture.f32"
    iq.tofile(cap)

    r = run("stream_rx", f"--in={cap}", "--sf=7", "--payload-bytes=8",
            "--chunk=16384")
    assert r.returncode == 0, r.stderr.decode()
    lines = r.stdout.decode().strip().splitlines()
    assert len(lines) == 2
    for line, g, pl in zip(lines, offsets, payloads):
        start, crc_ok, payload_hex = line.split()
        assert int(start) == g
        assert crc_ok == "1"
        assert payload_hex == bytes(pl).hex().upper()


@pytest.mark.slow
def test_framed_tx_rx_pipe(tmp_path):
    """tx --framed -> IQ -> rx --framed: the full SX1272 coded frame
    (explicit header + whitening + FEC + interleave + Gray + CRC) over the
    CLI wire format."""
    payload = "DEADBEEFCAFE01"
    iq = tmp_path / "iq.f32"
    r = run("tx", f"--payload={payload}", "--sf=8", "--cr=4/6", "--framed",
            f"--out={iq}")
    assert r.returncode == 0, r.stderr.decode()
    r = run("rx", f"--in={iq}", "--sf=8", "--cr=4/6", "--framed",
            "--report-offsets")
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout.decode().strip() == payload
    assert "crc_ok=True" in r.stderr.decode()


@pytest.mark.slow
def test_framed_vector_dump(tmp_path):
    """--framed stage dump decodes back to the seeded payload."""
    out = tmp_path / "dump"
    r = run("vector_dump", f"--out={out}", "--sf=7", "--bytes=8", "--framed")
    assert r.returncode == 0, r.stderr.decode()
    meta = (out / "frame_meta.csv").read_text()
    assert "hdr_ok,1" in meta and "crc_ok,1" in meta
    dec = np.fromfile(out / "decoded.bin", np.uint8)
    pay = np.fromfile(out / "payload.bin", np.uint8)
    assert (dec[:pay.size] == pay).all()


@pytest.mark.slow
def test_framed_stream_rx_runner(tmp_path):
    """stream_rx --framed recovers mixed-length frames from a capture."""
    import lora_sdr_lightweight_standalone_library_clean as L
    from lora_sdr_lightweight_standalone_library_clean.models import frame

    p = L.LoraParams(sf=7, cr="4/8")
    rng = np.random.default_rng(0)
    sr = (rng.standard_normal(32768) * 0.05).astype(np.float32)
    si = (rng.standard_normal(32768) * 0.05).astype(np.float32)
    pays = [rng.integers(0, 256, 5, dtype=np.uint8),
            rng.integers(0, 256, 12, dtype=np.uint8)]
    for g, pay in zip((3008, 12000), pays):
        sym = frame.encode_frame(pay, p)
        re, im = L.modulate(np.asarray(sym)[None], p)
        n = np.asarray(re).shape[-1]
        sr[g:g + n] += np.asarray(re)[0]
        si[g:g + n] += np.asarray(im)[0]
    inter = np.empty(sr.size * 2, np.float32)
    inter[0::2] = sr
    inter[1::2] = si
    cap = tmp_path / "cap.f32"
    inter.tofile(cap)
    r = run("stream_rx", f"--in={cap}", "--sf=7", "--cr=4/8",
            "--payload-bytes=16", "--framed")
    assert r.returncode == 0, r.stderr.decode()
    lines = [l.split() for l in r.stdout.decode().splitlines() if l]
    assert len(lines) == 2
    assert lines[0][2] == bytes(pays[0]).hex().upper()
    assert lines[1][2] == bytes(pays[1]).hex().upper()
    assert "len=5" in " ".join(lines[0]) and "len=12" in " ".join(lines[1])


def test_awgn_sweep_theory_column(tmp_path):
    out = tmp_path / "sweep.csv"
    r = run("awgn_sweep", "--sf=7", "--snr-start=-9", "--snr-stop=-8",
            "--snr-step=1", "--packets=50", "--theory", f"--out={out}")
    assert r.returncode == 0, r.stderr.decode()
    head, *rows = out.read_text().splitlines()
    assert head.endswith(",ser_theory")
    assert len(rows) == 2 and all(len(x.split(",")) == 6 for x in rows)


@pytest.mark.slow
def test_wide_stream_rx_runner(tmp_path):
    """stream_rx CLI on a BW-250@osr2 capture: the --wide path (auto)
    decodes the profiles the reference's own chain cannot round-trip."""
    import jax.numpy as jnp

    import lora_sdr_lightweight_standalone_library_clean as L
    from lora_sdr_lightweight_standalone_library_clean.models.modem import (
        crc_sx1272)

    p = L.LoraParams(sf=9, bw=250000, osr=2)
    rng = np.random.default_rng(9)

    def crc_frame(body):
        crc = int(np.asarray(crc_sx1272(jnp.asarray(body[2:]))))
        return np.concatenate([body, [crc & 0xFF, crc >> 8]]).astype(np.uint8)

    n_samp = 65536
    sr = rng.standard_normal(n_samp).astype(np.float32) * 0.03
    si = rng.standard_normal(n_samp).astype(np.float32) * 0.03
    offsets = (997, 30011)
    payloads = []
    for g in offsets:
        pl = crc_frame(rng.integers(0, 256, 6).astype(np.uint8))
        payloads.append(pl)
        re, im = L.modulate(L.encode(pl[None]), p)
        sr[g:g + re.shape[-1]] += np.asarray(re)[0]
        si[g:g + re.shape[-1]] += np.asarray(im)[0]
    iq = np.empty(2 * n_samp, np.float32)
    iq[0::2] = sr
    iq[1::2] = si
    cap = tmp_path / "capture.f32"
    iq.tofile(cap)

    r = run("stream_rx", f"--in={cap}", "--sf=9", "--bw=250000", "--osr=2",
            "--payload-bytes=8", "--chunk=32768")
    assert r.returncode == 0, r.stderr.decode()
    lines = r.stdout.decode().strip().splitlines()
    assert len(lines) == 2
    for line, g, pl in zip(lines, offsets, payloads):
        start, crc_ok, payload_hex = line.split()
        assert int(start) == g
        assert crc_ok == "1"
        assert payload_hex == bytes(pl).hex().upper()
