#!/usr/bin/env python3
"""Generate golden vectors with this library + SHA256 manifest.

Mirrors the reference's scripts/generate_lora_phy_vectors.py /
generate_vectors.sh: run the vector_dump stage dumper for each requested
configuration, base64-encode the binary stages, and write a
``manifest.json`` with SHA256 checksums so scripts/compare_vectors.py can
diff vector trees across implementations.

Usage:
    python scripts/generate_vectors.py --out vectors/jax \
        --sf 7 --sf 9 --sf 12 --bytes 16 --seed 1 [--cfo-bins 0.2]
"""
from __future__ import annotations

import argparse
import base64
import hashlib
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def sha256(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def generate(out_root: Path, sfs, nbytes: int, seed: int, bw: int, osr: int,
             window: str, cfo_bins: float, time_offset: float) -> dict:
    """Run the stage dumper per SF; return the manifest dict."""
    from lora_sdr_lightweight_standalone_library_clean.runners import (
        vector_dump)

    manifest = {"generator": "lora_sdr_lightweight_standalone_library_clean",
                "seed": seed, "bytes": nbytes, "osr": osr, "bw": bw,
                "window": window, "cfo_bins": cfo_bins,
                "time_offset": time_offset, "configs": []}
    for sf in sfs:
        subdir = out_root / f"sf{sf}_bw{bw // 1000}"
        argv = [f"--out={subdir}", f"--sf={sf}", f"--bytes={nbytes}",
                f"--seed={seed}", f"--bw={bw}", f"--osr={osr}",
                f"--window={window}"]
        if cfo_bins:
            argv.append(f"--cfo-bins={cfo_bins}")
        if time_offset:
            argv.append(f"--time-offset={time_offset}")
        rc = vector_dump.main(argv)
        if rc != 0:
            raise SystemExit(f"vector_dump failed for sf={sf}: rc={rc}")
        files = []
        for p in sorted(subdir.iterdir()):
            if not p.is_file() or p.name == "manifest.json":
                continue
            rec = {"name": p.name, "sha256": sha256(p)}
            if p.suffix == ".bin":
                b64 = p.with_suffix(p.suffix + ".b64")
                b64.write_text(base64.b64encode(p.read_bytes()).decode())
                rec["b64"] = b64.name
            files.append(rec)
        manifest["configs"].append(
            {"sf": sf, "dir": subdir.name, "files": files})
    (out_root / "manifest.json").write_text(json.dumps(manifest, indent=2))
    return manifest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Generate LoRa golden vectors")
    ap.add_argument("--out", required=True)
    ap.add_argument("--sf", type=int, action="append",
                    help="spreading factor (repeatable; default 7 9 12)")
    ap.add_argument("--bytes", type=int, default=16, dest="nbytes")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--bw", type=int, default=125000)
    ap.add_argument("--osr", type=int, default=1)
    ap.add_argument("--window", default="none", choices=["none", "hann"])
    ap.add_argument("--cfo-bins", type=float, default=0.0)
    ap.add_argument("--time-offset", type=int, default=0)
    args = ap.parse_args(argv)
    out_root = Path(args.out)
    out_root.mkdir(parents=True, exist_ok=True)
    manifest = generate(out_root, args.sf or [7, 9, 12], args.nbytes,
                        args.seed, args.bw, args.osr, args.window,
                        args.cfo_bins, args.time_offset)
    n = sum(len(c["files"]) for c in manifest["configs"])
    print(f"wrote {n} files across {len(manifest['configs'])} configs to "
          f"{out_root} (manifest.json)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
