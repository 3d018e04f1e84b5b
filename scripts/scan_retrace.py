#!/usr/bin/env python3
"""Static + runtime hygiene scan — the JAX analog of scripts/scan_allocs.sh.

The reference enforces zero runtime allocation by grepping for allocator
calls (scan_allocs.sh).  The equivalent steady-state hazards in a JAX
framework are (a) retracing (shape/dtype-unstable jits) and (b) implicit
host<->device transfers in the hot path.  This script:

 1. greps the library for hot-path hazards: np.asarray on traced values,
    python float()/int() coercions inside jitted code paths, .item() calls;
 2. runs the flagship pipeline twice and asserts the trace count is 1
    (no retracing) using the same check tests/test_modem.py enforces.

Writes retrace_report.txt; exits non-zero on violations.
"""
import re
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent / \
    "lora_sdr_lightweight_standalone_library_clean"

HOT_MODULES = ["ops/chirp.py", "ops/detect.py", "ops/dft.py",
               "models/modem.py", "models/tones.py"]
HAZARDS = [
    (r"\.item\(\)", "host sync via .item()"),
    (r"float\(jnp\.", "host sync via float(jnp...)"),
    (r"np\.asarray\(jnp\.", "device->host copy in hot path"),
]


def main() -> int:
    report = []
    bad = False
    for mod in HOT_MODULES:
        text = (PKG / mod).read_text()
        for pat, why in HAZARDS:
            for m in re.finditer(pat, text):
                line = text[: m.start()].count("\n") + 1
                report.append(f"HAZARD {mod}:{line}: {why}")
                bad = True
    probe = subprocess.run(
        [sys.executable, "-c", (
            "import jax; jax.config.update('jax_platforms','cpu')\n"
            "import sys; sys.path.insert(0, %r)\n"
            "import numpy as np\n"
            "import lora_sdr_lightweight_standalone_library_clean as L\n"
            "p = L.LoraParams(sf=7)\n"
            "traces = [0]\n"
            "import jax\n"
            "@jax.jit\n"
            "def f(re, im):\n"
            "    traces[0] += 1\n"
            "    return L.demodulate_tones(*L.dechirp(re, im, p), p).symbols\n"
            "re, im = L.modulate(L.encode(np.arange(8,dtype=np.uint8)[None]), p)\n"
            "f(re, im); f(re + 0, im + 0)\n"
            "assert traces[0] == 1, f'retraced: {traces[0]}'\n"
            "print('retrace check: OK')\n"
        ) % str(PKG.parent)],
        capture_output=True, text=True)
    report.append(probe.stdout.strip())
    if probe.returncode != 0:
        report.append("RETRACE CHECK FAILED:\n" + probe.stderr[-2000:])
        bad = True
    out = Path(__file__).resolve().parent.parent / "retrace_report.txt"
    out.write_text("\n".join(report) + "\n")
    print("\n".join(report))
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
