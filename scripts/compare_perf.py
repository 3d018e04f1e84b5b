#!/usr/bin/env python3
"""Performance regression gate for bench.py CSVs.

The CSV schema (``run_id,profile,sf,N,pps,cycles_per_symbol``) and the
pass/fail contract — exit 2 plus the literal ``REGRESSION DETECTED`` /
``No regressions detected.`` strings — are deliberately kept compatible
with the reference's gate so baselines diff across implementations
(reference: scripts/compare_perf.py semantics).  The implementation is
this repo's own: typed rows, argparse, and an optional tolerance knob
the reference lacks (useful for wall-clock jitter on shared hosts).
"""
from __future__ import annotations

import argparse
import csv
import sys
from dataclasses import dataclass
from pathlib import Path


@dataclass(frozen=True)
class PerfRow:
    """One profile's measurements from a bench CSV."""

    profile: str
    pps: float
    cycles_per_symbol: float

    def regressions_vs(self, baseline: "PerfRow",
                       tolerance: float) -> list[str]:
        """Human-readable regression descriptions (empty = pass).

        A regression is a pps drop or a cycles/symbol rise beyond
        ``tolerance`` (a fraction; 0 reproduces the strict reference
        behaviour where any change in the wrong direction fails).
        """
        out = []
        if self.pps < baseline.pps * (1.0 - tolerance):
            out.append(f"{self.profile}: pps {baseline.pps:.2f}"
                       f"->{self.pps:.2f}")
        floor = baseline.cycles_per_symbol
        if floor and self.cycles_per_symbol > floor * (1.0 + tolerance):
            out.append(f"{self.profile}: cycles/sym {floor:.2f}"
                       f"->{self.cycles_per_symbol:.2f}")
        return out


def read_rows(path: Path) -> dict[str, PerfRow]:
    rows: dict[str, PerfRow] = {}
    with path.open(newline="") as f:
        for rec in csv.DictReader(f):
            rows[rec["profile"]] = PerfRow(
                profile=rec["profile"],
                pps=float(rec["pps"]),
                cycles_per_symbol=float(rec["cycles_per_symbol"] or 0.0),
            )
    return rows


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("baseline", type=Path)
    ap.add_argument("current", type=Path)
    ap.add_argument("--tolerance", type=float, default=0.0,
                    help="allowed fractional slack before flagging "
                         "(default 0: strict)")
    args = ap.parse_args(argv)

    baseline = read_rows(args.baseline)
    current = read_rows(args.current)
    findings: list[str] = []
    for profile, row in current.items():
        if profile in baseline:
            findings += row.regressions_vs(baseline[profile], args.tolerance)

    if findings:
        print("REGRESSION DETECTED")
        print("\n".join(findings))
        return 2
    print("No regressions detected.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
