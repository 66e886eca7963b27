#!/usr/bin/env python3
"""Collapse rates of two sets of validation runs and Fisher's exact test.

A run of ``tools/validate_train_torch.py`` that falls into the far-plane
billboard (depth 1.0 everywhere, the held-out view off at the sphere's
edges) reads 13.9-15.4 dB at 500 iterations on the sphere scene; a run
that trains reads 24.8 dB or more. This tool reads the held-out PSNR of
each run's ``test_metrics.txt`` at the first held-out iteration at or past
``--at - 1`` (a 500-iteration run renders at 499, a 1000-iteration run at
500), marks a collapse below ``--threshold`` dB, and prints the two
collapse counts and the two-sided p of Fisher's exact test on the 2 x 2
table (the hypergeometric probabilities of all tables with the same
margins that are no more likely than the observed one).

Usage:
    python3 tools/collapse_rate_torch.py --a RUN_DIR... --b RUN_DIR...
        [--threshold 20] [--at 500]
"""

import argparse
import json
import os
import sys
from math import comb

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def fisher_exact_two_sided(a_hit: int, a_n: int, b_hit: int,
                           b_n: int) -> float:
    """Two-sided p of Fisher's exact test for ``a_hit`` of ``a_n`` against
    ``b_hit`` of ``b_n``."""
    hits, total = a_hit + b_hit, a_n + b_n

    def prob(k):
        return comb(a_n, k) * comb(b_n, hits - k) / comb(total, hits)

    observed = prob(a_hit)
    lo, hi = max(0, hits - b_n), min(a_n, hits)
    # the relative tolerance guards ties against rounding, as scipy does
    return min(1.0, sum(p for p in map(prob, range(lo, hi + 1))
                        if p <= observed * (1 + 1e-7)))


def psnr_at(run_dir: str, at: int):
    """(iteration, PSNR) of the first held-out row at or past ``at - 1``."""
    from compare_metrics_torch import load

    rows = load(run_dir)
    its = sorted(it for it in rows if it >= at - 1)
    if not its:
        raise SystemExit(f"{run_dir}: no held-out row at or past {at - 1}")
    return its[0], rows[its[0]]["psnr"]


def classify(run_dirs, threshold: float, at: int):
    out = []
    for d in run_dirs:
        it, psnr = psnr_at(d, at)
        out.append(dict(run=os.path.basename(os.path.normpath(d)), iter=it,
                        psnr=psnr, collapsed=bool(psnr < threshold)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--a", nargs="+", required=True, help="runs of set A")
    ap.add_argument("--b", nargs="+", required=True, help="runs of set B")
    ap.add_argument("--threshold", type=float, default=20.0)
    ap.add_argument("--at", type=int, default=500)
    args = ap.parse_args(argv)
    a = classify(args.a, args.threshold, args.at)
    b = classify(args.b, args.threshold, args.at)
    for name, runs in (("A", a), ("B", b)):
        for r in runs:
            print(f"{name} {r['run']}: iter {r['iter']} psnr {r['psnr']:.3f}"
                  f"{'  collapsed' if r['collapsed'] else ''}")
    a_hit = sum(r["collapsed"] for r in a)
    b_hit = sum(r["collapsed"] for r in b)
    p = fisher_exact_two_sided(a_hit, len(a), b_hit, len(b))
    print(json.dumps({"a_collapsed": a_hit, "a_runs": len(a),
                      "b_collapsed": b_hit, "b_runs": len(b),
                      "threshold_db": args.threshold, "at": args.at,
                      "fisher_p_two_sided": p}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
