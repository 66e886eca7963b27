#!/usr/bin/env python3
"""Align two runs' ``test_metrics.txt`` into one delta table.

The port's copy of ``tools/compare_metrics.py``, with three faults of the
original repaired:

* a metric one run did not write (``lpips`` where no scorer ran) prints
  ``n/a`` instead of raising ``KeyError``;
* ``nan`` and ``inf`` values are read as such, not silently dropped by the
  number pattern;
* a run directory without ``test_metrics.txt`` stops the tool with a
  message naming the file, and two runs that share no held-out iteration
  print a warning instead of an empty table.

Usage:
    python3 tools/compare_metrics_torch.py RUN_A RUN_B
(each a run directory, ``<logdir>/<expname>``, holding ``test_metrics.txt``)
"""

import argparse
import math
import os
import re
import sys

COLUMNS = ("psnr", "ssim", "lpips")
WORDS = ("lpips_trunk",)


def load(run_dir, keep_words=False):
    """{iteration: {metric: float}} of ``<run_dir>/test_metrics.txt``;
    with ``keep_words`` also the non-numeric entries (``lpips_trunk``) as
    strings. Raises FileNotFoundError naming the file when it is absent."""
    path = os.path.join(run_dir, "test_metrics.txt")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path}: no test_metrics.txt (has the run reached its first "
            "--i_testset render?)")
    rows = {}
    with open(path) as f:
        for line in f:
            m = re.match(r"iter (\d+):", line)
            if not m:
                continue
            row = {}
            for k, v in re.findall(r"(\w+)=(\S+)", line):
                if k in WORDS:
                    if keep_words:
                        row[k] = v
                    continue
                row[k] = float(v)       # float() reads nan and inf
            rows[int(m.group(1))] = row
    return rows


def _fmt(row, name, spec):
    v = row.get(name)
    if v is None:
        return f"{'n/a':>{spec[0]}}"
    return f"{v:{spec}}"


def table(a, b):
    """The lines of the delta table over the iterations both runs hold."""
    lines = [f"{'iter':>6} | {'A psnr/ssim/lpips':>24} | "
             f"{'B psnr/ssim/lpips':>24} | {'dPSNR':>7} {'dSSIM':>8}"]
    specs = {"psnr": "9.3f", "ssim": "6.4f", "lpips": "7.5f"}

    def delta(ra, rb, name, width, prec):
        if name not in ra or name not in rb:
            return f"{'n/a':>{width}}"
        return f"{rb[name] - ra[name]:>+{width}.{prec}f}"

    for i in sorted(set(a) & set(b)):
        ra, rb = a[i], b[i]
        cells = [" ".join(_fmt(r, n, specs[n]) for n in COLUMNS)
                 for r in (ra, rb)]
        lines.append(f"{i:>6} | {cells[0]} | {cells[1]} | "
                     f"{delta(ra, rb, 'psnr', 7, 3)} "
                     f"{delta(ra, rb, 'ssim', 8, 4)}")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("run_a", help="baseline run dir (holds test_metrics.txt)")
    ap.add_argument("run_b", help="treatment run dir")
    args = ap.parse_args(argv)
    try:
        a, b = load(args.run_a), load(args.run_b)
    except FileNotFoundError as exc:
        print(f"compare_metrics_torch: {exc}", file=sys.stderr)
        return 2
    shared = set(a) & set(b)
    if not shared:
        print(f"compare_metrics_torch: WARNING: the runs share no held-out "
              f"iteration (A: {sorted(a)}, B: {sorted(b)}); nothing to "
              "compare", file=sys.stderr)
        return 1
    for line in table(a, b):
        print(line)
    if any(math.isnan(v) for r in (*a.values(), *b.values())
           for v in r.values()):
        print("compare_metrics_torch: WARNING: a run logged nan",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
