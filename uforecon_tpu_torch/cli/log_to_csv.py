"""The chamfer lines of ``eval_final.log`` as a CSV.

    python -m uforecon_tpu_torch.cli.log_to_csv --log OUT/eval_final.log --out scores.csv

Counterpart of the JAX package's ``cli/log_to_csv.py`` (reference
evaluation/log_to_csv.py): each ``scan: ID d2s s2d all`` line of the log
that ``cli/dtu_eval.py`` writes becomes a row ``scan,d2s,s2d,all``, then a
``mean`` row over the scans.
"""
from __future__ import annotations

import argparse
import csv
import re
from typing import Dict, List

FIELDS = ("scan", "d2s", "s2d", "all")
_LINE = re.compile(r"scan:\s*(\d+)\s+([0-9.eE+-]+)\s+([0-9.eE+-]+)\s+([0-9.eE+-]+)")


def parse_log(path: str) -> List[Dict]:
    """One ``{"scan", "d2s", "s2d", "all"}`` row per chamfer line."""
    rows = []
    with open(path) as f:
        for line in f:
            m = _LINE.search(line)
            if m:
                rows.append({"scan": int(m.group(1)), "d2s": float(m.group(2)),
                             "s2d": float(m.group(3)), "all": float(m.group(4))})
    return rows


def main(argv=None):
    p = argparse.ArgumentParser("uforecon_tpu_torch.cli.log_to_csv")
    p.add_argument("--log", type=str, default="eval_final.log")
    p.add_argument("--out", type=str, default="out.csv")
    a = p.parse_args(argv)

    rows = parse_log(a.log)
    with open(a.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=FIELDS)
        w.writeheader()
        w.writerows(rows)
        if rows:
            w.writerow({"scan": "mean", **{k: sum(r[k] for r in rows) / len(rows)
                                           for k in FIELDS[1:]}})
    print(f"wrote {a.out} ({len(rows)} scans)")


if __name__ == "__main__":
    main()
