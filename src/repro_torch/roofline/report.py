"""Roofline report: dry-run JSONs -> a markdown table (port of
``repro/roofline/report.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.roofline.report \\
      [--dir experiments/dryrun_torch] [--mesh single] [--backend rns] \\
      [--tag ""] [--out table.md]

Every number is modelled from the counts of ``roofline/op_cost.py`` on the
meta device and the card's data-sheet peaks (``roofline/hw.py``), not
measured.  "fits 80G" reads the resident bytes a card holds (parameters,
cache and optimizer moments, from the sharding specs) against the card's
80 GB; activations and temporaries are not in it.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.roofline import hw
from repro_torch.roofline.analysis import summarize_cell

HEADER = ("| arch | shape | mesh | compute ms | memory ms | collective ms "
          "| bottleneck | useful | peak-frac | fits 80G | resident GB |\n"
          "|---|---|---|---|---|---|---|---|---|---|---|")


def load(dir_: str, mesh: str, tag: str, backend: str = "bns"):
    recs = []
    suffix = f"_{tag}.json" if tag else ".json"
    for p in sorted(glob.glob(os.path.join(dir_, f"*_{mesh}_{backend}"
                                           + suffix))):
        with open(p) as f:
            r = json.load(f)
        if r.get("skipped"):
            continue
        recs.append(r)
    return recs


def resident_bytes(record) -> int:
    return sum(record.get(k, 0) for k in ("param_bytes_dev",
                                          "cache_bytes_dev", "opt_bytes_dev"))


def fits(record) -> str:
    total = resident_bytes(record)
    return "Y" if total <= hw.HBM_BYTES else f"N({total / 1e9:.0f}G)"


def render(recs):
    rows = []
    for r in recs:
        s = summarize_cell(r)
        row = s.row() + f" {fits(r)} | {resident_bytes(r) / 1e9:.2f} |"
        rows.append((s.arch, s.shape, row, s))
    rows.sort(key=lambda r: r[:3])
    return "\n".join([HEADER] + [r[2] for r in rows]), [r[3] for r in rows]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--backend", default="bns")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    recs = load(args.dir, args.mesh, args.tag, args.backend)
    text, cells = render(recs)
    print(text)
    worst = sorted(cells, key=lambda c: c.peak_fraction)[:5]
    print("\nworst peak-fraction cells:")
    for c in worst:
        print(f"  {c.arch} x {c.shape}: {c.peak_fraction:.3f} "
              f"({c.bottleneck}-bound)")
    coll = sorted(cells, key=lambda c: (c.collective_s
                                        / max(max(c.compute_s, c.memory_s),
                                              1e-12)), reverse=True)[:5]
    print("most collective-bound cells:")
    for c in coll:
        print(f"  {c.arch} x {c.shape}: coll {c.collective_s*1e3:.1f} ms vs "
              f"max(comp,mem) {max(c.compute_s, c.memory_s)*1e3:.1f} ms")
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
