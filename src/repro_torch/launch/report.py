"""Render the roofline tables from results/dryrun_torch/*.json: the port of
``repro/launch/report.py``, with the H100's capacity in the fits column.

  PYTHONPATH=src python -m repro_torch.launch.report [--mesh single|multi|local]
      [--mode tp_sp|tp_sp_opt|fsdp_cp]

Every mesh's records carry the peak and the collective term (on the
production meshes, rank 0's of a counted sharded step); a record that
lacks one prints it as "n/a".
"""
from __future__ import annotations

import argparse
import json

from repro_torch.launch import dryrun


def _ms(s) -> str:
    return "n/a" if s is None else f"{s * 1e3:.1f}"


def _fits(mem) -> str:
    fits = mem.get("fits_h100_80g")
    return "n/a" if fits is None else ("yes" if fits else "NO")


def table(mesh: str = "single", mode: str = "tp_sp") -> str:
    """The table of ``mesh``'s records in sharding mode ``mode`` (under
    ``<mesh>-<mode>/`` for a mode other than ``tp_sp``)."""
    d = dryrun.RESULTS / (mesh if mode == "tp_sp" else f"{mesh}-{mode}")
    lines = [
        "| arch | shape | bound | compute (ms) | memory (ms) | collective "
        "(ms) | peak GB/chip | fits H100 80 GB | useful-FLOP ratio | "
        "roofline frac |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for f in sorted(d.glob("*.json")):
        r = json.loads(f.read_text())
        if r["status"] == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | — "
                         f"| — | — | skipped (sub-quadratic contract) |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | ERROR | | | | | | | |")
            continue
        rf = r["roofline"]
        mem = r.get("memory", {})
        peak = mem.get("peak_bytes_per_device")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {rf['bottleneck']} "
            f"| {_ms(rf['compute_s'])} | {_ms(rf['memory_s'])} "
            f"| {_ms(rf['collective_s'])} "
            f"| {'n/a' if peak is None else f'{peak / 1e9:.2f}'} "
            f"| {_fits(mem)} "
            f"| {rf.get('useful_flop_ratio', 0):.2f} "
            f"| {rf.get('roofline_fraction', 0):.3f} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--mode", default="tp_sp")
    args = ap.parse_args(argv)
    print(table(args.mesh, args.mode))


if __name__ == "__main__":
    main()
