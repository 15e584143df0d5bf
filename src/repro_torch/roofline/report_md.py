"""Render the dry run's JSON into the roofline tables (the port of
``repro.roofline.report_md``)."""
from __future__ import annotations

import json
import sys


def fmt_bytes(b: float) -> str:
    if b >= 1e12:
        return f"{b/1e12:.2f}TB"
    if b >= 1e9:
        return f"{b/1e9:.2f}GB"
    return f"{b/1e6:.1f}MB"


def render(rows, multi_pod: bool) -> str:
    out = []
    out.append("| arch | shape | kind | compute_s | memory_s | collective_s |"
               " dominant | MODEL/HLO | roofline frac | peak mem/dev |")
    out.append("|---|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        if r.get("status") != "ok" or r["multi_pod"] != multi_pod:
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r.get('kind','?')} "
            f"| {r['compute_s']:.3e} | {r['memory_s']:.3e} "
            f"| {r['collective_s']:.3e} | {r['dominant']} "
            f"| {r['useful_ratio']:.2f} | {r['roofline_fraction']:.3f} "
            f"| {fmt_bytes(r.get('peak_memory_bytes', 0))} |")
    return "\n".join(out)


def main(path: str) -> None:
    with open(path) as f:
        rows = json.load(f)
    print("### Single-pod 16x16 (256 chips)\n")
    print(render(rows, False))
    print("\n### Multi-pod 2x16x16 (512 chips)\n")
    print(render(rows, True))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "results/dryrun_all.json")
