"""Summarize telemetry JSONL metric streams from the command line.

    python -m repro_torch.telemetry.report METRICS.jsonl [--json]

Prints a per-stream digest: rounds covered, traffic by channel, drop and
delay statistics, accuracy trajectory endpoints, and (with ``--json``) the
digest as machine-readable JSON. Accepts multiple files and reports each.
Counterpart of ``repro.telemetry.report``: the same digest of the same
schema, so either package's report reads either package's streams.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List

from repro_torch.telemetry.schema import CHANNELS, SCHEMA_VERSION


def load_stream(path: str):
    """Returns (header, rows). Raises ValueError on schema mismatch."""
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    if not lines:
        raise ValueError(f"{path}: empty stream")
    head = json.loads(lines[0])
    ver = head.get("schema_version")
    if ver != SCHEMA_VERSION:
        raise ValueError(
            f"{path}: schema_version {ver!r} != supported {SCHEMA_VERSION}"
        )
    return head, [json.loads(ln) for ln in lines[1:]]


def summarize(rows: List[dict]) -> dict:
    if not rows:
        return {"rounds": 0}
    channels = {}
    for ch in CHANNELS:
        msgs = sum(r[f"msgs_{ch}"] for r in rows)
        if msgs == 0:
            continue
        channels[ch] = {
            "msgs": msgs,
            "bytes": sum(r[f"bytes_{ch}"] for r in rows),
            "drops": sum(r[f"drops_{ch}"] for r in rows),
        }
    hist = [0] * max(len(r["delay_hist"]) for r in rows)
    for r in rows:
        for i, n in enumerate(r["delay_hist"]):
            hist[i] += n
    delivered = sum(hist)
    last = rows[-1]
    return {
        "rounds": len(rows),
        "round_range": [rows[0]["round"], last["round"]],
        "active_last": last["active"],
        "channels": channels,
        "drops_offline": sum(r["drops_offline"] for r in rows),
        "delivered": delivered,
        "mean_delay_ticks": (
            sum(i * n for i, n in enumerate(hist)) / delivered if delivered else 0.0
        ),
        "delay_hist": hist,
        "acc_first": rows[0]["acc_mean"],
        "acc_last": last["acc_mean"],
        "acc_best": max(r["acc_mean"] for r in rows),
        "bytes_total": last["bytes_total"],
        "msgs_total": last["msgs_total"],
        "drops_total": last["drops_total"],
    }


def _print_human(path: str, head: dict, s: dict) -> None:
    print(f"== {path}")
    meta = head.get("meta") or {}
    if meta:
        print(f"   meta: {json.dumps(meta, sort_keys=True)}")
    if not s["rounds"]:
        print("   (no rows)")
        return
    lo, hi = s["round_range"]
    print(f"   rounds {lo}..{hi} ({s['rounds']} rows), active={s['active_last']}")
    for ch, c in s["channels"].items():
        print(
            f"   {ch:13s} msgs={c['msgs']:<8d} bytes={c['bytes']:<12d}"
            f" drops={c['drops']}"
        )
    print(
        f"   delivered={s['delivered']} mean_delay={s['mean_delay_ticks']:.3f} ticks"
        f" offline_drops={s['drops_offline']}"
    )
    print(
        f"   acc {s['acc_first']:.4f} -> {s['acc_last']:.4f}"
        f" (best {s['acc_best']:.4f})"
    )
    print(
        f"   totals: {s['msgs_total']} msgs, {s['bytes_total']} bytes,"
        f" {s['drops_total']} drops"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.report",
        description="Summarize telemetry JSONL metric streams.",
    )
    ap.add_argument("paths", nargs="+", help="metric .jsonl files")
    ap.add_argument("--json", action="store_true", help="emit JSON digests")
    args = ap.parse_args(argv)

    out = {}
    for path in args.paths:
        try:
            head, rows = load_stream(path)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        out[path] = summarize(rows)
        if not args.json:
            _print_human(path, head, out[path])
    if args.json:
        print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
