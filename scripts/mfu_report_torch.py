#!/usr/bin/env python
"""Summarize tuning rows + the port's kernel spans into an MFU report.

The twin of scripts/mfu_report.py for the PyTorch/CUDA port: the same
inputs, the same report, the port's own knob reader and peak table
(superlu_dist_tpu_torch/utils/options.py, utils/peaks.py) instead of the
JAX package's.

    python scripts/mfu_report_torch.py [ROWS.jsonl] [TRACE]

Inputs: a JSONL file of bench rows (one JSON row per config) and a
kernel trace in EITHER format:

* the structured obs trace (preferred when present): the Chrome
  trace-event JSON or the JSONL sidecar written by ``SLU_TPU_TRACE``
  (superlu_dist_tpu_torch/obs/trace.py) — the factor executors' kernel
  spans (obs/kernelspans.py) carry shape, executed vs structural flops,
  the padding ratio and the device time between two CUDA events;
* the legacy stderr log containing ``# lvl=... m=... w=... u=...``
  kernel-trace lines.

The second argument is sniffed: trace formats are parsed natively,
anything else falls back to the legacy regex.  Missing or empty inputs
produce an explicit "no trace rows found" diagnostic and exit 1 instead
of a silently empty report.

Prints: the ranked rows, their dispatch-vs-compute split, and the top
kernel-time sinks.  The JAX report's compile-census section has no twin:
the port has no compile spans (a CUDA graph is captured, not compiled).
Pure text processing; safe to run anywhere.
"""

import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from superlu_dist_tpu_torch.utils.options import env_float  # noqa: E402
from superlu_dist_tpu_torch.utils.peaks import table_peak_gflops  # noqa: E402


def _row_mfu(row: dict) -> float:
    """A row's MFU — recomputed against the card's tabulated peak at the
    row's GEMM tier (utils/peaks.py; SLU_TPU_PEAK_GFLOPS overrides)
    whenever the row itself carries none.  Rows measured on a CPU stay
    at their recorded value (that machine's peak is unknowable here)."""
    mfu = row.get("mfu_pct") or 0.0
    if mfu:
        return float(mfu)
    value = row.get("value")
    if not value:
        return 0.0
    peak = env_float("SLU_TPU_PEAK_GFLOPS")
    if peak <= 0 and row.get("backend") not in (None, "cpu"):
        kind = row.get("device_kind") or row.get("backend", "")
        peak = table_peak_gflops(kind, row.get("gemm_precision",
                                               "highest")) or 0.0
    return round(100.0 * float(value) / peak, 4) if peak > 0 else 0.0


def _iter_trace_events(text: str):
    """Yield event dicts from a Chrome trace JSON or a JSONL sidecar;
    return None (not an empty iterator) when the text is neither."""
    text = text.strip()
    if not text:
        return None
    if text.startswith("{"):
        try:
            doc = json.loads(text)
        except json.JSONDecodeError:
            doc = None                # multi-line JSONL: parse per line
        if isinstance(doc, dict):
            if isinstance(doc.get("traceEvents"), list):
                return doc["traceEvents"]
            if "cat" not in doc:      # a single JSONL row IS an event
                return None
    events = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            ev = json.loads(line)
        except json.JSONDecodeError:
            return None
        if not isinstance(ev, dict) or "cat" not in ev:
            return None
        events.append(ev)
    return events or None


def load_trace_kernels(path: str):
    """Kernel rows [(ms, GF/s, lvl, batch, m, w, u), ...] from an obs
    trace artifact, or None when `path` is missing / not a trace file
    (the caller then tries the legacy format)."""
    try:
        with open(path) as f:
            text = f.read()
    except OSError:
        return None
    events = _iter_trace_events(text)
    if events is None:
        return None
    rows = []
    for ev in events:
        if ev.get("cat") != "kernel":
            continue
        args = ev.get("args") or {}
        ms = float(ev.get("dur", 0.0)) / 1e3          # trace dur is in us
        gflop = float(args.get("executed_flops",
                               args.get("structural_flops", 0.0))) / 1e9
        gfs = gflop / max(ms / 1e3, 1e-12)
        rows.append((ms, gfs, int(args.get("level", -1)),
                     int(args.get("batch", 0)), int(args.get("m", 0)),
                     int(args.get("w", 0)), int(args.get("u", 0))))
    return rows


def main():
    out = sys.argv[1] if len(sys.argv) > 1 else "tune_results.jsonl"
    err = sys.argv[2] if len(sys.argv) > 2 else "tune_results.err"

    missing = []
    rows = []
    try:
        for line in open(out):
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                pass
    except FileNotFoundError:
        missing.append(out)

    card = [r for r in rows if r.get("value") is not None
            and r.get("backend") not in (None, "cpu")]
    card.sort(key=lambda r: -r["value"])
    if card:
        print("== card rows (ranked by factor GFLOP/s) ==")
    for r in card:
        disp = r.get("dispatch_seconds")
        fs = r.get("factor_seconds", 0.0) or 0.0
        dshare = (f" dispatch {100 * disp / fs:4.0f}%"
                  if disp is not None and fs else "")
        print(f"{r['value']:8.1f} GF/s  mfu {_row_mfu(r):7.4f}%  "
              f"gemm {r.get('gemm_precision', '?'):<7s} "
              f"pad {r.get('padding_factor', '?'):>4}  "
              f"{r.get('granularity', '?'):<6} "
              f"kern {r.get('n_kernels', '?'):>3}{dshare}  "
              f"resid {r.get('residual', float('nan')):.1e}  "
              f"{r['metric']}"
              + (f"  [{','.join(str(b) for b in r['blocking'])}]"
                 if r.get("blocking") else ""))

    # kernel rows: structured trace preferred, legacy stderr fallback
    # ("# lvl=3  B=16  m=512  w=256  u=256  12.34 ms  567.8 GF/s")
    kernels = load_trace_kernels(err)
    source = "structured trace" if kernels is not None else "legacy stderr"
    if kernels is None:
        pat = re.compile(
            r"# lvl=\s*(\d+)\s+B=\s*(\d+)\s+m=\s*(\d+)\s+w=\s*(\d+)\s+"
            r"u=\s*(\d+)\s+([\d.]+) ms\s+([\d.]+) GF/s")
        kernels = []
        try:
            for line in open(err):
                m = pat.search(line)
                if m:
                    lvl, B, mm, w, u = (int(m.group(i))
                                        for i in range(1, 6))
                    ms, gfs = float(m.group(6)), float(m.group(7))
                    kernels.append((ms, gfs, lvl, B, mm, w, u))
        except FileNotFoundError:
            missing.append(err)
    if kernels:
        total = sum(k[0] for k in kernels)
        print(f"\n== kernel trace ({source}): {len(kernels)} entries, "
              f"{total:.1f} ms profiled ==")
        print("top sinks (ms, GF/s, lvl, batch, m, w, u, % of profiled):")
        for ms, gfs, lvl, B, mm, w, u in sorted(kernels)[::-1][:12]:
            print(f"  {ms:8.2f} ms {gfs:8.1f} GF/s  lvl={lvl:<3d} B={B:<5d} "
                  f"m={mm:<5d} w={w:<5d} u={u:<5d}  "
                  f"{100 * ms / max(total, 1e-12):4.1f}%")

    if not rows and not kernels:
        # the one failure mode this script must never have: silence
        detail = (f" (missing: {', '.join(missing)})" if missing
                  else " (inputs present but empty)")
        print(f"no trace rows found in {out!r} / {err!r}{detail}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
