"""Render a run's JSONL event sink into a human-readable summary (port of
``repro.obs.report``; it reads the reference's sinks and the port's alike).

    PYTHONPATH=src python -m repro_torch.obs.report [DIR] [--gate-warm-lattice]

``DIR`` defaults to ``$REPRO_OBS_DIR``. The report groups by process
(multihost runs write one file per worker) and summarizes:

  * spans            — count / total / mean seconds per span name
  * counters         — final totals
  * lattice runs     — per engine dispatch of ``run_lattice``: cells,
                       cold/warm, trace and compile deltas
  * diagnostics taps — per-round means of the ``ObsConfig`` diagnostics
                       (aggregation noise power, scheduling entropy, eps
                       clamps, gradient-norm spread)

``--gate-warm-lattice`` turns the report into a CI smoke gate (exit 1 on
violation): every warm lattice call must record ZERO re-traces and ZERO new
compiles, and no fused lattice engine may hold more than one compiled
program. In the port's events (``repro_torch.sim.engine``) a lattice call is
warm when the process has run a lattice before, ``trace_delta`` and
``engine_compiles`` are 0 (nothing is traced or compiled per program) and
``compile_delta`` counts the ``nvcc`` builds of kernels made during the
call, so the gate holds a warm call to building no kernel.
"""
from __future__ import annotations

import argparse
import sys
from collections import defaultdict

from repro_torch.obs.sink import event_files, obs_dir, read_events


def collect(events) -> dict:
    """Fold an event stream into per-process summary structures."""
    out: dict = {
        "spans": defaultdict(lambda: {"count": 0, "seconds": 0.0, "max": 0.0}),
        "counters": {},  # (process, name) -> last seen total
        "gauges": {},
        "lattice": [],
        "diag": [],
        "profiles": [],
        "processes": set(),
    }
    for ev in events:
        proc = ev.get("process_index", 0)
        out["processes"].add(proc)
        kind = ev.get("kind")
        name = ev.get("name", "?")
        if kind == "span":
            s = out["spans"][(proc, name)]
            s["count"] += 1
            s["seconds"] += ev.get("seconds", 0.0)
            s["max"] = max(s["max"], ev.get("seconds", 0.0))
        elif kind == "counter":
            out["counters"][(proc, name)] = ev.get("total", 0)
        elif kind == "gauge":
            out["gauges"][(proc, name)] = ev.get("value")
        elif kind == "lattice":
            out["lattice"].append(ev)
        elif kind == "diag":
            out["diag"].append(ev)
        elif kind == "profile":
            out["profiles"].append(ev)
    return out


def _fmt_rounds(values, head: int = 6) -> str:
    vals = list(values)
    shown = ", ".join(f"{v:.3e}" for v in vals[:head])
    return f"[{shown}{', …' if len(vals) > head else ''}]"


def render(summary: dict) -> str:
    lines: list[str] = []
    procs = sorted(summary["processes"]) or [0]
    lines.append(
        f"# repro_torch.obs report — {len(procs)} process(es): {procs}"
    )

    if summary["spans"]:
        lines.append("\n## spans (host wall-clock)")
        lines.append(f"{'process':>7}  {'span':<28} {'count':>6} "
                     f"{'total_s':>9} {'mean_s':>9} {'max_s':>9}")
        for (proc, name), s in sorted(summary["spans"].items()):
            mean = s["seconds"] / max(s["count"], 1)
            lines.append(
                f"{proc:>7}  {name:<28} {s['count']:>6} "
                f"{s['seconds']:>9.3f} {mean:>9.3f} {s['max']:>9.3f}"
            )

    if summary["counters"]:
        lines.append("\n## counters (final totals)")
        lines.append(f"{'process':>7}  {'counter':<32} {'total':>12}")
        for (proc, name), total in sorted(summary["counters"].items()):
            shown = f"{total:.3f}" if isinstance(total, float) else str(total)
            lines.append(f"{proc:>7}  {name:<32} {shown:>12}")

    if summary["lattice"]:
        lines.append("\n## lattice runs (cold/warm compile behavior)")
        lines.append(f"{'process':>7} {'cells':>6} {'rounds':>7} {'fused':>6} "
                     f"{'warm':>5} {'trace_Δ':>8} {'compile_Δ':>10} "
                     f"{'engine_compiles':>16}")
        for ev in summary["lattice"]:
            lines.append(
                f"{ev.get('process_index', 0):>7} {ev.get('cells', '?'):>6} "
                f"{ev.get('n_rounds', '?'):>7} "
                f"{str(bool(ev.get('fused'))):>6} "
                f"{str(bool(ev.get('warm'))):>5} "
                f"{ev.get('trace_delta', '?'):>8} "
                f"{ev.get('compile_delta', '?'):>10} "
                f"{ev.get('engine_compiles', '?'):>16}"
            )

    if summary["diag"]:
        lines.append("\n## diagnostics taps (per-round means over cells)")
        for ev in summary["diag"]:
            lines.append(
                f"process {ev.get('process_index', 0)} — "
                f"{ev.get('name')} ({ev.get('n_rounds', '?')} rounds)"
            )
            for tap, series in (ev.get("taps") or {}).items():
                mean = sum(series) / max(len(series), 1)
                lines.append(
                    f"  {tap:<20} mean={mean:.4e}  rounds={_fmt_rounds(series)}"
                )

    if summary["profiles"]:
        lines.append("\n## profiler captures")
        for ev in summary["profiles"]:
            lines.append(f"  {ev.get('name')}: {ev.get('trace_dir')}")
    return "\n".join(lines)


def gate_warm_lattice(summary: dict) -> list[str]:
    """The CI smoke-gate predicate. Returns human-readable violations.

    * a WARM lattice call (engine had already traced) must re-trace zero
      times and compile zero new programs;
    * a fused lattice engine must never hold more than one compiled program
      (``n_compiles > 1`` means the one-compile contract broke).
    """
    problems = []
    if not summary["lattice"]:
        problems.append("no lattice events recorded — nothing to gate")
    for ev in summary["lattice"]:
        where = (f"process {ev.get('process_index', 0)} "
                 f"({ev.get('cells', '?')} cells)")
        if ev.get("warm"):
            if ev.get("trace_delta", 0):
                problems.append(
                    f"{where}: warm lattice repeat re-traced "
                    f"{ev['trace_delta']} time(s)"
                )
            if ev.get("compile_delta", 0):
                problems.append(
                    f"{where}: warm lattice repeat compiled "
                    f"{ev['compile_delta']} new program(s)"
                )
        if ev.get("fused") and ev.get("engine_compiles", 0) > 1:
            problems.append(
                f"{where}: fused lattice engine holds "
                f"{ev['engine_compiles']} compiled programs (expected 1)"
            )
    return problems


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "dir", nargs="?", default=None,
        help="sink directory (default: $REPRO_OBS_DIR)",
    )
    parser.add_argument(
        "--gate-warm-lattice", action="store_true",
        help="exit 1 unless every warm lattice repeat recorded zero "
        "re-traces/compiles and fused engines hold one program",
    )
    args = parser.parse_args(argv)
    path = args.dir or obs_dir()
    if not path:
        parser.error("no sink directory: pass DIR or set REPRO_OBS_DIR")
    files = event_files(path)
    if not files:
        print(f"no obs event files under {path}", file=sys.stderr)
        return 1
    summary = collect(read_events(path))
    print(render(summary))
    if args.gate_warm_lattice:
        problems = gate_warm_lattice(summary)
        if problems:
            print("\nGATE FAILED:", file=sys.stderr)
            for p in problems:
                print(f"  - {p}", file=sys.stderr)
            return 1
        print("\ngate ok: warm lattice repeats re-traced zero times, "
              "one compile per fused engine")
    return 0


if __name__ == "__main__":
    sys.exit(main())
