"""Inspect a serving trace exported by the port's observability layer:
the counterpart of ``examples/inspect_trace.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_1_7b \\
        --engine --requests 8 --trace /tmp/trace.json [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.inspect_trace /tmp/trace.json

The file is Chrome trace-event JSON: load it at https://ui.perfetto.dev
(or chrome://tracing) to see the lanes -- engine steps, dispatches (with
padded-token counts and first-call / capture / replay flags), scheduler
admissions and preemptions, pool alloc / evict / retract, prefix-cache
hits, and one span per request from admission to completion.

This script does the same offline: validates the schema
(``obs.validate_chrome_trace``), then prints a lane-by-lane span summary
and each request's timeline with its trace-derived TTFT / TPOT.  It reads
a file and touches no device.  ``main`` returns the summary.
"""
from __future__ import annotations

import argparse
import json
from collections import defaultdict

from repro_torch.obs import validate_chrome_trace

__all__ = ["main", "summarize"]


def summarize(obj: dict, top: int = 8) -> dict:
    """A validated Chrome trace's summary: {"events", "spans",
    "instants", "dropped", "capacity", "lanes": {lane: [(name, count,
    total_us)]} (the ``top`` longest a lane), "requests": [(name, e2e_s,
    ttft_s, tpot_s)] (the first ``top`` by admission)}.  Raises
    ``ValueError`` listing the schema's problems."""
    problems = validate_chrome_trace(obj)
    if problems:
        raise ValueError("invalid trace:\n  " + "\n  ".join(problems))
    events = obj["traceEvents"]
    meta = obj.get("otherData", {})
    # tid -> lane name from the thread_name metadata events
    lanes = {e["tid"]: e["args"]["name"] for e in events
             if e["ph"] == "M" and e["name"] == "thread_name"}
    spans = [e for e in events if e["ph"] == "X"]
    instants = [e for e in events if e["ph"] in ("i", "I")]
    per_lane = defaultdict(lambda: defaultdict(lambda: [0, 0.0]))
    for e in spans:
        agg = per_lane[lanes.get(e["tid"], f"tid{e['tid']}")][e["name"]]
        agg[0] += 1
        agg[1] += e.get("dur", 0.0)
    # per-request timelines live in the 'requests' lane: one span per
    # request (admission -> done), TTFT / TPOT in its args
    reqs = sorted((e for e in spans if lanes.get(e["tid"]) == "requests"),
                  key=lambda e: e["ts"])
    timelines = []
    for e in reqs[:top]:
        a = e["args"]
        # the span runs admission -> done; e2e is measured from arrival
        e2e = (e["ts"] + e.get("dur", 0.0)) / 1e6 - a["arrival_s"]
        timelines.append((e["name"], e2e, a.get("ttft_s"), a.get("tpot_s")))
    return {"events": len(events), "spans": len(spans),
            "instants": len(instants),
            "dropped": meta.get("dropped_events", "?"),
            "capacity": meta.get("ring_capacity", "?"),
            "lanes": {lane: sorted(((name, n, dur) for name, (n, dur)
                                    in per_lane[lane].items()),
                                   key=lambda r: -r[2])[:top]
                      for lane in sorted(per_lane)},
            "requests": timelines, "n_requests": len(reqs)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("trace", help="Chrome trace-event JSON "
                                  "(serve --engine --trace OUT.json)")
    ap.add_argument("--top", type=int, default=8,
                    help="spans to list per lane (by total duration)")
    args = ap.parse_args(argv)

    with open(args.trace) as f:
        obj = json.load(f)
    try:
        s = summarize(obj, args.top)
    except ValueError as e:
        raise SystemExit(str(e))
    print(f"{args.trace}: {s['events']} events "
          f"({s['spans']} spans, {s['instants']} instants), "
          f"ring dropped={s['dropped']} capacity={s['capacity']}")
    for lane, rows in s["lanes"].items():
        print(f"\n[{lane}]")
        for name, n, dur in rows:
            print(f"  {name:<32s} x{n:<5d} total {dur / 1e3:9.3f} ms")
    if s["requests"]:
        print(f"\n[timelines] {s['n_requests']} requests")

        def fmt(v):
            return f"{1e3 * v:8.2f} ms" if v is not None else "       --"
        for name, e2e, ttft, tpot in s["requests"]:
            print(f"  {name:<12s} e2e {1e3 * e2e:9.3f} ms  "
                  f"ttft {fmt(ttft)}  tpot {fmt(tpot)}")
    print("\nopen in Perfetto: https://ui.perfetto.dev  ->  Open trace file")
    return s


if __name__ == "__main__":
    main()
