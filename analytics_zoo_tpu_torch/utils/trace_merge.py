"""zoo-trace: merge per-process Chrome traces into one request timeline.

A copy of ``analytics_zoo_tpu/utils/trace_merge.py``; run it as ``python
-m analytics_zoo_tpu_torch.utils.trace_merge merge|ls|show``. The port's
``merge`` also takes ``--extra PATH`` (repeatable): a trace file, or a
directory whose ``trace-*.json`` files join the merge — the trainer's
telemetry trace (``<trace_dir>/trace-<pid>.json``) and the profiler's
(``<profile_dir>/trace-torch-profiler-<pid>-<ms>.json``,
``utils/profiling.ProfilerHook``) land in one timeline that way.

Every serving process (clients, fleet workers, the launcher) writes its
own ``trace-<pid>.json`` under the shared ``--trace-dir``
(telemetry.write_trace).  One request crosses several of them — client
enqueue, queue delivery, a worker's decode/dispatch/write — and each
hop is tagged with the record's ``trace_id`` plus a flow event
(``ph:"s"`` at the producer, ``ph:"f"`` at the consumer,
telemetry.flow).  This tool stitches the files back into a single
timeline (docs/observability.md#tracing):

- ``zoo-trace merge --dir D [-o merged.json]`` — concatenate every
  ``trace-*.json`` (process-name metadata rows keep each pid labeled;
  the flow ids line up by construction, so chrome://tracing /
  ui.perfetto.dev draws the cross-process arrows);
- ``zoo-trace ls --dir D`` — the trace ids seen, with event/pid counts;
- ``zoo-trace show <trace_id> --dir D`` — the causal tree for one
  request: per-pid spans in time order, flow hops, connectivity.

The library surface (:func:`merge_trace_dir`, :func:`trace_summary`)
is what the fast-tier cross-process test asserts on.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

__all__ = ["load_trace_file", "merge_trace_dir", "index_by_trace",
           "trace_summary", "main"]


def load_trace_file(path: str) -> List[dict]:
    with open(path) as f:
        payload = json.load(f)
    if isinstance(payload, dict):
        return list(payload.get("traceEvents") or [])
    return list(payload)                    # bare-array form is legal too


def _trace_files(trace_dir: str) -> List[str]:
    try:
        names = sorted(os.listdir(trace_dir))
    except FileNotFoundError:
        return []
    return [os.path.join(trace_dir, n) for n in names
            if n.startswith("trace-") and n.endswith(".json")]


def merge_trace_dir(trace_dir: str,
                    extra_files: Optional[List[str]] = None) -> dict:
    """Merge every ``trace-*.json`` under ``trace_dir`` (plus
    ``extra_files``) into one Chrome-trace payload.  Process-name
    metadata rows are deduplicated per (pid, tid); events keep their
    original pids so the merged view shows one row per process."""
    events: List[dict] = []
    seen_meta = set()
    sources = _trace_files(trace_dir) + list(extra_files or [])
    for path in sources:
        try:
            evs = load_trace_file(path)
        except (OSError, ValueError):
            continue
        for ev in evs:
            if ev.get("ph") == "M":
                key = (ev.get("name"), ev.get("pid"), ev.get("tid"),
                       json.dumps(ev.get("args"), sort_keys=True))
                if key in seen_meta:
                    continue
                seen_meta.add(key)
            events.append(ev)
    events.sort(key=lambda e: (e.get("ph") != "M", e.get("ts", 0)))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"merged_from": len(sources)}}


def _ev_trace_ids(ev: dict) -> List[str]:
    """Trace ids an event belongs to: flow events carry one in ``id``;
    per-record spans carry ``args.trace_id``; batch-level spans
    (dispatch / device_sync / write) carry the whole batch's ids in
    ``args.trace_ids`` and belong to every one of them."""
    args = ev.get("args") or {}
    if ev.get("ph") in ("s", "t", "f"):
        tid = args.get("id") or ev.get("id")
        return [str(tid)] if tid else []
    out = []
    if args.get("trace_id"):
        out.append(str(args["trace_id"]))
    many = args.get("trace_ids")
    if isinstance(many, (list, tuple)):
        out.extend(str(t) for t in many if t)
    return out


def index_by_trace(events: List[dict]) -> Dict[str, List[dict]]:
    """Group span/instant/flow events by the trace id(s) they carry."""
    out: Dict[str, List[dict]] = {}
    for ev in events:
        for tid in _ev_trace_ids(ev):
            out.setdefault(tid, []).append(ev)
    return out


def _pair_spans(events: List[dict]) -> List[dict]:
    """Match B/E pairs per (pid, tid) into {name, pid, ts, dur_us}."""
    open_spans: Dict[Tuple, List[dict]] = {}
    spans: List[dict] = []
    for ev in sorted(events, key=lambda e: e.get("ts", 0)):
        ph = ev.get("ph")
        key = (ev.get("pid"), ev.get("tid"))
        if ph == "B":
            open_spans.setdefault(key, []).append(ev)
        elif ph == "E" and open_spans.get(key):
            b = open_spans[key].pop()
            spans.append({"name": b.get("name"), "pid": b.get("pid"),
                          "tid": b.get("tid"), "ts": b.get("ts", 0),
                          "dur_us": ev.get("ts", 0) - b.get("ts", 0),
                          "args": b.get("args") or {}})
    # unclosed spans (process died mid-span) still show up, dur unknown
    for stack in open_spans.values():
        for b in stack:
            spans.append({"name": b.get("name"), "pid": b.get("pid"),
                          "tid": b.get("tid"), "ts": b.get("ts", 0),
                          "dur_us": None, "args": b.get("args") or {}})
    return sorted(spans, key=lambda s: s["ts"])


def trace_summary(merged: dict, trace_id: str) -> dict:
    """The causal tree for one request out of a merged timeline:
    matched spans + instants in time order, the flow hops, the pids
    crossed, and whether the tree is *connected* (every pid that did
    work on the request is linked to another pid by a flow arrow —
    the cross-process acceptance check)."""
    tid = str(trace_id)
    all_events = merged.get("traceEvents") or []
    # pair B/E over the *whole* timeline first ("E" rows carry no args,
    # so a per-trace filter before pairing would leave every span open),
    # then keep the spans whose begin row is tagged with this trace id
    all_spans = _pair_spans([e for e in all_events
                             if e.get("ph") in ("B", "E")])
    spans = [s for s in all_spans
             if tid in _ev_trace_ids({"ph": "B", "args": s["args"]})]
    events = index_by_trace(all_events).get(tid, [])
    instants = sorted([e for e in events if e.get("ph") == "i"],
                      key=lambda e: e.get("ts", 0))
    flows = sorted([e for e in events if e.get("ph") in ("s", "t", "f")],
                   key=lambda e: e.get("ts", 0))
    pids = sorted({e.get("pid") for e in events
                   if e.get("pid") is not None} |
                  {s["pid"] for s in spans if s["pid"] is not None})
    flow_pids = {e.get("pid") for e in flows}
    starts = [e for e in flows if e.get("ph") == "s"]
    ends = [e for e in flows if e.get("ph") in ("t", "f")]
    crossed = {(s.get("pid"), e.get("pid"))
               for s in starts for e in ends
               if s.get("pid") != e.get("pid")}
    connected = (len(pids) <= 1 or
                 (bool(crossed) and all(p in flow_pids for p in pids)))
    return {"trace_id": str(trace_id), "pids": pids, "spans": spans,
            "instants": instants, "flows": flows,
            "flow_hops": sorted(crossed), "connected": connected}


def _fmt_summary(s: dict, stream=None) -> None:
    stream = stream or sys.stdout
    t0 = min([sp["ts"] for sp in s["spans"]] +
             [e.get("ts", 0) for e in s["instants"]] or [0])
    print(f"trace {s['trace_id']}: {len(s['spans'])} spans across "
          f"{len(s['pids'])} process(es) {s['pids']}, "
          f"{'connected' if s['connected'] else 'NOT connected'}",
          file=stream)
    for hop in s["flow_hops"]:
        print(f"  flow: pid {hop[0]} -> pid {hop[1]}", file=stream)
    for sp in s["spans"]:
        dur = (f"{sp['dur_us'] / 1e3:9.3f}ms" if sp["dur_us"] is not None
               else "     open")
        print(f"  +{(sp['ts'] - t0) / 1e3:9.3f}ms {dur}  "
              f"pid={sp['pid']:<8} {sp['name']}", file=stream)
    for ev in s["instants"]:
        print(f"  +{(ev.get('ts', 0) - t0) / 1e3:9.3f}ms   <event>    "
              f"pid={ev.get('pid'):<8} {ev.get('name')}", file=stream)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="zoo-trace",
        description="merge per-process Chrome traces; query by trace id")
    sub = ap.add_subparsers(dest="command", required=True)
    p_merge = sub.add_parser("merge", help="merge trace-*.json files")
    p_merge.add_argument("--dir", required=True,
                         help="trace directory (--trace-dir of the run)")
    p_merge.add_argument("-o", "--out", default=None,
                         help="output path (default: <dir>/merged.json)")
    p_merge.add_argument("--extra", action="append", default=[],
                         help="another trace file, or a directory whose "
                              "trace-*.json files are merged too "
                              "(repeatable)")
    p_ls = sub.add_parser("ls", help="list trace ids in a trace dir")
    p_ls.add_argument("--dir", required=True)
    p_show = sub.add_parser("show", help="print one request's span tree")
    p_show.add_argument("trace_id")
    p_show.add_argument("--dir", required=True)
    args = ap.parse_args(argv)

    extra = []
    for path in getattr(args, "extra", []):
        extra.extend(_trace_files(path) if os.path.isdir(path) else [path])
    merged = merge_trace_dir(args.dir, extra_files=extra)
    if args.command == "merge":
        out = args.out or os.path.join(args.dir, "merged.json")
        with open(out, "w") as f:
            json.dump(merged, f)
        n = len(merged["traceEvents"])
        print(f"merged {merged['otherData']['merged_from']} trace file(s), "
              f"{n} events -> {out}")
        return 0
    per_trace = index_by_trace(merged.get("traceEvents") or [])
    if args.command == "ls":
        if not per_trace:
            print("no trace ids found (was the run tagged? see "
                  "docs/observability.md#tracing)")
            return 1
        for tid in sorted(per_trace):
            evs = per_trace[tid]
            pids = {e.get("pid") for e in evs}
            print(f"{tid}  events={len(evs)} pids={len(pids)}")
        return 0
    s = trace_summary(merged, args.trace_id)
    if not s["spans"] and not s["instants"] and not s["flows"]:
        print(f"trace id {args.trace_id!r} not found under {args.dir}",
              file=sys.stderr)
        return 1
    _fmt_summary(s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
