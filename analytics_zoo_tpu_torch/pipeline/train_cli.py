"""``zoo-train`` — live training observability CLI.

A copy of ``analytics_zoo_tpu/pipeline/train_cli.py`` over the port's
``utils/tensorboard.py``; run it as ``python -m
analytics_zoo_tpu_torch.pipeline.train_cli top|summary``. The event files
and ``metrics-<pid>.json`` snapshots are the same in both packages, so
either CLI reads either package's runs.

The training-side sibling of ``zoo-serving top`` (serving/cli.py): a
terminal view of a run's TrainSummary event files plus the telemetry
exporter's ``metrics-<pid>.json``, refreshed in place.

::

    python -m analytics_zoo_tpu_torch.pipeline.train_cli top \
        --logdir runs/logs/myapp [--trace-dir runs/trace]
    python -m analytics_zoo_tpu_torch.pipeline.train_cli summary \
        --logdir runs/logs/myapp

Data sources (both optional — the view renders whatever exists):

* ``--logdir``: a TrainSummary directory (``<log_dir>/<app>/train`` or
  any directory holding ``events.out.tfevents.*``) — loss, learning
  rate, throughput, step time, infeed-bound fraction, grad norm, the
  HBM breakdown scalars and the latched health state.
* ``--trace-dir``: the telemetry trace dir — the freshest
  ``metrics-<pid>.json`` supplies live ``zoo_hbm_*`` watermark gauges
  and ``zoo_train_health_state`` even before the next summary flush.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

from ..utils import tensorboard

# TrainSummary tags the view reads (engine._epoch_loop writes them)
_TAGS = ["Loss", "LearningRate", "Throughput", "StepTimeMs",
         "InfeedWaitMs", "InputBoundFraction", "GradNorm", "MFU",
         "HealthState", "HBMTotalMB", "HBMParamsMB", "HBMOptStateMB",
         "HBMActivationsMB", "HBMTransfersMB"]

_HEALTH_NAMES = {0: "OK", 1: "WARN (spike latched)",
                 2: "FAULT (non-finite latched)", 3: "HALTED"}


def _summary_dir(logdir: str) -> Optional[str]:
    """Accept either the app log root (``<log_dir>/<app>``) or the train
    subdir / any dir holding event files directly."""
    if not logdir or not os.path.isdir(logdir):
        return None
    for cand in (logdir, os.path.join(logdir, "train")):
        if glob.glob(os.path.join(cand, "events.out.tfevents.*")):
            return cand
    return None


def read_latest_scalars(logdir: str) -> Dict[str, Tuple[int, float]]:
    """Last (step, value) per tag from the TrainSummary event files."""
    d = _summary_dir(logdir)
    out: Dict[str, Tuple[int, float]] = {}
    if d is None:
        return out
    try:
        events = tensorboard.read_scalars(d)
    except Exception:  # noqa: BLE001 - partial/in-flight writes
        return out
    for step, _wall, tag, value in events:
        if tag in _TAGS:
            prev = out.get(tag)
            if prev is None or step >= prev[0]:
                out[tag] = (int(step), float(value))
    return out


def read_live_gauges(trace_dir: str) -> Dict[str, float]:
    """Flatten the freshest ``metrics-*.json`` exporter snapshot in
    ``trace_dir`` into ``{name{labels}: value}`` for gauges/counters."""
    out: Dict[str, float] = {}
    if not trace_dir:
        return out
    paths = sorted(glob.glob(os.path.join(trace_dir, "metrics-*.json")),
                   key=lambda p: os.path.getmtime(p), reverse=True)
    if not paths:
        return out
    try:
        with open(paths[0]) as f:
            snap = json.load(f)
    except (OSError, ValueError):
        return out
    for m in snap.get("metrics", []):
        if "value" not in m:
            continue
        labels = m.get("labels") or {}
        key = m["name"]
        if labels:
            key += "{" + ",".join(f"{k}={v}" for k, v in
                                  sorted(labels.items())) + "}"
        out[key] = m["value"]
    return out


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.1f} TiB"


def _val(scalars, tag):
    pair = scalars.get(tag)
    return pair[1] if pair else None


def render_status(logdir: str, trace_dir: Optional[str],
                  prev: Optional[dict] = None) -> List[str]:
    """One frame of the live view as printable lines. ``prev`` carries
    the last frame's (step, ts) so step/s can be derived between
    refreshes even when the run logs Throughput sparsely."""
    scalars = read_latest_scalars(logdir)
    gauges = read_live_gauges(trace_dir) if trace_dir else {}
    lines: List[str] = []
    if not scalars and not gauges:
        lines.append(f"  (no TrainSummary events under {logdir!r} yet"
                     + (f", no metrics snapshots under {trace_dir!r}"
                        if trace_dir else "") + ")")
        return lines
    step = max((s for s, _ in scalars.values()), default=0)
    loss = _val(scalars, "Loss")
    lr = _val(scalars, "LearningRate")
    head = f"  step {step}"
    if loss is not None:
        head += f"   loss {loss:.5g}"
    if lr is not None:
        head += f"   lr {lr:.3g}"
    lines.append(head)

    thr = _val(scalars, "Throughput")
    st_ms = _val(scalars, "StepTimeMs")
    wait_ms = _val(scalars, "InfeedWaitMs")
    bound = _val(scalars, "InputBoundFraction")
    mfu = _val(scalars, "MFU")
    row = []
    if st_ms:
        row.append(f"step time {st_ms:.1f} ms "
                   f"({1000.0 / max(st_ms, 1e-9):.1f} step/s)")
    if thr is not None:
        row.append(f"{thr:.1f} samples/s")
    if mfu is not None:
        row.append(f"MFU {mfu:.2f}")
    if row:
        lines.append("  " + "   ".join(row))
    if bound is not None:
        infeed = f"  infeed-bound {bound:.2f}"
        if wait_ms is not None:
            infeed += f" (wait {wait_ms:.1f} ms/step)"
        if bound > 0.1:
            infeed += "   <-- input-bound: the device is waiting on " \
                      "the host pipeline"
        lines.append(infeed)
    gn = _val(scalars, "GradNorm")
    if gn is not None:
        lines.append(f"  grad norm {gn:.4g}")

    total = _val(scalars, "HBMTotalMB")
    if total is not None:
        lines.append(
            "  HBM (train program): total "
            f"{total:.1f} MiB | params {_val(scalars, 'HBMParamsMB'):.1f}"
            f" | opt {_val(scalars, 'HBMOptStateMB'):.1f}"
            f" | act+temp {_val(scalars, 'HBMActivationsMB'):.1f}"
            f" | transfers {_val(scalars, 'HBMTransfersMB'):.1f}")
    # per-param-group optimizer-state breakout (ZeRO visibility): the
    # per-device gauge is where stage-1's 1/dp sharding shows up — the
    # global bytes stay flat across zero_stage, by design
    groups: Dict[str, Tuple[Optional[float], Optional[float]]] = {}
    for key, value in gauges.items():
        for name, slot in (
                ("zoo_hbm_program_opt_state_group_per_device_bytes{", 1),
                ("zoo_hbm_program_opt_state_group_bytes{", 0)):
            if key.startswith(name) and "program=train" in key:
                group = next((part.split("=", 1)[1] for part in
                              key[len(name):-1].split(",")
                              if part.startswith("group=")), None)
                if group is not None:
                    pair = list(groups.get(group, (None, None)))
                    pair[slot] = value
                    groups[group] = tuple(pair)
    if groups:
        lines.append("  opt state by group (global / per-device):")
        for group in sorted(groups):
            g_total, g_dev = groups[group]
            row = f"    {group:<24s}"
            row += _fmt_bytes(g_total) if g_total is not None else "?"
            if g_dev is not None:
                row += f" / {_fmt_bytes(g_dev)}"
            lines.append(row)
    in_use = {k: v for k, v in gauges.items()
              if k.startswith("zoo_hbm_bytes_in_use")}
    if in_use:
        peak = {k: v for k, v in gauges.items()
                if k.startswith("zoo_hbm_peak_bytes")}
        limit = {k: v for k, v in gauges.items()
                 if k.startswith("zoo_hbm_bytes_limit")}
        frac = gauges.get("zoo_hbm_watermark_fraction")
        row = (f"  HBM watermark: in-use {_fmt_bytes(sum(in_use.values()))}"
               f" peak {_fmt_bytes(sum(peak.values()))}")
        if limit:
            row += f" / {_fmt_bytes(sum(limit.values()))}"
        if frac is not None:
            row += f" ({100 * frac:.0f}%)"
        lines.append(row)

    health = gauges.get("zoo_train_health_state")
    if health is None:
        health = _val(scalars, "HealthState")
    if health is not None:
        name = _HEALTH_NAMES.get(int(health), str(health))
        lines.append(f"  health: {name}")
    return lines


def cmd_top(logdir: str, trace_dir: Optional[str] = None,
            interval: float = 2.0, iterations: Optional[int] = None) -> int:
    """Live training view, refreshed every ``interval`` seconds.
    ``iterations`` bounds the loop (tests / one-shot snapshots)."""
    done = 0
    try:
        while iterations is None or done < iterations:
            if sys.stdout.isatty():
                sys.stdout.write("\x1b[2J\x1b[H")
            print(f"zoo-train top  {time.strftime('%H:%M:%S')}  "
                  f"(refresh {interval:g}s, Ctrl-C to exit)")
            for line in render_status(logdir, trace_dir):
                print(line)
            sys.stdout.flush()
            done += 1
            if iterations is None or done < iterations:
                time.sleep(interval)
    except KeyboardInterrupt:
        pass
    return 0


def cmd_summary(logdir: str, trace_dir: Optional[str] = None) -> int:
    """One-shot machine-readable dump (JSON) of the same view."""
    scalars = read_latest_scalars(logdir)
    payload = {
        "logdir": logdir,
        "scalars": {tag: {"step": s, "value": v}
                    for tag, (s, v) in sorted(scalars.items())},
    }
    if trace_dir:
        payload["gauges"] = read_live_gauges(trace_dir)
    print(json.dumps(payload, indent=2, sort_keys=True))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="zoo-train")
    ap.add_argument("command", choices=["top", "summary"])
    ap.add_argument("--logdir", default=".",
                    help="TrainSummary directory: <log_dir>/<app> as "
                         "passed to set_tensorboard, its train/ subdir, "
                         "or any directory with events.out.tfevents.*")
    ap.add_argument("--trace-dir", default=None,
                    help="telemetry trace dir (--trace-dir of the run / "
                         "ZOO_TPU_TRACE_DIR): live zoo_hbm_* watermarks "
                         "and health state from metrics-<pid>.json")
    ap.add_argument("--interval", default=2.0, type=float,
                    help="top: refresh period in seconds")
    ap.add_argument("--iterations", default=None, type=int,
                    help="top: stop after N refreshes (default: forever)")
    args = ap.parse_args(argv)
    logdir = os.path.abspath(args.logdir)
    if args.command == "top":
        return cmd_top(logdir, trace_dir=args.trace_dir,
                       interval=args.interval, iterations=args.iterations)
    return cmd_summary(logdir, trace_dir=args.trace_dir)


if __name__ == "__main__":
    sys.exit(main())
