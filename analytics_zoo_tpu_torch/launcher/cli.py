"""The launcher's CLI (counterpart of ``analytics_zoo_tpu/launcher/cli.py``).

Usage::

    python -m analytics_zoo_tpu_torch.launcher.cli --hosts 2 train.py --epochs 3
    python -m analytics_zoo_tpu_torch.launcher.cli --hosts 4 \
        --on-failure report --env ZOO_TPU_SEED=7 train.py
    python -m analytics_zoo_tpu_torch.launcher.cli --hosts-file hosts.txt \
        train.py   # localhost rows today

Everything after the script path is passed to the script verbatim.
Exits with the first nonzero worker exit code (0 on success).
"""

from __future__ import annotations

import argparse
import logging
import sys

from .launch import LaunchError, launch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="zoo-launch",
        description="Launch a training script as an N-process job: "
                    "coordinator bootstrap, ZOO_TPU_* env propagation, "
                    "prefixed log fan-in, child health supervision.")
    ap.add_argument("--hosts", "-n", type=int, default=None, metavar="N",
                    help="number of worker processes (default: 1, or the "
                         "hosts-file slot total)")
    ap.add_argument("--hosts-file", default=None, metavar="FILE",
                    help="MPI-style 'host [slots]' file; only localhost "
                         "rows are launchable today")
    ap.add_argument("--env", action="append", default=[], metavar="K=V",
                    help="extra env var for every worker (repeatable); "
                         "e.g. --env ZOO_TPU_DATA_PARALLEL=4")
    ap.add_argument("--on-failure",
                    choices=("kill-all", "report", "restart"),
                    default="kill-all",
                    help="kill-all: first nonzero exit terminates the "
                         "rest (default); report: let survivors finish "
                         "and report at the end; restart: tear down the "
                         "gang and relaunch it (workers auto-resume from "
                         "the latest checkpoint)")
    ap.add_argument("--max-restarts", type=int, default=3, metavar="N",
                    help="with --on-failure restart: give up after N "
                         "gang relaunches (default: 3)")
    ap.add_argument("--restart-backoff-s", type=float, default=1.0,
                    metavar="S",
                    help="with --on-failure restart: initial delay before "
                         "relaunching, doubled each attempt (default: 1.0)")
    ap.add_argument("--coordinator-port", type=int, default=None,
                    help="fixed coordination-service port (default: an "
                         "OS-assigned free port)")
    ap.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="enable telemetry: every worker writes "
                         "trace-<pid>.json + metrics-<pid>.json here, "
                         "and the launcher records gang lifecycle events "
                         "(see docs/observability.md)")
    ap.add_argument("--no-prefix", action="store_true",
                    help="disable the [worker-N] log line prefixes")
    ap.add_argument("script", help="training script to run on every host")
    ap.add_argument("script_args", nargs=argparse.REMAINDER,
                    help="arguments passed through to the script")
    return ap


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    extra_env = {}
    for kv in args.env:
        if "=" not in kv:
            print(f"zoo-launch: --env expects K=V, got {kv!r}",
                  file=sys.stderr)
            return 2
        k, v = kv.split("=", 1)
        extra_env[k] = v
    try:
        return launch([args.script, *args.script_args],
                      num_hosts=args.hosts, hosts_file=args.hosts_file,
                      env=extra_env, on_failure=args.on_failure,
                      coordinator_port=args.coordinator_port,
                      prefix=not args.no_prefix,
                      max_restarts=args.max_restarts,
                      restart_backoff_s=args.restart_backoff_s,
                      trace_dir=args.trace_dir)
    except LaunchError as e:
        print(f"zoo-launch: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
