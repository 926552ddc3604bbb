"""Run a command and record the processes that appear while it runs and
those that are still there after it exits (a leak check for
``chip_smoke.py``, whose contract is to stop every process it starts).

    python tools/process_watch.py TAG [--out DIR] [--after 0,1,3,10,30] \
        -- COMMAND [ARG ...]

The command's standard output and error go to ``DIR/TAG_stdout.log`` and
``DIR/TAG_stderr.log`` (``DIR`` defaults to ``chiprun_out/``). Every 2 s
it lists the processes that were not there before the command started.
After the command exits it lists them again at each of ``--after``'s
seconds (pid, parent, session, state, when first seen, command line),
and writes everything to ``DIR/TAG_procs.json``. Exits with the
command's code. Run it where nothing else starts processes meanwhile:
it counts every process that is new.
"""

import argparse
import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AFTER_S = "0,1,3,10,30"


def snapshot():
    """pid -> state, parent, process group, session, name and command
    line, for every process that /proc shows but the kernel's threads."""
    rows = {}
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        rest = stat[stat.rindex(")") + 2:].split()
        if pid == "2" or rest[1] == "2":
            continue
        rows[int(pid)] = dict(
            state=rest[0], ppid=int(rest[1]), pgrp=int(rest[2]),
            sid=int(rest[3]), comm=stat[stat.index("(") + 1:stat.rindex(")")],
            cmd=cmd[:300])
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tag")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out"))
    ap.add_argument("--after", default=AFTER_S,
                    help="seconds after the command's exit at which to "
                         "list the processes left, comma-separated")
    argv = sys.argv[1:]
    if "--" not in argv:
        ap.error("give the command after --")
    cut = argv.index("--")
    args, cmd = ap.parse_args(argv[:cut]), argv[cut + 1:]
    os.makedirs(args.out, exist_ok=True)
    base, me = set(snapshot()), os.getpid()
    seen, t0, stop = {}, time.time(), threading.Event()

    def poll():
        while not stop.is_set():
            now = time.time() - t0
            for pid, row in snapshot().items():
                if pid in base or pid == me:
                    continue
                entry = seen.setdefault(pid, dict(row, first=now))
                entry.update(last=now, state=row["state"],
                             ppid_now=row["ppid"])
            stop.wait(2.0)

    watcher = threading.Thread(target=poll, daemon=True)
    watcher.start()
    path = os.path.join(args.out, args.tag)
    with open(f"{path}_stdout.log", "w") as out, \
            open(f"{path}_stderr.log", "w") as err:
        rc = subprocess.Popen(cmd, stdout=out, stderr=err).wait()
    end = time.time() - t0
    stop.set()
    watcher.join()
    print(f"{args.tag}: rc={rc} seconds={end:.1f}", flush=True)
    left, waited = {}, 0.0
    for at in sorted(float(a) for a in args.after.split(",")):
        time.sleep(at - waited)
        waited = at
        rows = {pid: row for pid, row in snapshot().items()
                if pid not in base and pid != me}
        print(f"  +{at:g}s after exit: {len(rows)} processes not "
              f"there before", flush=True)
        for pid, row in rows.items():
            first = seen.get(pid, {}).get("first")
            print(f"    pid {pid} ppid {row['ppid']} sid {row['sid']} "
                  f"{row['state']} first seen {first} s: {row['cmd'][:200]}",
                  flush=True)
            left.setdefault(f"+{at:g}s", {})[pid] = dict(row, first=first)
    with open(f"{path}_procs.json", "w") as f:
        json.dump(dict(rc=rc, seconds=end, seen=seen, left=left), f,
                  indent=0)
    return rc


if __name__ == "__main__":
    sys.exit(main())
