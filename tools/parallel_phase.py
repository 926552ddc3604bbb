"""``chip_smoke.py``'s ``parallel`` phase alone on one CUDA card: data
and sequence parallelism (legs A-C) and tensor, pipeline and expert
parallelism and FSDP (legs D-G) through the launcher (see the script's
docstring), after building the kernels, with TF32 off. Prints the
phase's seconds and each leg's report, and writes the whole report to
``chiprun_out/parallel_report.json``:

    python tools/parallel_phase.py [--seed N] [--ranks N] [--layout-only]

``--ranks`` sets the ranks of legs B-G (two by default, sharing one card
over gloo); on a machine with that many cards each rank has its own,
over NCCL (the backend rule of ``common/nncontext.py``): at four, legs
D-G run tp = 4, pp = 4, ep = 4 and dp = 4. ``--layout-only`` runs legs
D-G alone (their in-process float32 references, then one launch).
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--layout-only", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs

    cs.PAR_RANKS = args.ranks
    cs._kernels.library()
    cs.init_nncontext()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi("name,power.limit")
    print(smi, flush=True)
    t0 = time.perf_counter()
    if args.layout_only:
        report, launches = cs.layout_phase(args.seed, smi)
        legs = list(report["legs_d_to_g"].items())
    else:
        report, launches = cs.parallel_phase(
            args.seed, torch.device("cuda", 0), smi)
        legs = [(leg, report[leg]) for leg in ("leg_a", "leg_b", "leg_c")]
        legs += list(report["legs_d_to_g"].items())
    out = os.path.join(REPO, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    name = "parallel_report" + ("_layout" if args.layout_only else "") + \
        ("" if args.ranks == 2 else f"_{args.ranks}") + ".json"
    with open(os.path.join(out, name), "w") as f:
        json.dump(report, f, indent=1)
    print("PHASE_S", time.perf_counter() - t0, "launches", launches,
          flush=True)
    for leg, body in legs:
        print(leg, json.dumps(body)[:2500], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
