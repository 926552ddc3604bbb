"""The trainer's input path alone, on one CUDA card: host batches made
into device tensors the step may read, with no step between them.

Three paths over the same in-memory rows, in windows of one call whose
order rotates (inline, prefetched, staged; prefetched, staged, inline;
...):

- ``inline``: the feature set's ``batches`` and ``SPMDTrainer.put_batch``
  (``as_device_tensor``: a pageable copy an array), the trainer's input
  before the staged pipeline;
- ``prefetched``: ``build_host_pipeline`` (the prefetch thread) and the
  same pageable copies: the thread's hand-off alone;
- ``staged``: ``build_host_pipeline`` and a ``DeviceStagingIterator``
  over ``PinnedStager`` (pinned ring, side stream, one event a batch),
  the step's stream waiting on each event, as ``SPMDTrainer._run_epoch``
  feeds the step.

A window is one epoch between two ``torch.cuda.synchronize`` calls; its
number is wall over batches. Shapes: ``chip_smoke``'s NeuralCF batch
(8,192 rows of two float32 ids, int32 labels) and ResNet-50 batch (256
float32 3 x 224 x 224 images, int32 labels). Prints one JSON line a
shape (each path's window times and p50; staged against inline, pair
by pair) and writes
them to ``--out`` when given. Needs a card:

    python tools/input_path_ab.py [--windows 8] [--out result.json]
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _shapes(seed):
    import numpy as np

    import chip_smoke as cs
    x, y = cs.ncf_data(seed)
    yield "ncf", cs.NCF_BATCH, x, y
    x, y = cs.resnet_data(seed, 4 * cs.RESNET_BATCH)
    yield "resnet", cs.RESNET_BATCH, x, y.astype(np.int32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    from analytics_zoo_tpu_torch.common.nncontext import init_nncontext
    from analytics_zoo_tpu_torch.feature.feature_set import ArrayFeatureSet
    from analytics_zoo_tpu_torch.feature.host_pipeline import (
        DeviceStagingIterator, build_host_pipeline)
    from analytics_zoo_tpu_torch.pipeline.engine import (PinnedStager,
                                                         as_device_tensor)
    if not torch.cuda.is_available():
        sys.exit("input_path_ab.py: no CUDA device is visible")
    device = init_nncontext().device
    stream = torch.cuda.current_stream(device)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    results = []
    for name, batch, x, y in _shapes(args.seed):
        fs = ArrayFeatureSet(x, y)
        n = fs.num_batches(batch, True)
        stager = PinnedStager(device, depth=2)

        def inline(epoch):
            for xs, ys, w in fs.batches(batch, shuffle=True, seed=epoch):
                [as_device_tensor(a, device) for a in (*xs, ys, w)]

        def prefetched(epoch):
            it = build_host_pipeline(fs, batch, shuffle=True, seed=epoch)
            try:
                for xs, ys, w in it:
                    [as_device_tensor(a, device) for a in (*xs, ys, w)]
            finally:
                it.close()

        def staged(epoch):
            it = build_host_pipeline(fs, batch, shuffle=True, seed=epoch)
            staging = DeviceStagingIterator(it, stager.put,
                                            stager.put_stacked, depth=2)
            try:
                while True:
                    chunk = staging.next_chunk(1)
                    if chunk is None:
                        break
                    stream.wait_event(chunk.singles[0][1])
            finally:
                staging.close()
                it.close()

        paths = {"inline": inline, "prefetched": prefetched,
                 "staged": staged}
        names = list(paths)
        times = {p: [] for p in names}
        for p in paths.values():   # warm-up: allocations, pinned buffers
            p(0)
        for i in range(args.windows):
            for p in names[i % 3:] + names[:i % 3]:
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                paths[p](i + 1)
                torch.cuda.synchronize(device)
                times[p].append((time.perf_counter() - t0) / n * 1e6)
        diffs = [s - i for i, s in zip(times["inline"], times["staged"])]
        res = {"shape": name, "batch": batch, "batches_a_window": n,
               "us_per_batch": times,
               "inline_p50_us": statistics.median(times["inline"]),
               "prefetched_p50_us": statistics.median(times["prefetched"]),
               "staged_p50_us": statistics.median(times["staged"]),
               "pair_diff_p50_us": statistics.median(diffs),
               "pairs_staged_slower": sum(d > 0 for d in diffs),
               "card": smi}
        print(json.dumps(res), flush=True)
        results.append(res)
        del fs, x, y
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
