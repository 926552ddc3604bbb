"""The TextClassifier's lstm and gru training steps at the news20
example's widths (``chip_smoke.py``'s ``sequence`` leg: 500 tokens, a
(5001, 200) table, encoder 256, batch 128, float32, TF32 off) with the
timesteps unbound (``recurrent.timesteps``, the layers' code) against
indexed one at a time (``xw[:, t]`` a step: each timestep's backward
then fills and adds a whole (B, T, G) gradient), on one CUDA card.

The two run in alternating windows of 5 synchronised steps in one call
(unbound, indexed, indexed, unbound): each step's wall on the host
clock, the p50, each window's peak memory, then one step of each under
``torch.profiler`` (launches, device busy, idle share, time by kernel
group). Run from the repo root on a machine with the card::

    python tools/recurrent_timesteps_ab.py

Prints one line per encoder and variant and writes everything to
``chiprun_out/recurrent_timesteps_ab.json``.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import \
    recurrent  # noqa: E402


def indexed(xw, U, parts=None):
    """``recurrent.timesteps`` with each timestep indexed out of ``xw``."""
    if parts is None:
        return [xw[:, t] for t in range(xw.shape[1])], U
    return [tuple(p[:, t] for p in xw.split(parts, dim=-1))
            for t in range(xw.shape[1])], U.split(parts, dim=1)


def main():
    if not torch.cuda.is_available():
        sys.exit("recurrent_timesteps_ab.py: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.init_nncontext()
    smi = cs.nvidia_smi("name,power.limit")
    variants = {"unbound": recurrent.timesteps, "indexed": indexed}
    table = np.random.default_rng(40).standard_normal(
        (cs.TC_MAX_WORDS + 1, cs.TC_TOKEN_LEN)).astype(np.float32)
    x, y = cs.text_data(41, cs.TC_BATCH)
    out = {"card": smi}
    try:
        for enc in ("lstm", "gru"):
            model = cs.seeded_zoo_model(lambda: cs.TextClassifier(
                cs.TC_CLASSES, table, sequence_length=cs.TC_SEQ_LEN,
                encoder=enc, encoder_output_dim=cs.TC_ENCODER_DIM), 43)
            model.compile(cs.Adagrad(lr=cs.TC_LR),
                          "sparse_categorical_crossentropy")
            model.fit(x, y, batch_size=cs.TC_BATCH, nb_epoch=1)
            trainer = model.model.trainer
            batch = trainer.put_batch(([x], y, np.ones(len(y), np.float32)))
            steps = {v: [] for v in variants}
            peaks = {v: [] for v in variants}
            for v in ("unbound", "indexed", "indexed", "unbound"):
                recurrent.timesteps = variants[v]
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                for _ in range(cs.TC_TIMED_STEPS):
                    t0 = time.perf_counter()
                    trainer.train_step(batch)
                    torch.cuda.synchronize()
                    steps[v].append(1e3 * (time.perf_counter() - t0))
                peaks[v].append(torch.cuda.max_memory_allocated())
            out[enc] = {}
            for v, fn in variants.items():
                recurrent.timesteps = fn
                prof = cs.profile_device(lambda: trainer.train_step(batch))
                out[enc][v] = dict(
                    step_ms=steps[v], step_p50_ms=cs.percentile(steps[v], 50),
                    peak_memory_bytes=max(peaks[v]),
                    launches=sum(g["launches"] for g in
                                 prof["groups"].values()),
                    device_busy_ms=prof["device_busy_ms"],
                    idle_share=prof["idle_share"], groups=prof["groups"])
                r = out[enc][v]
                print(enc, v, "p50_ms", r["step_p50_ms"], "launches",
                      r["launches"], "busy_ms", r["device_busy_ms"], "idle",
                      r["idle_share"], "peak", r["peak_memory_bytes"],
                      flush=True)
            recurrent.timesteps = variants["unbound"]
            del model, trainer, batch
            cs.collect()
    finally:
        recurrent.timesteps = variants["unbound"]
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/recurrent_timesteps_ab.json", "w") as f:
        json.dump(out, f, indent=1)
    print(smi)


if __name__ == "__main__":
    main()
