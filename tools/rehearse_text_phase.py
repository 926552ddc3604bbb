"""A CPU rehearsal of ``chip_smoke.py``'s ``text`` phase.

Runs ``text_phase`` on the CPU with the BERT estimators shrunk (hidden 64,
2 blocks, seq 64, vocab 2,000; the heads at 1 block) and NER at its full
NERCRF widths (``--small-ner`` shrinks it too), the card-only parts
stubbed (launch-count gates, ``nvidia-smi``, the profiler, CUDA
synchronisation). Prints the phase's report as one JSON line; leg B's
``min_viterbi_margin`` is the smallest gap between a sentence's best and
second-best tag path, the margin by which the card's tags may differ
from the CPU's without a fault:

    PYTHONPATH=. python tools/rehearse_text_phase.py [--small-ner]
"""

import argparse
import json

import torch

import chip_smoke as cs
from analytics_zoo_tpu_torch.common import nncontext


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small-ner", action="store_true")
    args = ap.parse_args()
    torch.cuda.synchronize = lambda *a, **k: None
    cs.BERT_CONFIG.update(vocab=2000, hidden_size=64, n_block=2, n_head=2,
                          seq_len=64, intermediate_size=128)
    cs.TEXT_HEAD_BLOCKS = 1
    cs.text_check_launches = lambda *a, **k: None
    cs.nvidia_smi = lambda query: "cpu"
    cs.profile_device = lambda fn, **kw: fn()
    if args.small_ner:
        cs.TEXT_NER_KW.update(word_emb_dim=20, char_emb_dim=6,
                              tagger_lstm_dim=20)
    nncontext.init_nncontext(device="cpu")
    report, _, _ = cs.text_phase(0, torch.device("cpu"), "cpu")
    print(json.dumps(report, default=str))


if __name__ == "__main__":
    main()
