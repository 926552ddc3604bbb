"""``rank_hinge`` through ``fit`` on KNRM at its full width (query 10,
document 40, 20,000 words, 300-d, 21 kernels, ranking; ``chip_smoke.py``'s
``sequence`` leg: 128 interleaved (relevant, irrelevant) pairs, one batch
of 256, 4 Adam steps at 1e-3), on the CPU.

``RankHinge`` pairs consecutive rows of a batch. Fed as an
``ArrayFeatureSet``, ``fit`` shuffles single rows each epoch and so
pairs them at random; fed as ``chip_smoke.RankingPairs``, which
shuffles whole pairs, it trains on the pairs as built (ROADMAP C8).
Run from the repo root::

    python tools/knrm_rank_hinge_pairs.py

Prints the 4 step losses of each.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from analytics_zoo_tpu_torch.common import nncontext  # noqa: E402
from analytics_zoo_tpu_torch.feature.feature_set import \
    ArrayFeatureSet  # noqa: E402


def main():
    nncontext.init_nncontext(device="cpu")
    for name, feature_set in (("rows shuffled (ArrayFeatureSet)",
                               ArrayFeatureSet),
                              ("pairs shuffled (RankingPairs)",
                               cs.RankingPairs)):
        rs = np.random.default_rng(46)
        x, y = cs.knrm_pairs(rs, cs.KNRM_PAIRS)
        model = cs.seeded_zoo_model(lambda: cs.KNRM(
            cs.KNRM_L1, cs.KNRM_L2, cs.KNRM_VOCAB, embed_size=cs.KNRM_EMBED,
            kernel_num=cs.KNRM_KERNELS, target_mode="ranking"), 46)
        model.compile(cs.Adam(lr=1e-3), "rank_hinge")
        model.fit(feature_set(x, y), batch_size=cs.KNRM_PAIRS,
                  nb_epoch=cs.SEQ_FIT_STEPS)
        print(name, model.model.trainer.step_losses)


if __name__ == "__main__":
    main()
