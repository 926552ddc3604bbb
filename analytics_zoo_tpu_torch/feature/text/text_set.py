"""TextSet: text corpus abstraction with the tokenize→normalize→word2idx→
shapeSequence→sample pipeline and relation (ranking) dataset builders.

Counterpart of ``analytics_zoo_tpu/feature/text/text_set.py``, a
numpy-only copy (parity: ``zoo/.../feature/text/TextSet.scala:43-247``,
read:290, readCSV:345, readParquet:372, fromRelationPairs:399,
fromRelationLists:503; and ``pyzoo/zoo/feature/text/text_set.py``). The
corpus is local and in memory; a ``DistributedTextSet`` is one shard of
it. Word-index generation is a host-side pass; ``to_feature_set`` stacks
the samples into an ``ArrayFeatureSet`` that ``fit`` copies to the
device batch by batch. pyarrow is imported only for parquet.
"""

from __future__ import annotations

import csv
import os
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..common import Relation, Relations
from ..feature_set import FeatureSet, Sample
from .text_feature import TextFeature
from .transformer import (Normalizer, SequenceShaper, TextFeatureToSample,
                          Tokenizer, WordIndexer)


class TextSet:
    def __init__(self, features: List[TextFeature]):
        self.features = features
        self.word_index: Optional[Dict[str, int]] = None

    # -- factories -----------------------------------------------------
    @classmethod
    def array(cls, features: Sequence[TextFeature]) -> "LocalTextSet":
        return LocalTextSet(list(features))

    @classmethod
    def read(cls, path: str, shard_index: int = 0,
             num_shards: int = 1) -> "TextSet":
        """Read a folder whose immediate sub-dirs are category names, each
        containing text files (TextSet.scala:290-330). Labels are
        zero-based sorted category indices."""
        cats = sorted(d for d in os.listdir(path)
                      if os.path.isdir(os.path.join(path, d)))
        feats = []
        for label, cat in enumerate(cats):
            for fn in sorted(os.listdir(os.path.join(path, cat))):
                fp = os.path.join(path, cat, fn)
                if not os.path.isfile(fp):
                    continue
                with open(fp, encoding="utf-8", errors="ignore") as f:
                    feats.append(TextFeature(f.read(), label, uri=fp))
        feats = feats[shard_index::num_shards]
        return LocalTextSet(feats) if num_shards == 1 else \
            DistributedTextSet(feats, shard_index, num_shards)

    @classmethod
    def read_csv(cls, path: str) -> "LocalTextSet":
        """csv rows uri,text (TextSet.scala:345)."""
        feats = []
        with open(path, newline="", encoding="utf-8") as f:
            for row in csv.reader(f):
                if len(row) >= 2:
                    feats.append(TextFeature(row[1], uri=row[0]))
        return LocalTextSet(feats)

    @classmethod
    def read_parquet(cls, path: str) -> "LocalTextSet":
        import pyarrow.parquet as pq

        d = pq.read_table(path).to_pydict()
        return LocalTextSet([TextFeature(t, uri=str(u))
                             for u, t in zip(d["uri"], d["text"])])

    # -- relation builders (ranking) ------------------------------------
    @classmethod
    def from_relation_pairs(cls, relations: Sequence[Relation],
                            corpus1: "TextSet", corpus2: "TextSet",
                            seed: Optional[int] = 0) -> "LocalTextSet":
        """Pairwise training set (TextSet.scala:399-483): for each relation
        pair, feature is the (2, len1+len2) stack of [text1 ++ text2_pos]
        and [text1 ++ text2_neg], label [[1], [0]]."""
        map1 = corpus1._indices_by_uri("corpus1")
        map2 = corpus2._indices_by_uri("corpus2")
        pairs = Relations.generate_relation_pairs(relations, seed)
        feats = []
        for p in pairs:
            i1 = map1[p.id1]
            pos, neg = map2[p.id2_positive], map2[p.id2_negative]
            assert len(pos) == len(neg), \
                "corpus2 contains texts with different lengths, please " \
                "shape_sequence first"
            feature = np.stack([np.concatenate([i1, pos]),
                                np.concatenate([i1, neg])]).astype(np.float32)
            tf = TextFeature(uri=p.id1 + p.id2_positive + p.id2_negative)
            tf[TextFeature.sample] = Sample(
                feature, np.array([[1.0], [0.0]], np.float32))
            feats.append(tf)
        return LocalTextSet(feats)

    @classmethod
    def from_relation_lists(cls, relations: Sequence[Relation],
                            corpus1: "TextSet",
                            corpus2: "TextSet") -> "LocalTextSet":
        """Listwise evaluation set (TextSet.scala:503-560): one TextFeature
        per id1 with feature (listLength, len1+len2) and label
        (listLength, 1)."""
        map1 = corpus1._indices_by_uri("corpus1")
        map2 = corpus2._indices_by_uri("corpus2")
        by_id1: Dict[str, List[Relation]] = {}
        for r in relations:
            by_id1.setdefault(r.id1, []).append(r)
        feats = []
        for id1, rels in by_id1.items():
            i1 = map1[id1]
            rows = [np.concatenate([i1, map2[r.id2]]) for r in rels]
            labels = np.array([[float(r.label)] for r in rels], np.float32)
            tf = TextFeature(uri=id1 + "".join(r.id2 for r in rels))
            tf[TextFeature.sample] = Sample(
                np.stack(rows).astype(np.float32), labels)
            feats.append(tf)
        return LocalTextSet(feats)

    def _indices_by_uri(self, name: str) -> Dict[str, np.ndarray]:
        out = {}
        for f in self.features:
            idx = f.get_indices()
            assert idx is not None, \
                f"{name} hasn't been transformed from word to index yet, " \
                "please word2idx first"
            out[f.get_uri()] = idx
        return out

    # -- surface -------------------------------------------------------
    def is_local(self):
        return isinstance(self, LocalTextSet)

    def is_distributed(self):
        return isinstance(self, DistributedTextSet)

    def to_local(self):
        ts = LocalTextSet(self.features)
        ts.word_index = self.word_index
        return ts

    def to_distributed(self, shard_index=0, num_shards=1):
        ts = DistributedTextSet(self.features, shard_index, num_shards)
        ts.word_index = self.word_index
        return ts

    def transform(self, transformer, num_workers: int = 0) -> "TextSet":
        """Apply a text transformer to every feature. ``num_workers > 0``
        runs it on an ordered thread pool (``ZOO_TPU_TRANSFORM_WORKERS``
        sets the default) — worthwhile for chains that release the GIL or
        do numpy-heavy shaping on large corpora."""
        if num_workers == 0:
            env = os.environ.get("ZOO_TPU_TRANSFORM_WORKERS")
            if env:
                num_workers = int(env)
        if num_workers and num_workers > 0 and len(self.features) > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=num_workers,
                                    thread_name_prefix="zoo-text") as pool:
                self.features = list(pool.map(transformer.apply,
                                              self.features))
        else:
            self.features = [transformer.apply(f) for f in self.features]
        return self

    def get_texts(self):
        return [f.get_text() for f in self.features]

    def get_uris(self):
        return [f.get_uri() for f in self.features]

    def get_labels(self):
        return [f.get_label() for f in self.features]

    def get_predicts(self):
        return [(f.get_uri(), f.get_predict()) for f in self.features]

    def get_samples(self):
        return [f.get_sample() for f in self.features]

    def random_split(self, weights: Sequence[float], seed: int = 0):
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(self.features))
        total = float(sum(weights))
        out, start = [], 0
        for w in weights[:-1]:
            n = int(len(idx) * w / total)
            out.append([self.features[i] for i in idx[start:start + n]])
            start += n
        out.append([self.features[i] for i in idx[start:]])
        sets = []
        for chunk in out:
            ts = type(self)(chunk)
            ts.word_index = self.word_index
            sets.append(ts)
        return sets

    def __len__(self):
        return len(self.features)

    # -- pipeline sugar (TextSet.scala:120-247) -------------------------
    def tokenize(self) -> "TextSet":
        return self.transform(Tokenizer())

    def normalize(self) -> "TextSet":
        return self.transform(Normalizer())

    def word2idx(self, remove_topN: int = 0, max_words_num: int = -1,
                 min_freq: int = 1,
                 existing_map: Optional[Dict[str, int]] = None) -> "TextSet":
        self.generate_word_index_map(remove_topN, max_words_num, min_freq,
                                     existing_map)
        return self.transform(WordIndexer(self.word_index))

    def shape_sequence(self, len: int, trunc_mode: str = "pre",
                       pad_element: int = 0) -> "TextSet":
        return self.transform(SequenceShaper(len, trunc_mode, pad_element))

    def generate_sample(self) -> "TextSet":
        return self.transform(TextFeatureToSample())

    def generate_word_index_map(self, remove_topN: int = 0,
                                max_words_num: int = -1, min_freq: int = 1,
                                existing_map: Optional[Dict[str, int]] = None
                                ) -> Dict[str, int]:
        """Frequency-ranked word index starting from 1 (0 = OOV), with
        optional head removal / cap / frequency floor
        (TextSet.scala:125-186)."""
        counter: Counter = Counter()
        for f in self.features:
            tokens = f.get_tokens()
            assert tokens is not None, "please tokenize first"
            counter.update(tokens)
        freq = [(w, c) for w, c in counter.most_common() if c >= min_freq]
        freq = freq[remove_topN:]
        if max_words_num > 0:
            freq = freq[:max_words_num]
        index = dict(existing_map) if existing_map else {}
        next_idx = max(index.values()) + 1 if index else 1
        for w, _ in freq:
            if w not in index:
                index[w] = next_idx
                next_idx += 1
        self.word_index = index
        return index

    def get_word_index(self) -> Optional[Dict[str, int]]:
        return self.word_index

    def set_word_index(self, vocab: Dict[str, int]) -> "TextSet":
        self.word_index = vocab
        return self

    def save_word_index(self, path: str):
        assert self.word_index, "word_index not generated yet"
        with open(path, "w", encoding="utf-8") as f:
            for w, i in self.word_index.items():
                f.write(f"{w} {i}\n")

    def load_word_index(self, path: str) -> "TextSet":
        index = {}
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.rsplit(" ", 1)
                if len(parts) == 2:
                    index[parts[0]] = int(parts[1])
        self.word_index = index
        return self

    # -- to training data ----------------------------------------------
    def to_feature_set(self) -> FeatureSet:
        samples = self.get_samples()
        assert all(s is not None for s in samples), \
            "please generate_sample first"
        return FeatureSet.samples(samples)

    to_dataset = to_feature_set


class LocalTextSet(TextSet):
    pass


class DistributedTextSet(TextSet):
    def __init__(self, features, shard_index: int = 0, num_shards: int = 1):
        super().__init__(features)
        self.shard_index = int(shard_index)
        self.num_shards = int(num_shards)
