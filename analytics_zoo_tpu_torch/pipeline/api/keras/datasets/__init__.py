"""Keras-style dataset loaders (parity: ``pyzoo/zoo/pipeline/api/keras/
datasets/{mnist,imdb,boston_housing,reuters}.py``).

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/datasets/``, copied:
the same files read, the same seeded surrogates returned.

The reference loaders download public archives into ``/tmp/.zoo/dataset``.
This environment has no egress, so each loader first looks for the real
cached files in the reference's standard layout (and parses them — e.g.
the MNIST idx/gzip format); when absent it synthesizes a deterministic
surrogate with the exact shapes, dtypes and signature semantics
(``nb_words``/``oov_char``/``test_split``...) and logs a warning, so
example/tutorial code written against the reference runs unmodified.
"""

from . import boston_housing, imdb, mnist, reuters

__all__ = ["mnist", "imdb", "boston_housing", "reuters"]
