"""TFPark's text models (NER, SequenceTagger, IntentEntity) and the BERT
estimators (counterpart of ``analytics_zoo_tpu/tfpark/text``)."""

from .keras import NER, IntentEntity, SequenceTagger, TextKerasModel
from .estimator import (BERTBaseEstimator, BERTClassifier, BERTNER,
                        BERTSQuAD, bert_input_fn)

__all__ = ["TextKerasModel", "NER", "SequenceTagger", "IntentEntity",
           "BERTBaseEstimator", "BERTClassifier", "BERTNER", "BERTSQuAD",
           "bert_input_fn"]
