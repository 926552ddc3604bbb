from .text_model import TextKerasModel
from .ner import NER
from .pos_tagging import SequenceTagger
from .intent_extraction import IntentEntity

__all__ = ["TextKerasModel", "NER", "SequenceTagger", "IntentEntity"]
