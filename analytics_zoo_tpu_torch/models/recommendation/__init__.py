from .recommender import Recommender, UserItemFeature, UserItemPrediction
from .neuralcf import NeuralCF
from .wide_and_deep import ColumnFeatureInfo, WideAndDeep

__all__ = ["Recommender", "UserItemFeature", "UserItemPrediction",
           "NeuralCF", "ColumnFeatureInfo", "WideAndDeep"]
