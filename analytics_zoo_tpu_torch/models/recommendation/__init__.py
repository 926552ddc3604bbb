from .recommender import Recommender, UserItemFeature, UserItemPrediction
from .neuralcf import NeuralCF
from .wide_and_deep import ColumnFeatureInfo, WideAndDeep
from .session_recommender import SessionRecommender

__all__ = ["Recommender", "UserItemFeature", "UserItemPrediction",
           "NeuralCF", "ColumnFeatureInfo", "WideAndDeep",
           "SessionRecommender"]
