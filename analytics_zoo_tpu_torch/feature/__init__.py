from .feature_set import ArrayFeatureSet, FeatureSet, MiniBatch

__all__ = ["ArrayFeatureSet", "FeatureSet", "MiniBatch"]
