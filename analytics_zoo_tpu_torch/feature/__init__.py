from .feature_set import (ArrayFeatureSet, FeatureSet, MiniBatch, Sample,
                          stack_samples)

__all__ = ["ArrayFeatureSet", "FeatureSet", "MiniBatch", "Sample",
           "stack_samples"]
