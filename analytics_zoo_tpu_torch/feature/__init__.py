from .common import (ArrayToTensor, BigDLAdapter, ChainedPreprocessing,
                     FeatureLabelPreprocessing, FeatureToTupleAdapter,
                     LambdaPreprocessing, MLlibVectorToTensor, Preprocessing,
                     Relation, RelationPair, Relations, SampleToMiniBatch,
                     ScalarToTensor, SeqToMultipleTensors, SeqToTensor,
                     TensorToSample, ToTuple)
from .feature_set import (ArrayFeatureSet, FeatureSet, MiniBatch, Sample,
                          stack_samples)

__all__ = ["ArrayFeatureSet", "FeatureSet", "MiniBatch", "Sample",
           "stack_samples",
           "Preprocessing", "ChainedPreprocessing", "LambdaPreprocessing",
           "ScalarToTensor", "SeqToTensor", "SeqToMultipleTensors",
           "ArrayToTensor", "MLlibVectorToTensor",
           "FeatureLabelPreprocessing", "TensorToSample", "ToTuple",
           "FeatureToTupleAdapter", "BigDLAdapter", "SampleToMiniBatch",
           "Relation", "RelationPair", "Relations"]
