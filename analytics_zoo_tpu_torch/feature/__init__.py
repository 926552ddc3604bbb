from .common import (ArrayToTensor, BigDLAdapter, ChainedPreprocessing,
                     FeatureLabelPreprocessing, FeatureToTupleAdapter,
                     LambdaPreprocessing, MLlibVectorToTensor, Preprocessing,
                     Relation, RelationPair, Relations, SampleToMiniBatch,
                     ScalarToTensor, SeqToMultipleTensors, SeqToTensor,
                     TensorToSample, ToTuple)
from .dataset import (DatasetShard, ShardedDatasetFeatureSet, assign_shards,
                      discover_shards, write_parquet_shards)
from .feature_set import (ArrayFeatureSet, FeatureSet, GeneratorFeatureSet,
                          MiniBatch, PrefetchIterator, Sample,
                          ShardedFileFeatureSet, TransformStats,
                          TransformedFeatureSet, pad_minibatch,
                          register_pipeline, shutdown_all_pipelines,
                          stack_samples)
from .host_pipeline import (DeviceStagingIterator, ParallelTransformIterator,
                            build_host_pipeline)

__all__ = ["ArrayFeatureSet", "FeatureSet", "GeneratorFeatureSet",
           "MiniBatch", "PrefetchIterator", "Sample", "pad_minibatch",
           "stack_samples",
           "ShardedFileFeatureSet", "TransformedFeatureSet",
           "TransformStats", "ParallelTransformIterator",
           "DeviceStagingIterator", "build_host_pipeline",
           "DatasetShard", "ShardedDatasetFeatureSet", "assign_shards",
           "discover_shards", "write_parquet_shards",
           "register_pipeline", "shutdown_all_pipelines",
           "Preprocessing", "ChainedPreprocessing", "LambdaPreprocessing",
           "ScalarToTensor", "SeqToTensor", "SeqToMultipleTensors",
           "ArrayToTensor", "MLlibVectorToTensor",
           "FeatureLabelPreprocessing", "TensorToSample", "ToTuple",
           "FeatureToTupleAdapter", "BigDLAdapter", "SampleToMiniBatch",
           "Relation", "RelationPair", "Relations"]
