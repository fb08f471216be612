"""Extensions: sketches, histogram, stats, bloom filter, HLL sketch,
distinctCount and time min/max.

The port's counterpart of the reference package's `ext/`. Each module
registers its aggregators, post-aggregators, filters and kernels into the
port's registries (`query/aggregators.register_aggregator`,
`query/postaggs.register_postagg`, `query/filters.register_filter`,
`engine/kernels.register_kernel`) when imported; `import
druid_tpu_torch.ext` activates everything, and nothing else in the port
imports it. The device updates are torch ops over the staged columns; the
values, post-aggregators and estimators run on the host over numpy.
"""
from druid_tpu_torch.ext.stats import (StandardDeviationPostAgg,
                                       VarianceAggregator)
from druid_tpu_torch.ext.sketches import (QuantilePostAgg, QuantilesPostAgg,
                                          QuantilesSketchAggregator,
                                          QuantilesSketchValue,
                                          ThetaSketchAggregator,
                                          ThetaSketchEstimatePostAgg,
                                          ThetaSketchSetOpPostAgg,
                                          ThetaSketchValue)
from druid_tpu_torch.ext.histogram import (ApproximateHistogramAggregator,
                                           HistogramQuantilePostAgg,
                                           HistogramValue)
from druid_tpu_torch.ext.bloom import (BloomDimFilter, BloomFilterAggregator,
                                       BloomFilterValue)
from druid_tpu_torch.ext.hllsketch import (HLLSketchBuildAggregator,
                                           HLLSketchMergeAggregator,
                                           HLLSketchToEstimatePostAgg)
from druid_tpu_torch.ext.time_minmax import (TimeMaxAggregator,
                                             TimeMinAggregator)
from druid_tpu_torch.ext.distinctcount import DistinctCountAggregator

__all__ = [
    "HLLSketchBuildAggregator", "HLLSketchMergeAggregator",
    "HLLSketchToEstimatePostAgg",
    "VarianceAggregator", "StandardDeviationPostAgg",
    "ThetaSketchAggregator", "ThetaSketchValue", "ThetaSketchEstimatePostAgg",
    "ThetaSketchSetOpPostAgg", "QuantilesSketchAggregator",
    "QuantilesSketchValue", "QuantilePostAgg", "QuantilesPostAgg",
    "ApproximateHistogramAggregator", "HistogramValue",
    "HistogramQuantilePostAgg", "BloomFilterAggregator", "BloomFilterValue",
    "BloomDimFilter", "TimeMinAggregator", "TimeMaxAggregator",
    "DistinctCountAggregator",
]
