from deepvcp.models.deepvcp import DeepVCP, create_deepvcp
from deepvcp.models.extra_layers import FeaturePropagation, SetAbstractionMSG
from deepvcp.models.fused_sa import BandedSetAbstraction
from deepvcp.models.layers import (
    CPG,
    FeatEmbedding,
    FeatureExtraction,
    SetAbstraction,
    WeightingLayer,
)

__all__ = [
    "DeepVCP",
    "create_deepvcp",
    "SetAbstraction",
    "BandedSetAbstraction",
    "SetAbstractionMSG",
    "FeaturePropagation",
    "FeatureExtraction",
    "WeightingLayer",
    "FeatEmbedding",
    "CPG",
]
