from repro_torch.configs.base import (ALL_ARCHS, ARCHS, ASSIGNED_ARCHS,
                                     ENCDEC_ARCHS, GRAPH_ARCHS,
                                     HYBRID_ARCHS, LM_ARCHS, MOE_ARCHS,
                                     PAPER_ARCHS, SHAPES, SSM_ARCHS,
                                     VLM_ARCHS, ModelConfig, ShapeConfig,
                                     cells, get_config, get_smoke_config)

__all__ = ["ALL_ARCHS", "ARCHS", "ASSIGNED_ARCHS", "ENCDEC_ARCHS",
           "GRAPH_ARCHS", "HYBRID_ARCHS", "LM_ARCHS", "MOE_ARCHS",
           "ModelConfig", "PAPER_ARCHS", "SHAPES", "SSM_ARCHS",
           "ShapeConfig", "VLM_ARCHS", "cells", "get_config",
           "get_smoke_config"]
