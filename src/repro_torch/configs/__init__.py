from repro_torch.configs.base import (ARCHS, ENCDEC_ARCHS, GRAPH_ARCHS,
                                     HYBRID_ARCHS, LM_ARCHS, MOE_ARCHS,
                                     SSM_ARCHS, VLM_ARCHS, ModelConfig,
                                     ShapeConfig, get_config,
                                     get_smoke_config)

__all__ = ["ARCHS", "ENCDEC_ARCHS", "GRAPH_ARCHS", "HYBRID_ARCHS",
           "LM_ARCHS", "MOE_ARCHS", "ModelConfig", "SSM_ARCHS",
           "ShapeConfig", "VLM_ARCHS", "get_config", "get_smoke_config"]
