from repro_torch.configs.base import (ARCHS, ModelConfig, get_config,
                                     get_smoke_config)

__all__ = ["ARCHS", "ModelConfig", "get_config", "get_smoke_config"]
