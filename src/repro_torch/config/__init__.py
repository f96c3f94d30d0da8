from repro_torch.config.model_config import ModelConfig, SCTConfig
from repro_torch.config.registry import ARCH_IDS, get_config, list_archs

__all__ = ["ModelConfig", "SCTConfig", "get_config", "list_archs", "ARCH_IDS"]
