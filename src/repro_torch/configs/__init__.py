"""Model configurations the port serves (copies of the reference's)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config, list_archs, smoke_config
