from repro_torch.configs.registry import ARCHS, get_config, get_smoke

__all__ = ["ARCHS", "get_config", "get_smoke"]
