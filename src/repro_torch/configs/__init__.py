from repro_torch.configs.registry import (ARCHS, SHAPES, get_config,
                                          get_smoke, shape_applicable)

__all__ = ["ARCHS", "SHAPES", "get_config", "get_smoke", "shape_applicable"]
