from repro_torch.configs.base import (REGISTRY, ArchConfig, get, load_all,
                                     reduced, register)

__all__ = ["REGISTRY", "ArchConfig", "get", "load_all", "reduced",
           "register"]
