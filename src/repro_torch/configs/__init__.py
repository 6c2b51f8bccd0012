from repro_torch.configs.base import (ARCH_IDS, PORT_ARCH_IDS, SHAPES,
                                      ArchConfig, MlaMoeConfig, ShapeConfig,
                                      all_cells, cells_for, get_config,
                                      is_mla)

__all__ = ["ARCH_IDS", "PORT_ARCH_IDS", "SHAPES", "ArchConfig",
           "MlaMoeConfig", "ShapeConfig", "all_cells", "cells_for",
           "get_config", "is_mla"]
