from repro_torch.configs.base import (ARCH_IDS, SHAPES, ArchConfig,
                                      ShapeConfig, all_cells, cells_for,
                                      get_config)

__all__ = ["ARCH_IDS", "SHAPES", "ArchConfig", "ShapeConfig", "all_cells",
           "cells_for", "get_config"]
