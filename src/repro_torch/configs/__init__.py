"""Architecture configs (port of ``repro/configs``): one module per
registry arch, and the paper's own ViT (``paper_vit``)."""
from repro_torch.configs.base import (BlockSpec, EncoderSpec, FFNSpec,  # noqa: F401
                                      ModelConfig, SHAPES, ShapeSpec,
                                      shape_applicable)
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: F401
