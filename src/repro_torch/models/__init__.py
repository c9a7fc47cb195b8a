# LM substrate: pattern-based decoder stacks over every block kind
# (GQA attn / local, MLA, Mamba, RG-LRU) and both FFN kinds (dense, MoE).
from .config import ArchConfig, smoke_variant
from .model import (SHAPES, ShapeCell, cast_params, decode_step, forward,
                    get_shape, init_params, input_specs, loss_fn,
                    model_specs)
