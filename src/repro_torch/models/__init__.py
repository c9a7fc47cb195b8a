# LM substrate: pattern-based decoder stacks over every block kind
# (GQA attn / local, MLA, Mamba, RG-LRU) and both FFN kinds (dense, MoE).
from .config import ArchConfig, smoke_variant
from .model import (cast_params, decode_step, forward, init_params, loss_fn,
                    model_specs)
