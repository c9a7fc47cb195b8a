# LM substrate: pattern-based decoder stacks.  Ported: dense GQA
# families (attn / local blocks, dense FFN); MoE, MLA, SSM and RG-LRU
# blocks raise NotImplementedError (ROADMAP A8).
from .config import ArchConfig, smoke_variant
from .model import decode_step, forward, init_params, loss_fn, model_specs
