"""qwen3-4b [dense]: 36L d_model=2560 32H (kv=8) d_ff=9728 vocab=151936,
qk_norm + GQA [hf:Qwen/Qwen3-8B family]."""
from ..models.lm import ArchCfg, LayerKind
from .common import reduce_cfg


def config() -> ArchCfg:
    return ArchCfg(
        name="qwen3-4b", d_model=2560, n_heads=32, n_kv=8, head_dim=128,
        d_ff=9728, vocab=151936,
        block_pattern=(LayerKind(),), repeats=36,
        qk_norm=True, tie_embeddings=True)


def reduced() -> ArchCfg:
    return reduce_cfg(config())
