"""minitron-4b [dense]: 32L d_model=3072 24H (kv=8) d_ff=9216
vocab=256000 — pruned nemotron (arXiv:2407.14679); squared-ReLU MLP,
no gating."""
from ..models.lm import ArchCfg, LayerKind
from .common import reduce_cfg


def config() -> ArchCfg:
    return ArchCfg(
        name="minitron-4b", d_model=3072, n_heads=24, n_kv=8, head_dim=128,
        d_ff=9216, vocab=256000,
        block_pattern=(LayerKind(),), repeats=32,
        act="relu2", tie_embeddings=False)


def reduced() -> ArchCfg:
    return reduce_cfg(config())
