"""qwen2-72b [dense]: 80L d_model=8192 64H (kv=8) d_ff=29568
vocab=152064, GQA with QKV bias (arXiv:2407.10671)."""
from ..models.lm import ArchCfg, LayerKind
from .common import reduce_cfg


def config() -> ArchCfg:
    return ArchCfg(
        name="qwen2-72b", d_model=8192, n_heads=64, n_kv=8, head_dim=128,
        d_ff=29568, vocab=152064,
        block_pattern=(LayerKind(),), repeats=80,
        qkv_bias=True, tie_embeddings=False)


def reduced() -> ArchCfg:
    return reduce_cfg(config())
