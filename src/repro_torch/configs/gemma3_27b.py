"""gemma3-27b [dense]: 62L d_model=5376 32H (kv=16) d_ff=21504
vocab=262144, 5:1 local:global sliding-window pattern, 128k context
[hf:google/gemma-3 family]. Long-context eligible: 5/6 of layers are
1024-token local windows and decode is per-token linear."""
from ..models.lm import ArchCfg, LayerKind
from .common import reduce_cfg

_LOCAL = LayerKind(window=1024, rope_base=10_000.0)
_GLOBAL = LayerKind(rope_base=1_000_000.0)


def config() -> ArchCfg:
    return ArchCfg(
        name="gemma3-27b", d_model=5376, n_heads=32, n_kv=16, head_dim=128,
        d_ff=21504, vocab=262144,
        block_pattern=(_LOCAL,) * 5 + (_GLOBAL,), repeats=10,
        tail=(_LOCAL, _LOCAL),
        qk_norm=True, norm_plus_one=True, post_norms=True,
        embed_scale=True, act="gelu", tie_embeddings=True,
        long_context_ok=True)


def reduced() -> ArchCfg:
    return reduce_cfg(config())
