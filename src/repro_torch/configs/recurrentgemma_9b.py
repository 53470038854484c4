"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (kv=1, MQA)
d_ff=12288 vocab=256000 — RG-LRU + local attention, 1 attn : 2 recurrent
(arXiv:2402.19427). O(1) recurrent state + 2048-window attention ->
long_500k eligible."""
from ..models.lm import ArchCfg, LayerKind
from .common import reduce_cfg

_R = LayerKind(mixer="rglru", ffn="mlp")
_A = LayerKind(mixer="attn", ffn="mlp", window=2048)


def config() -> ArchCfg:
    return ArchCfg(
        name="recurrentgemma-9b", d_model=4096, n_heads=16, n_kv=1,
        head_dim=256, d_ff=12288, vocab=256000,
        block_pattern=(_R, _R, _A), repeats=12, tail=(_R, _R),
        lru_width=4096, act="gelu", norm_plus_one=True, embed_scale=True,
        tie_embeddings=True, long_context_ok=True)


def reduced() -> ArchCfg:
    return reduce_cfg(config())
