"""internvl2-76b [vlm]: 80L d_model=8192 64H (kv=8) d_ff=28672
vocab=128256 — InternViT + InternLM2 (arXiv:2404.16821). Per the
assignment the vision frontend is a STUB: input_specs provides 256
precomputed patch embeddings at d_model; we build the language backbone."""
from ..models.lm import ArchCfg, LayerKind
from .common import reduce_cfg


def config() -> ArchCfg:
    return ArchCfg(
        name="internvl2-76b", d_model=8192, n_heads=64, n_kv=8,
        head_dim=128, d_ff=28672, vocab=128256,
        block_pattern=(LayerKind(),), repeats=80,
        family="vlm", prefix_len=256, tie_embeddings=False)


def reduced() -> ArchCfg:
    return reduce_cfg(config())
