"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (kv=16, MHA) vocab=102400,
fine-grained MoE: 64 routed experts (d_ff=1408) top-6 + 2 shared
(arXiv:2401.06066). Deviation noted: the public model uses a dense FFN in
layer 0; the assignment specifies the uniform MoE stack we build here."""
from ..models.lm import ArchCfg, LayerKind, MoeCfg
from .common import reduce_cfg


def config() -> ArchCfg:
    return ArchCfg(
        name="deepseek-moe-16b", d_model=2048, n_heads=16, n_kv=16,
        head_dim=128, d_ff=1408, vocab=102400,
        block_pattern=(LayerKind(ffn="moe"),), repeats=28,
        moe=MoeCfg(n_routed=64, n_shared=2, topk=6, d_ff_expert=1408,
                   renormalize=False),
        tie_embeddings=False)


def reduced() -> ArchCfg:
    return reduce_cfg(config())
