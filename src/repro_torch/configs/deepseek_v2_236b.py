"""deepseek-v2-236b [moe]: 60L d_model=5120 128H vocab=102400 — MLA
(kv_lora=512, decoupled RoPE 64) + fine-grained MoE: 160 routed experts
(d_ff=1536) top-6 + 2 shared (arXiv:2405.04434)."""
from ..models.lm import ArchCfg, LayerKind, MlaCfg, MoeCfg
from .common import reduce_cfg


def config() -> ArchCfg:
    return ArchCfg(
        name="deepseek-v2-236b", d_model=5120, n_heads=128, n_kv=128,
        head_dim=128, d_ff=1536, vocab=102400,
        block_pattern=(LayerKind(mixer="mla", ffn="moe"),), repeats=60,
        mla=MlaCfg(q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64,
                   v_dim=128),
        moe=MoeCfg(n_routed=160, n_shared=2, topk=6, d_ff_expert=1536,
                   renormalize=True),
        tie_embeddings=False)


def reduced() -> ArchCfg:
    return reduce_cfg(config())
