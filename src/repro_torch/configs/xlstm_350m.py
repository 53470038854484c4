"""xlstm-350m [ssm]: 24L d_model=1024 4H d_ff=0 vocab=50304.
sLSTM + mLSTM blocks (arXiv:2405.04517), 7:1 mLSTM:sLSTM ratio.
State is O(1) in sequence -> long_500k eligible."""
from ..models.lm import ArchCfg, LayerKind
from .common import reduce_cfg

_M = LayerKind(mixer="mlstm", ffn="none")
_S = LayerKind(mixer="slstm", ffn="none")


def config() -> ArchCfg:
    return ArchCfg(
        name="xlstm-350m", d_model=1024, n_heads=4, n_kv=4, head_dim=256,
        d_ff=0, vocab=50304,
        block_pattern=(_M,) * 7 + (_S,), repeats=3,
        xlstm_heads=4, tie_embeddings=True,
        long_context_ok=True)


def reduced() -> ArchCfg:
    return reduce_cfg(config())
