"""seamless-m4t-medium [audio]: 12L d_model=1024 16H (kv=16) d_ff=4096
vocab=256206, enc-dec (arXiv:2308.11596). The audio frontend is a STUB:
input_specs provides precomputed frame embeddings; we build the
transformer backbone (12 enc + 12 dec)."""
from ..models.lm import ArchCfg, LayerKind
from .common import reduce_cfg

_A = LayerKind(mixer="attn", ffn="mlp")


def config() -> ArchCfg:
    return ArchCfg(
        name="seamless-m4t-medium", d_model=1024, n_heads=16, n_kv=16,
        head_dim=64, d_ff=4096, vocab=256206,
        block_pattern=(_A,), repeats=12,   # used by decoder; n_enc below
        family="encdec", n_enc=12, n_dec=12,
        act="gelu", tie_embeddings=True,
        # 256206 is not divisible by the 16-way TP degree; the table is
        # padded to 2048 (-> 258048) and padded ids are masked from the
        # softmax. The LOGICAL vocab stays 256206.
        vocab_pad_to=2048)


def reduced() -> ArchCfg:
    return reduce_cfg(config())
