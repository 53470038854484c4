"""The LM substrate's models (the port of ``repro.models``): the shared
layer library, the decoder-only LM and its mixers (MoE, MLA, RG-LRU,
mLSTM/sLSTM), and the encoder-decoder."""
from . import encdec, layers, lm, mla, moe, rglru, ssm  # noqa: F401
from .lm import LanguageModel  # noqa: F401
