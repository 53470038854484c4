"""The LM substrate's models (the port of ``repro.models``): the shared
layer library and the decoder-only LM, dense GQA family."""
from . import layers, lm  # noqa: F401
from .lm import LanguageModel  # noqa: F401
