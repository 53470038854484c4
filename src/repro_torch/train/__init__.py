"""Training substrate: optimizer, loop, checkpointing, compression (the
port of ``repro.train``)."""
from . import checkpoint, compress, loop, optimizer  # noqa: F401
