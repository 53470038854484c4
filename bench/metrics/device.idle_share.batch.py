"""Share of the profiled part of the window in which no kernel, copy or
set ran on the device (1 - union of device intervals / wall)."""
from bench.metrics._common import idle_share

read = idle_share
