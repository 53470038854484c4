"""``closed_engine``'s closed loop over the shard engine, one shard a
rank: every rank builds ``ShardEngine`` over a ``ProcessGroupMesh`` on its
own card from the same seed and the same partition, with the
configuration's ``deployment.exchange``, and calls it in lockstep; rank
0's decisions close the window. A call's answers are global on every
rank, so rank 0's sampled answers go to the kernel's check as one card's
do.
"""
from __future__ import annotations

from bench.harness import Window
from bench.loops.closed_engine import drive


def run(ctx) -> Window:
    from repro_torch.core.engine_shardmap import ShardEngine
    from repro_torch.core.mesh import ProcessGroupMesh
    exchange = ctx.config["deployment"]["exchange"]
    return drive(ctx, lambda kernel, pg: ShardEngine(
        kernel, pg, exchange=exchange,
        mesh=ProcessGroupMesh(device=ctx.device)))
