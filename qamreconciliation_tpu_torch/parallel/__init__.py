"""Multi-device reconciliation on ``torch.distributed``: rank meshes,
frame-shard data parallelism and graph-sharded decoders."""

from .mesh import make_mesh, device_count, maybe_distributed_init, run_ranks
from .sweep import shard_round, sharded_sweep
from .graph_shard import ShardedDecoder, ShardedQCDecoder

__all__ = [
    "make_mesh",
    "device_count",
    "maybe_distributed_init",
    "run_ranks",
    "shard_round",
    "sharded_sweep",
    "ShardedDecoder",
    "ShardedQCDecoder",
]
