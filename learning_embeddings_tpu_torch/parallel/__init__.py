"""Multi-rank execution: the ('data', 'model') mesh over torch.distributed,
its sharding rules and collectives (``mesh``), and a launcher that starts
one process per rank (``launch``)."""

from .mesh import (Mesh, ParamSharding, ShardedLinear, all_gather_rows,
                   init_from_env, make_mesh, param_shardings, shard_rows)

__all__ = ["Mesh", "ParamSharding", "ShardedLinear", "all_gather_rows",
           "init_from_env", "make_mesh", "param_shardings", "shard_rows"]
