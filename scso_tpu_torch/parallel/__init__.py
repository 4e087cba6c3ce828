"""Scale-out: row sharding over ``torch.distributed`` and sharded IO.

Port of `scso_tpu.parallel` for the row-sharded cached GGN-CG path.
`sweep` and `federated` are not ported yet (ROADMAP A11)."""

from scso_tpu_torch.parallel.dataio import (
    load_problem_rows_sharded, load_rows_sharded, save_array,
    save_problem_data)
from scso_tpu_torch.parallel.sharding import (
    Mesh, distributed_init, make_mesh, pad_rows, replicate, shard_problem,
    shard_problem_features)

__all__ = [
    "Mesh",
    "distributed_init",
    "make_mesh",
    "replicate",
    "shard_problem",
    "shard_problem_features",
    "pad_rows",
    "save_array",
    "load_rows_sharded",
    "save_problem_data",
    "load_problem_rows_sharded",
]
