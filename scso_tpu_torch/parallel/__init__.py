"""Scale-out: row sharding over ``torch.distributed``, sharded IO, and
instance-parallel solves.

Port of `scso_tpu.parallel`: meshes of any axes, row sharding and
feature sharding, on which every method of a single solve runs
(`sharding`, `dataio`), `replicate`, λ/μ regularization paths and
problem fleets as one batched solve, also of row-sharded problems on a
('batch', 'data') mesh (`sweep`), and federated rounds over a fleet of
clients (`federated`)."""

from scso_tpu_torch.parallel.dataio import (
    load_problem_rows_sharded, load_rows_sharded, save_array,
    save_problem_data)
from scso_tpu_torch.parallel.sharding import (
    Mesh, distributed_init, distributed_shutdown, make_mesh, pad_rows,
    replicate, shard_problem, shard_problem_features)
from scso_tpu_torch.parallel.sweep import (
    SweepResult, solve_fleet, stack_problems, sweep)
from scso_tpu_torch.parallel.federated import (
    FederatedResult, federated_solve, split_clients)

__all__ = [
    "Mesh",
    "distributed_init",
    "distributed_shutdown",
    "make_mesh",
    "replicate",
    "shard_problem",
    "shard_problem_features",
    "pad_rows",
    "SweepResult",
    "solve_fleet",
    "stack_problems",
    "sweep",
    "FederatedResult",
    "federated_solve",
    "split_clients",
    "save_array",
    "load_rows_sharded",
    "save_problem_data",
    "load_problem_rows_sharded",
]
