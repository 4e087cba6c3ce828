"""What the port's examples share: a process group for the ones that
shard (05, 09, 11)."""

from __future__ import annotations

import contextlib
import os
import tempfile

import torch
import torch.distributed as dist


@contextlib.contextmanager
def ranks(device: torch.device):
    """A process group for the duration: the one that exists, else
    torchrun's (started with ``torchrun --nproc-per-node=N``), else a
    group of this process alone (a file rendezvous in a temporary
    directory). NCCL on the card, gloo on the CPU; a group made here is
    torn down at the end, after the cached captures are dropped
    (`distributed_shutdown`). Under NCCL the captured solves of a problem
    sharded over several ranks need NCCL_GRAPH_MIXING_SUPPORT=0 when the
    group is made, so it is set unless the environment sets it."""
    from scso_tpu_torch.parallel import distributed_init, distributed_shutdown

    if dist.is_initialized():
        yield
        return
    backend = "gloo" if device.type == "cpu" else None
    if backend is None:
        os.environ.setdefault("NCCL_GRAPH_MIXING_SUPPORT", "0")
    with tempfile.TemporaryDirectory() as d:
        if "RANK" in os.environ:
            distributed_init(backend)
        else:
            distributed_init(backend, world_size=1, rank=0,
                             init_method="file://" + os.path.join(d, "rdv"))
        try:
            yield
        finally:
            distributed_shutdown()
