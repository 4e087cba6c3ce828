"""K4: the L-BFGS two-loop recursion.

Port of `scso_tpu/ops/pallas/two_loop.py` (`_two_loop_pallas`):
d = −H·g over the circular (s, y) memory, with the (pos, count)
addressing, empty-slot masking and ρ = 0 where yᵀs = 0 of
`lbfgs_core.two_loop`. The CUDA kernel is ``csrc/two_loop.cu``: one
launch of one thread-block cluster, each block owning a slice of n
(:func:`two_loop_plan`); :func:`two_loop_torch` (= `lbfgs_core.two_loop`)
is the plain version. pos, count and H0 stay on the device, so neither
version waits for it.

The TPU wrapper falls back to its scan above an 8 MB VMEM budget
(`supports_fused_two_loop`); the kernel here takes any n and any memory
size m: α and ρ (2·m values) sit in each block's shared memory up to
:data:`SMEM_BYTES`, and in a device scratch from the wrapper past it;
the block's slice of the memory's S and Y sits in shared memory where
it fits :data:`RESIDENT_BYTES`, and is streamed from global memory
otherwise.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from scso_tpu_torch.ops import nancheck
from scso_tpu_torch.ops.cuda import build, counters, launch
from scso_tpu_torch.ops.lbfgs_core import LBFGSMemory
from scso_tpu_torch.ops.lbfgs_core import two_loop as two_loop_torch

#: α and ρ go in shared memory up to this (m = 4096 in float32, 2048
#: in float64), in a device scratch past it (csrc/two_loop.cu)
SMEM_BYTES = 32 * 1024
#: the most dynamic shared memory a block takes (csrc/two_loop.cu's
#: kSmemMax; the H100 gives a block up to 227 KB)
RESIDENT_BYTES = 200 * 1024
#: a block's slice is a multiple of 32 values, and each block owns at
#: least this many (two a thread of its 256)
SLICE_MIN = 512
_SLICE_ALIGN = 32
# the kernel's flags (csrc/two_loop.cu)
_ALPHA_IN_SMEM, _Q_IN_SMEM, _RESIDENT = 1, 2, 4

__all__ = ["RESIDENT_BYTES", "SMEM_BYTES", "TwoLoopPlan", "two_loop",
           "two_loop_plan", "two_loop_torch"]


class TwoLoopPlan(NamedTuple):
    blocks: int      # the cluster's blocks
    chunk: int       # values of n each block owns (the last may own fewer)
    alpha_smem: bool  # α, ρ in shared memory (else the device scratch)
    q_smem: bool     # q and r in shared memory (else the output's slice)
    resident: bool   # the slice of the m S and Y slots in shared memory
    smem: int        # dynamic shared memory bytes a block takes


def cluster_blocks(n: int, max_cluster: int = 16) -> int:
    """Blocks of K4's cluster: at least :data:`SLICE_MIN` values each, a
    power of two, at most ``max_cluster`` (``launch.max_cluster``)."""
    want = max(1, -(-n // SLICE_MIN))
    return min(max_cluster, 1 << (want - 1).bit_length())


@functools.lru_cache(maxsize=None)
def two_loop_plan(n: int, m: int, itemsize: int,
                  max_cluster: int = 16) -> TwoLoopPlan:
    """K4's launch for n values and m slots of ``itemsize`` bytes: the
    cluster, each block's slice, and what sits in shared memory — α and
    ρ up to :data:`SMEM_BYTES`, then q, then the slice of every S and Y
    slot, each while the total stays within :data:`RESIDENT_BYTES`."""
    blocks = cluster_blocks(n, max_cluster)
    share = max(1, -(-n // blocks))
    chunk = -(-share // _SLICE_ALIGN) * _SLICE_ALIGN
    ab = 2 * m * itemsize
    alpha_smem = ab <= SMEM_BYTES
    smem = ab if alpha_smem else 0
    q_smem = smem + chunk * itemsize <= RESIDENT_BYTES
    if q_smem:
        smem += chunk * itemsize
    resident = q_smem and smem + ab * chunk <= RESIDENT_BYTES
    if resident:
        smem += ab * chunk
    return TwoLoopPlan(blocks, chunk, alpha_smem, q_smem, resident, smem)


def two_loop(mem: LBFGSMemory, grad: torch.Tensor) -> torch.Tensor:
    """d = −H·grad — the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if launch.on_cpu(grad, "two_loop"):
        return two_loop_torch(mem, grad)
    return _launch(mem, grad)


def _launch(mem: LBFGSMemory, grad: torch.Tensor,
            plan: TwoLoopPlan = None) -> torch.Tensor:
    """The kernel on CUDA tensors, launched as ``plan`` (default:
    two_loop_plan's). Any plan of the same blocks and slices gives the
    same bits, wherever it keeps S, Y, q and α: the tests hold them
    to each other."""
    m, n = mem.S.shape
    dev, dt = grad.device, grad.dtype
    launch.check_operands("two_loop", dt, dev, S=mem.S, Y=mem.Y, grad=grad,
                          H0=mem.H0)
    if grad.shape != (n,) or mem.Y.shape != (m, n) or mem.H0.numel() != 1:
        raise ValueError(
            f"two_loop: shapes S {tuple(mem.S.shape)}, Y "
            f"{tuple(mem.Y.shape)}, grad {tuple(grad.shape)}, H0 "
            f"{tuple(mem.H0.shape)}")
    for arg, t in (("pos", mem.pos), ("count", mem.count)):
        if t.dtype != torch.int32 or t.device != dev or t.numel() != 1:
            raise ValueError(f"two_loop: {arg} must be one int32 on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if plan is None:
        plan = two_loop_plan(n, m, grad.element_size(), launch.max_cluster(
            "scso_two_loop", dt, dev.index))
    flags = (_ALPHA_IN_SMEM * plan.alpha_smem + _Q_IN_SMEM * plan.q_smem
             + _RESIDENT * plan.resident)
    if launch.use_ops():
        return torch.ops.scso.two_loop(mem.S, mem.Y, grad, mem.pos,
                                       mem.count, mem.H0, plan.blocks,
                                       plan.chunk, flags, plan.smem)
    out = torch.empty_like(grad)
    scratch = (None if plan.alpha_smem else
               torch.empty(plan.blocks * 2 * m, dtype=dt, device=dev))
    rc = launch.call(
        dev, launch.entry("scso_two_loop", dt), mem.S.data_ptr(),
        mem.Y.data_ptr(), grad.data_ptr(), mem.pos.data_ptr(),
        mem.count.data_ptr(), mem.H0.data_ptr(),
        None if scratch is None else scratch.data_ptr(), out.data_ptr(), m,
        n, plan.blocks, plan.chunk, flags, plan.smem, launch.stream(dev))
    build.check(rc, "two_loop")
    counters.bump("two_loop")
    nancheck.check("two_loop", out, (mem.S, mem.Y, grad, mem.H0))
    return out
