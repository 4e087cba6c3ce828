"""K4: the L-BFGS two-loop recursion.

Port of `scso_tpu/ops/pallas/two_loop.py` (`_two_loop_pallas`):
d = −H·g over the circular (s, y) memory, with the (pos, count)
addressing, empty-slot masking and ρ = 0 where yᵀs = 0 of
`lbfgs_core.two_loop`. The CUDA kernel is ``csrc/two_loop.cu``;
:func:`two_loop_torch` (= `lbfgs_core.two_loop`) is the plain version.
pos, count and H0 stay on the device, so neither version waits for it.

The TPU wrapper falls back to its scan above an 8 MB VMEM budget
(`supports_fused_two_loop`); the kernel here takes any n and any memory
size m: α and ρ (2·m values) sit in the kernel's shared memory up to
:data:`SMEM_BYTES`, and in a device scratch from the wrapper past it.
"""

from __future__ import annotations

import torch

from scso_tpu_torch.ops.cuda import build, counters, launch
from scso_tpu_torch.ops.lbfgs_core import LBFGSMemory
from scso_tpu_torch.ops.lbfgs_core import two_loop as two_loop_torch

#: α and ρ go in shared memory up to this (m = 4096 in float32, 2048
#: in float64; a launch gets 48 KB without opting in), in a device
#: scratch past it (csrc/two_loop.cu)
SMEM_BYTES = 32 * 1024

__all__ = ["SMEM_BYTES", "two_loop", "two_loop_torch"]


def two_loop(mem: LBFGSMemory, grad: torch.Tensor) -> torch.Tensor:
    """d = −H·grad — the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if launch.on_cpu(grad, "two_loop"):
        return two_loop_torch(mem, grad)
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
    out = torch.empty_like(grad)
    scratch = (torch.empty(2 * m, dtype=dt, device=dev)
               if 2 * m * grad.element_size() > SMEM_BYTES else None)
    with torch.cuda.device(dev):
        rc = launch.entry("scso_two_loop", dt)(
            mem.S.data_ptr(), mem.Y.data_ptr(), grad.data_ptr(),
            mem.pos.data_ptr(), mem.count.data_ptr(), mem.H0.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            out.data_ptr(), m, n, launch.stream(dev))
    build.check(rc, "two_loop")
    counters.bump("two_loop")
    return out
