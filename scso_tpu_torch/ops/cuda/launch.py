"""What every CUDA wrapper does before a launch: route by device, check
the operands, and find the entry point, the stream and the SM count."""

from __future__ import annotations

import functools

import torch

from scso_tpu_torch.ops.cuda import build

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def on_cpu(t: torch.Tensor, name: str) -> bool:
    """True for a CPU tensor (the wrapper then runs the plain version);
    False for a CUDA tensor; raises for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {t.device} are not supported")
    return False


def check_operands(name: str, dtype, device, **tensors) -> None:
    """Every operand on ``device``, in ``dtype``, contiguous; dtype is
    float32 or float64. Raises ValueError naming the first offender."""
    if dtype not in _SUFFIX:
        raise ValueError(f"{name}: dtype {dtype} not supported "
                         "(float32 or float64)")
    for arg, t in tensors.items():
        if t.device != device or t.dtype != dtype:
            raise ValueError(
                f"{name}: {arg} is {t.dtype} on {t.device}, expected "
                f"{dtype} on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def entry(base: str, dtype):
    """The C entry point ``<base>_f32`` / ``<base>_f64``."""
    return getattr(build.load(), f"{base}_{_SUFFIX[dtype]}")


def stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count
