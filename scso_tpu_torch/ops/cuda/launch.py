"""What every CUDA wrapper does before a launch: route by device, check
the operands, and find the entry point, the stream, the SM count and the
largest thread-block cluster a kernel can launch.

A wrapper launches its kernel through ``ctypes`` (the solver's route,
counted) or, inside :func:`via_ops`, through its custom op
``torch.ops.scso.*`` (`build.load_ops`): what a ``torch.export`` trace
records (`utils.deploy`), and what chip_smoke.py holds against the
ctypes launch. The op route counts no launch: under export nothing is
launched, and the checks' launches are not the solve's."""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading

import torch

from scso_tpu_torch.ops.cuda import build

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_route = threading.local()


@contextlib.contextmanager
def via_ops():
    """CUDA wrappers call their custom ops (loading the op library)
    instead of the ctypes entry points."""
    build.load_ops()
    prev = getattr(_route, "ops", False)
    _route.ops = True
    try:
        yield
    finally:
        _route.ops = prev


def use_ops() -> bool:
    return getattr(_route, "ops", False)


def on_cpu(t: torch.Tensor, name: str) -> bool:
    """True for a CPU tensor (the wrapper then runs the plain version);
    False for a CUDA tensor; raises for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {t.device} are not supported")
    return False


def check_operands(name: str, dtype, device, narrow=(), **tensors) -> None:
    """Every operand on ``device``, in ``dtype``, contiguous; dtype is
    float32 or float64. The operands named in ``narrow`` may instead be
    bfloat16 (stored narrow, upcast in the kernel: K1's A). Raises
    ValueError naming the first offender."""
    if dtype not in _SUFFIX:
        raise ValueError(f"{name}: dtype {dtype} not supported "
                         "(float32 or float64)")
    for arg, t in tensors.items():
        ok = (dtype, torch.bfloat16) if arg in narrow else (dtype,)
        if t.device != device or t.dtype not in ok:
            want = " or ".join(str(d) for d in ok)
            raise ValueError(
                f"{name}: {arg} is {t.dtype} on {t.device}, expected "
                f"{want} on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def entry(base: str, dtype):
    """The C entry point ``<base>_f32`` / ``<base>_f64`` (``dtype`` the
    compute type)."""
    return getattr(build.load(), f"{base}_{_SUFFIX[dtype]}")


def stream(device) -> int:
    """The raw handle of the current stream on ``device`` (a side stream
    under CUDA-graph capture), without building a Stream object where
    this PyTorch has the call that Triton's launcher uses."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def call(device, fn, *args) -> int:
    """``fn(*args)`` with ``device`` current: the C entry points launch
    on the calling thread's current device."""
    if torch.cuda.current_device() == device.index:
        return fn(*args)
    with torch.cuda.device(device):
        return fn(*args)


#: cluster sizes a cluster kernel may take, the largest first: 16 needs
#: the non-portable opt-in, 8 is the portable limit
CLUSTER_SIZES = (16, 8)


@functools.lru_cache(maxsize=None)
def max_cluster(base: str, dtype, device_index: int) -> int:
    """The largest of :data:`CLUSTER_SIZES` of which the card holds one
    cluster of ``<base>``'s kernel at once (cudaOccupancyMaxActiveClusters
    at the most shared memory that kernel asks for), else the portable 8
    (whose launch then raises)."""
    fit = entry(f"{base}_cluster_fit", dtype)
    count = ctypes.c_int(0)
    for blocks in CLUSTER_SIZES:
        with torch.cuda.device(device_index):
            build.check(fit(blocks, ctypes.addressof(count)),
                        f"{base}: cluster of {blocks}")
        if count.value > 0:
            return blocks
    return CLUSTER_SIZES[-1]


def empty_launch(device, blocks: int = 1, cluster: int = 0) -> None:
    """Launch an empty kernel (``csrc/launch_floor.cu``): the floor under
    every kernel's time. ``cluster`` > 0 launches clusters of that many
    blocks, as K3 and K4 do. No path of the solver calls it."""
    build.check(call(device, build.load().scso_empty_kernel, blocks, cluster,
                     stream(device)), "empty kernel")


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count
