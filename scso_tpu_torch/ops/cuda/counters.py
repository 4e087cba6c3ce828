"""Kernel launch counters.

Each CUDA wrapper adds one to its counter right where it launches its
kernel, and nowhere else: the plain PyTorch versions never count. Unlike
the JAX package's per-trace hit counters, these count launches, so a run
shows how often each kernel ran — and a solve on the card that shows 0
for a kernel of its path did not go through that kernel.

A launch made while a solve is being captured into a CUDA graph
(`graph.capture`, inside :func:`on_card`) runs only when the graph
replays, and then only where its conditionals let it. So there a
wrapper's count is a one-element add on a counter tensor on the card,
captured beside the launch, which replays under the same conditions;
every other launch adds to the Python count. :func:`snapshot` returns
the sum of both (one read of each card's counters).
"""

from __future__ import annotations

import contextlib

import torch

KERNEL_LAUNCHES: dict = {
    "normal_matvec": 0,
    "normal_matvec_bf16": 0,   # K1 launches on a bfloat16 A (counted
    #                            in normal_matvec as well; so for each
    #                            _bf16 name below)
    "normal_matvec_sharded": 0,
    "glm_prep": 0,
    "glm_prep_bf16": 0,
    "glm_prep_pair": 0,         # K2, ggn flavour
    "glm_prep_pair_bf16": 0,
    "glm_prep_pair_newton": 0,  # K2, newton flavour (ProxNSCORE)
    "glm_prep_pair_newton_bf16": 0,
    "score_update": 0,
    "mglm_matvec": 0,
    "mglm_matvec_bf16": 0,
    "two_loop": 0,
}
# K2 (both flavours) and K2s launches that computed the least-squares or
# the Poisson GLM in the kernel (counted under the names above as well;
# the split form counts there alone)
KERNEL_LAUNCHES.update({
    f"{k}_{kind}{a}": 0
    for k in ("glm_prep", "glm_prep_pair", "glm_prep_pair_newton")
    for kind in ("lsq", "poisson") for a in ("", "_bf16")})

#: products of a bfloat16 A with a wider vector or matrix that the port
#: runs outside its kernels (`ops/dense.py`: row blocks of A upcast, then
#: torch.matmul, as the JAX package leaves them to XLA), one a call, on
#: the card only. No kernel of the port: kept apart from the launches.
BF16_PRODUCTS: dict = {"calls": 0}


#: the counters on the card: one int64 a name of KERNEL_LAUNCHES, then
#: BF16_PRODUCTS' calls, for each card a capture ran on
_NAMES = tuple(KERNEL_LAUNCHES) + ("bf16_products",)
_SLOT = {name: i for i, name in enumerate(_NAMES)}
_DEVICE: dict = {}
#: the card whose counters count while a solve is captured, else None
_CAPTURING = {"index": None}


@contextlib.contextmanager
def on_card(index: int):
    """While a solve is captured on card ``index``: each count is an add
    on that card's counters (made here, before the capture's first op)."""
    if index not in _DEVICE:
        _DEVICE[index] = torch.zeros(len(_NAMES), dtype=torch.int64,
                                     device=torch.device("cuda", index))
    prev, _CAPTURING["index"] = _CAPTURING["index"], index
    try:
        yield
    finally:
        _CAPTURING["index"] = prev


def _count(name: str, host: dict, key: str) -> None:
    index = _CAPTURING["index"]
    if index is None:
        host[key] += 1
    else:
        i = _SLOT[name]
        _DEVICE[index][i:i + 1].add_(1)


def bump(name: str) -> None:
    _count(name, KERNEL_LAUNCHES, name)


def bump_product() -> None:
    """One product of a bfloat16 A outside the kernels (`ops.dense`)."""
    _count("bf16_products", BF16_PRODUCTS, "calls")


def reset() -> None:
    for k in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[k] = 0
    BF16_PRODUCTS["calls"] = 0
    for t in _DEVICE.values():
        t.zero_()


def _device_totals() -> dict:
    totals = dict.fromkeys(_NAMES, 0)
    for t in _DEVICE.values():
        for name, c in zip(_NAMES, t.tolist()):
            totals[name] += c
    return totals


def snapshot() -> dict:
    dev = _device_totals()
    return {k: c + dev[k] for k, c in KERNEL_LAUNCHES.items()}


def bf16_products() -> int:
    """BF16_PRODUCTS' calls, the replayed ones included."""
    return BF16_PRODUCTS["calls"] + _device_totals()["bf16_products"]
