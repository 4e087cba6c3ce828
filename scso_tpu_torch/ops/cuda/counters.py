"""Kernel launch counters.

Each CUDA wrapper adds one to its counter right where it launches its
kernel, and nowhere else: the plain PyTorch versions never count. Unlike
the JAX package's per-trace hit counters, these count launches, so a run
shows how often each kernel ran — and a solve on the card that shows 0
for a kernel of its path did not go through that kernel.
"""

from __future__ import annotations

KERNEL_LAUNCHES: dict = {
    "normal_matvec": 0,
    "normal_matvec_bf16": 0,   # K1 launches on a bfloat16 A (counted
    #                            in normal_matvec as well)
    "normal_matvec_sharded": 0,
    "glm_prep": 0,
    "glm_prep_pair": 0,         # K2, ggn flavour
    "glm_prep_pair_newton": 0,  # K2, newton flavour (ProxNSCORE)
    "score_update": 0,
    "mglm_matvec": 0,
    "two_loop": 0,
}


def bump(name: str) -> None:
    KERNEL_LAUNCHES[name] += 1


def reset() -> None:
    for k in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[k] = 0


def snapshot() -> dict:
    return dict(KERNEL_LAUNCHES)
