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


def bump(name: str) -> None:
    KERNEL_LAUNCHES[name] += 1


def reset() -> None:
    for k in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[k] = 0
    BF16_PRODUCTS["calls"] = 0


def snapshot() -> dict:
    return dict(KERNEL_LAUNCHES)
