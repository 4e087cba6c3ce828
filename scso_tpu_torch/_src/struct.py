"""Frozen dataclass helpers.

The JAX package registers its frozen dataclasses as pytrees so that
`jit`/`vmap` can trace them; PyTorch runs eagerly, so the port's problem
containers, smoothers and method configs are plain frozen dataclasses
whose tensor fields are ordinary attributes.
"""

from __future__ import annotations

import dataclasses
from typing import TypeVar

_T = TypeVar("_T")


def frozen_dataclass(cls: type[_T]) -> type[_T]:
    """Decorator: a frozen dataclass (the port's value-object idiom)."""
    return dataclasses.dataclass(frozen=True)(cls)


def replace(obj: _T, **changes) -> _T:
    """`dataclasses.replace` under the JAX package's name."""
    return dataclasses.replace(obj, **changes)
