"""Frozen dataclasses registered as JAX pytrees, every field a leaf.

``@dataclass`` decorates one class; subclasses of :class:`PyTreeNode` are
decorated on definition, so a base class's fields come first in each
subclass. Both gain ``replace(**changes)``.
"""

from __future__ import annotations

import dataclasses

import jax


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    names = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=names, meta_fields=[])
    cls.replace = _replace
    return cls


class PyTreeNode:
    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclass(cls)
