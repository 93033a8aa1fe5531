"""Frozen dataclasses that are JAX pytrees.

``@dataclass`` registers the class with ``jax.tree_util.register_dataclass``:
fields are pytree children in declaration order, except fields declared
with ``field(pytree_node=False)``, which are static (hashed into the
treedef, never traced).  Instances are immutable; ``.replace(**changes)``
returns an updated copy.
"""

from __future__ import annotations

import dataclasses

import jax


def field(*, pytree_node: bool = True, **kwargs):
    """A dataclass field; ``pytree_node=False`` makes it static."""
    metadata = dict(kwargs.pop("metadata", None) or {}, pytree_node=pytree_node)
    return dataclasses.field(metadata=metadata, **kwargs)


def dataclass(cls):
    """Decorate ``cls`` as a frozen dataclass registered as a pytree."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
