"""Frozen dataclasses that are JAX pytrees.

``dataclass`` turns a class into a frozen dataclass registered with
``jax.tree_util``: fields are pytree children (traced, vmappable) unless
declared with ``field(pytree_node=False)``, which makes them static metadata
carried in the treedef (hashable, part of the jit cache key). Instances get a
``replace(**changes)`` method. This is the whole of what the params and result
containers need, with no dependency beyond JAX.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; ``pytree_node=False`` marks static metadata."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def dataclass(cls):
    """Frozen dataclass registered as a pytree (see module doc)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    data = [f.name for f in fields if f.metadata.get("pytree_node", True)]
    meta = [f.name for f in fields if not f.metadata.get("pytree_node", True)]
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    return cls
