"""Frozen dataclasses that are JAX pytrees.

`@dataclass` registers the class with `jax.tree_util.register_dataclass`:
fields are pytree children unless declared `field(static=True)`, in which
case they are part of the treedef (hashable, jit-static).  Instances get
`.replace(**changes)`.
"""

from __future__ import annotations

import dataclasses

import jax


def field(*, static: bool = False, **kw):
    """dataclasses.field, marking `static=True` fields as treedef metadata."""
    return dataclasses.field(metadata={"static": static}, **kw)


def dataclass(cls):
    """Frozen dataclass + pytree registration + `.replace`."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    static = [f.name for f in fields if f.metadata.get("static", False)]
    data = [f.name for f in fields if f.name not in static]
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=static)
    cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)
    return cls
