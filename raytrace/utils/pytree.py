"""Frozen dataclasses registered as JAX pytrees.

`pytree_dataclass` turns a class body into a frozen dataclass whose
fields are pytree leaves, except those declared with `static_field`,
which ride in the treedef (hashable, part of the jit cache key).
Instances get a `.replace(**changes)` method.
"""
from __future__ import annotations

import dataclasses

import jax


def static_field(default=dataclasses.MISSING):
    """A dataclass field kept out of the pytree leaves."""
    return dataclasses.field(default=default, metadata={"static": True})


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def pytree_dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = _replace
    return jax.tree_util.register_dataclass(cls)
