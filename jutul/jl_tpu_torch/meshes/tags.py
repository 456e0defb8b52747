"""Mesh entity tags.

Port of the JAX package's ``meshes/tags.py`` (host numpy). Counterpart of the reference tag system (reference:
src/core_types/core_types.jl:1306-1450 — ``EntityTags``/``MeshEntityTags``,
``set_mesh_entity_tag!``, ``get_mesh_entity_tag``, tag groups per entity
type). Tags let users label cell/face subsets (formations, wells, boundary
groups) and retrieve them later.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from ..core.entities import BOUNDARY_FACES, CELLS, FACES, NODES, JutulEntity


class EntityTags:
    """Tag registry for one entity type (reference EntityTags)."""

    def __init__(self, count: int | None = None):
        self.count = count
        self.tags: dict[str, dict[str, np.ndarray]] = defaultdict(dict)

    def set(self, group: str, tag: str, indices) -> None:
        ix = np.unique(np.asarray(indices, dtype=np.int64))
        if self.count is not None and ix.size and (
                ix.min() < 0 or ix.max() >= self.count):
            raise IndexError(f"tag indices out of range [0, {self.count})")
        self.tags[group][tag] = ix

    def get(self, group: str, tag: str | None = None):
        if tag is None:
            return dict(self.tags[group])
        return self.tags[group][tag]

    def groups(self):
        return list(self.tags)


class MeshEntityTags:
    """Per-entity tag groups (reference MeshEntityTags)."""

    def __init__(self, mesh=None):
        counts = {}
        if mesh is not None:
            counts = {
                CELLS: mesh.number_of_cells(),
                FACES: mesh.number_of_faces(),
                BOUNDARY_FACES: mesh.number_of_boundary_faces(),
            }
        self._tags: dict[JutulEntity, EntityTags] = {
            e: EntityTags(counts.get(e)) for e in (CELLS, FACES,
                                                   BOUNDARY_FACES, NODES)
        }

    def __getitem__(self, entity: JutulEntity) -> EntityTags:
        return self._tags[entity]


def set_mesh_entity_tag(mesh, entity: JutulEntity, group: str, tag: str,
                        indices) -> None:
    """reference set_mesh_entity_tag!"""
    if not hasattr(mesh, "tags"):
        # meshes may be frozen dataclasses; tags are auxiliary metadata
        object.__setattr__(mesh, "tags", MeshEntityTags(mesh))
    mesh.tags[entity].set(group, tag, indices)


def get_mesh_entity_tag(mesh, entity: JutulEntity, group: str,
                        tag: str | None = None):
    """reference get_mesh_entity_tag"""
    if not hasattr(mesh, "tags"):
        raise KeyError("mesh has no tags")
    return mesh.tags[entity].get(group, tag)
