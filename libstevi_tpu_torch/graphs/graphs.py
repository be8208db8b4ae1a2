"""Graph core types (counterpart of `libstevi_tpu/graphs/graphs.py`, a
plain-Python copy: importing the JAX package loads jax).

Reference parity: `graphs/graphs.h:36-233` — `Graph<Vertex, Edge,
directedness>` with per-vertex/per-edge data.  Host-side adjacency
structure; the compute-heavy consumers (max-flow for segmentation) convert
to sparse matrices.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any


class EdgeDirectedType(enum.Enum):
    DIRECTED = 0
    UNDIRECTED = 1


@dataclass
class Graph:
    directedness: EdgeDirectedType = EdgeDirectedType.DIRECTED
    vertex_data: list = field(default_factory=list)
    edges: list = field(default_factory=list)       # (u, v, data)

    def add_vertex(self, data: Any = None) -> int:
        self.vertex_data.append(data)
        return len(self.vertex_data) - 1

    @property
    def n_vertices(self) -> int:
        return len(self.vertex_data)

    def add_edge(self, u: int, v: int, data: Any = None) -> int:
        self.edges.append((u, v, data))
        return len(self.edges) - 1

    def out_edges(self, u: int):
        for k, (a, b, d) in enumerate(self.edges):
            if a == u or (self.directedness is EdgeDirectedType.UNDIRECTED
                          and b == u):
                yield k, (a, b, d)

    def to_capacity_matrix(self, weight=lambda d: d):
        import numpy as np
        n = self.n_vertices
        cap = np.zeros((n, n))
        for (u, v, d) in self.edges:
            w = weight(d)
            cap[u, v] += w
            if self.directedness is EdgeDirectedType.UNDIRECTED:
                cap[v, u] += w
        return cap
