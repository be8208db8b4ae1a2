"""Doubly-connected edge list for planar subdivisions (counterpart of
`libstevi_tpu/graphs/dcel.py`, a plain-Python copy: importing the JAX
package loads jax).

Reference parity: `graphs/doublyConnectedEdgeLists.h:29-457` —
`GenericDoublyConnectedEdgeList`: half edges stored as consecutive
twin pairs with (vertex1, vertex2, previous, next, twin, face) links, a
per-vertex "one leaving edge" anchor, and the incremental planar
subdivision operations:

  * `edge_between_vertices` (:208): walk the edges leaving a vertex
    (edge -> twin -> next) until one points at the target;
  * `external_edge_leaving_from` (:241) / `exterior_edge_for_vertex`
    (:270): find the exterior (face < 0) edge leaving / the
    entering+leaving exterior pair at a vertex;
  * `make_face` (:307-436): add a face over an ordered vertex cycle,
    adopting existing exterior half-edges (rejecting the face if any is
    already owned), creating twin pairs for missing edges, and rewiring
    both the interior cycle and the exterior boundary — including the
    lone-vertex case where both reconnection stubs are the vertex's
    freshly created twins.

Host-side topology structure (no device compute), as SURVEY §7
sanctions for pointer-chasing structures; the fixed-size-face template
parameter becomes an optional ``face_size`` check.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class DCELHalfEdge:
    """`DCELHalfEdge` (:41-117)."""

    vertex1: int
    vertex2: int
    previous: int = -1
    next: int = -1
    twin: int = -1
    face: int = -1

    @property
    def is_valid(self) -> bool:
        return self.vertex1 >= 0 and self.vertex2 >= 0


@dataclass
class DoublyConnectedEdgeList:
    """`GenericDoublyConnectedEdgeList` (:120-457).  ``vertices`` holds
    optional per-vertex payloads (the VD_T template parameter);
    ``faces[f]`` is one half-edge id on face f's cycle."""

    vertices: list = field(default_factory=list)
    vertices_out_edge: list = field(default_factory=list)
    edges: list = field(default_factory=list)
    faces: list = field(default_factory=list)
    face_size: int | None = None

    @classmethod
    def with_vertices(cls, n_vertex: int, payload=None, face_size=None):
        d = cls(face_size=face_size)
        for _ in range(n_vertex):
            d.add_vertex(payload)
        return d

    # -- vertices -----------------------------------------------------

    def add_vertex(self, payload=None) -> int:
        self.vertices.append(payload)
        self.vertices_out_edge.append(-1)
        return len(self.vertices) - 1

    @property
    def n_vertices(self) -> int:
        return len(self.vertices)

    @property
    def n_edges(self) -> int:
        return len(self.edges)

    @property
    def n_faces(self) -> int:
        return len(self.faces)

    # -- vertex-local traversal (:208-302) ----------------------------

    def _leaving_edges(self, v: int):
        """Iterate edge ids leaving ``v`` via edge -> twin -> next."""
        initial = self.vertices_out_edge[v]
        cur = initial
        while True:
            if cur < 0 or cur >= len(self.edges):
                return
            yield cur
            twin = self.edges[cur].twin
            if twin < 0 or twin >= len(self.edges):
                return
            cur = self.edges[twin].next
            if cur == initial:
                return

    def edge_between_vertices(self, v1: int, v2: int) -> int | None:
        for e in self._leaving_edges(v1):
            if self.edges[e].vertex2 == v2:
                return e
        return None

    def external_edge_leaving_from(self, v: int) -> int | None:
        for e in self._leaving_edges(v):
            if self.edges[e].face < 0:
                return e
        return None

    def exterior_edge_for_vertex(self, v: int):
        """Returns (entering, leaving) exterior edge ids at ``v``, or
        None (:270-300)."""
        initial = self.vertices_out_edge[v]
        cur = initial
        while True:
            if cur < 0 or cur >= len(self.edges):
                return None
            if self.edges[cur].face < 0:
                return (self.edges[cur].previous, cur)
            cur = self.edges[cur].twin
            if cur < 0 or cur >= len(self.edges):
                return None
            if self.edges[cur].face < 0:
                return (cur, self.edges[cur].next)
            cur = self.edges[cur].next
            if cur == initial:
                return None

    # -- face construction (:307-436) ---------------------------------

    def make_face(self, vertices: list[int]) -> int:
        """Add a face over the ordered vertex cycle; returns the face id
        or -1 when an edge of the cycle already belongs to a face."""
        n = len(vertices)
        if self.face_size is not None and n != self.face_size:
            return -1
        face_id = len(self.faces)

        edges2int = [-1] * n          # existing exterior edges adopted
        ext_leaving = [-1] * n
        for i in range(n):
            cur, nxt = vertices[i], vertices[(i + 1) % n]
            e = self.edge_between_vertices(cur, nxt)
            edges2int[i] = -1 if e is None else e
            el = self.external_edge_leaving_from(cur)
            ext_leaving[i] = -1 if el is None else el
            if edges2int[i] >= 0 and self.edges[edges2int[i]].face >= 0:
                return -1

        ext_front = [-1] * n          # exterior edge entering vertex i
        ext_back = [-1] * n           # exterior edge leaving vertex i
        int_front = [-1] * n
        int_back = [-1] * n
        new_external = [-1] * n
        face_start = -1

        for i in range(n):
            cur, nxt = vertices[i], vertices[(i + 1) % n]
            if edges2int[i] >= 0:
                e = edges2int[i]
                self.edges[e].face = face_id
                ext_front[i] = self.edges[e].previous
                ext_back[(i + 1) % n] = self.edges[e].next
                int_back[i] = e
                int_front[(i + 1) % n] = e
                if i == 0:
                    face_start = e
            else:
                e = len(self.edges)
                t = e + 1
                self.edges.append(DCELHalfEdge(cur, nxt, twin=t,
                                               face=face_id))
                self.edges.append(DCELHalfEdge(nxt, cur, twin=e, face=-1))
                int_back[i] = e
                int_front[(i + 1) % n] = e
                ext_front[i] = t
                ext_back[(i + 1) % n] = t
                new_external[i] = t
                if self.vertices_out_edge[cur] < 0:
                    self.vertices_out_edge[cur] = e
                if i == 0:
                    face_start = e

        for i in range(n):
            if ext_front[i] >= 0 and ext_back[i] >= 0:
                if (ext_leaving[i] > 0
                        and ext_front[i] == new_external[i]
                        and ext_back[i] == new_external[(i - 1) % n]):
                    # the vertex already had an exterior boundary: splice
                    # the two fresh twins into it (:407-419)
                    entering = self.edges[ext_leaving[i]].previous
                    self.edges[ext_leaving[i]].previous = ext_front[i]
                    if entering >= 0:
                        self.edges[entering].next = ext_back[i]
                    self.edges[ext_front[i]].next = ext_leaving[i]
                    self.edges[ext_back[i]].previous = entering
                else:
                    self.edges[ext_front[i]].next = ext_back[i]
                    self.edges[ext_back[i]].previous = ext_front[i]
            if int_front[i] >= 0 and int_back[i] >= 0:
                self.edges[int_front[i]].next = int_back[i]
                self.edges[int_back[i]].previous = int_front[i]

        self.faces.append(face_start)
        return face_id

    # -- traversal ----------------------------------------------------

    def face_cycle(self, face_id: int):
        start = self.faces[face_id]
        e = start
        while True:
            yield e
            e = self.edges[e].next
            if e == start or e == -1:
                break

    def face_vertices(self, face_id: int) -> list[int]:
        return [self.edges[e].vertex1 for e in self.face_cycle(face_id)]

    def exterior_cycle(self) -> list[int]:
        """Walk the exterior boundary (face < 0) from any exterior edge."""
        start = next((i for i, e in enumerate(self.edges) if e.face < 0),
                     None)
        if start is None:
            return []
        out, e = [], start
        while True:
            out.append(e)
            e = self.edges[e].next
            if e == start or e < 0 or len(out) > len(self.edges):
                break
        return out
