"""Max-flow / min-cut (counterpart of `libstevi_tpu/graphs/flow.py`).

Reference parity: `graphs/graph_flow.h:48` (`maxFlowMinCut`: augmenting-path
max-flow returning the flow value and the cut edge set) and
`graphs/graph_cut.h:33` (`reachableVerticesInCut`).

The default backend is the native Boykov-Kolmogorov solver on FLOAT
capacities, the port's own copy of the C++ source
(`libstevi_tpu_torch/native/maxflow.cpp`), built with ``g++`` into the
package's ``_build/`` on first use (`native.build`) and bound with ctypes
to the same C ABI.  ``backend="scipy"`` keeps the scipy preflow-push route
(int32 capacities by scaling and rounding) as an explicit choice.

Documented deviation from the JAX package: there, a native solver that
cannot be built or loaded falls back to the scipy route with a warning,
so the capacities are silently quantised to int32.  Here
``backend="native"`` raises instead (`RuntimeError` from the build, or
`OSError` from loading); ask for ``backend="scipy"`` to take that route.

Host-side control flow by design, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class MaxFlowResult:
    max_flow: float
    source_side: np.ndarray      # bool mask over vertices
    cut_edges: list              # [(u, v)] saturated edges crossing the cut


def max_flow_min_cut(n_vertices: int, edges, capacities, source: int,
                     sink: int, scale: float = 1e6,
                     backend: str = "native") -> MaxFlowResult:
    """edges: (E, 2) int array; capacities: (E,) float.  Directed edges.

    Returns the max-flow value, the source-side vertex mask of the min cut,
    and the saturated crossing edges.  ``backend="native"`` (default) runs
    the float-capacity Boykov-Kolmogorov solver and raises where it cannot
    be built or loaded; ``"scipy"`` the integer preflow-push route
    (capacities scaled and rounded to int32)."""
    if backend == "native":
        return _max_flow_native(n_vertices, edges, capacities, source, sink)
    if backend != "scipy":
        raise ValueError(f"backend {backend!r}: 'native' or 'scipy'")
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import maximum_flow

    edges = np.asarray(edges, np.int64)
    caps = np.asarray(capacities, np.float64)
    # scipy's maximum_flow requires int32 capacities: adapt the scale so the
    # largest capacity stays well inside int32
    max_cap = caps.max() if len(caps) else 1.0
    if max_cap > 0:
        scale = min(scale, (2 ** 30) / max_cap)
    int_caps = np.clip(np.round(caps * scale), 0, 2 ** 31 - 1).astype(np.int32)
    graph = csr_matrix((int_caps, (edges[:, 0], edges[:, 1])),
                       shape=(n_vertices, n_vertices))
    res = maximum_flow(graph, source, sink)

    # residual capacities; BFS from source over residual > 0
    residual = graph - res.flow
    residual = residual.maximum(0) + res.flow.T.maximum(0)
    reachable = np.zeros(n_vertices, bool)
    stack = [source]
    reachable[source] = True
    residual = residual.tolil()
    while stack:
        u = stack.pop()
        for v, c in zip(residual.rows[u], residual.data[u]):
            if c > 0 and not reachable[v]:
                reachable[v] = True
                stack.append(v)

    e = np.asarray(edges)
    m = reachable[e[:, 0]] & ~reachable[e[:, 1]]
    cut = [(int(u), int(v)) for u, v in e[m]]
    return MaxFlowResult(max_flow=res.flow_value / scale,
                         source_side=reachable, cut_edges=cut)


def reachable_vertices_in_cut(result: MaxFlowResult) -> np.ndarray:
    """Source-side vertices of the min cut (`graph_cut.h:33`)."""
    return result.source_side


def _max_flow_native(n_vertices: int, edges, capacities, source: int,
                     sink: int) -> MaxFlowResult:
    import ctypes

    from ..native import maxflow_library

    edges = np.ascontiguousarray(np.asarray(edges, np.int64).reshape(-1, 2))
    # bk_maxflow indexes first[u]/first[v] without bounds checks — an
    # endpoint outside [0, n_vertices) would be an out-of-bounds heap
    # write in the C++ solver, so validate here (the scipy backend
    # raises cleanly on its own)
    if len(edges) and ((edges < 0).any() or (edges >= n_vertices).any()):
        bad = edges[((edges < 0) | (edges >= n_vertices)).any(axis=1)][0]
        raise ValueError(
            f"edge ({bad[0]}, {bad[1]}) has an endpoint outside "
            f"[0, {n_vertices})")
    caps = np.ascontiguousarray(np.asarray(capacities, np.float64))
    side = np.zeros(n_vertices, np.uint8)
    lib = maxflow_library()
    flow = lib.bk_maxflow(
        n_vertices, len(edges),
        edges.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        caps.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        int(source), int(sink),
        side.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    reachable = side.astype(bool)
    if len(edges):
        m = reachable[edges[:, 0]] & ~reachable[edges[:, 1]]
        cut = [(int(u), int(v)) for u, v in edges[m]]
    else:
        cut = []
    return MaxFlowResult(max_flow=float(flow), source_side=reachable,
                         cut_edges=cut)
