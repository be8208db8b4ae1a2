"""Graphs (counterpart of `libstevi_tpu/graphs/`): the graph and DCEL
types (plain-Python copies) and max-flow / min-cut on the port's own
native solver (`flow`)."""

from .graphs import Graph, EdgeDirectedType
from .flow import max_flow_min_cut, reachable_vertices_in_cut
from .dcel import DoublyConnectedEdgeList

__all__ = ["Graph", "EdgeDirectedType", "max_flow_min_cut",
           "reachable_vertices_in_cut", "DoublyConnectedEdgeList"]
