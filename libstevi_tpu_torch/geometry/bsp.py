"""Spatial indexes: binary space partition (k-d style) and BVH (a copy of
`libstevi_tpu/geometry/bsp.py`, numpy only: importing that module would
load the JAX package).

Reference parity: `geometry/genericbinarypartitioningtree.h` —
`GenericBSP` (:74: median-split partitioning over arbitrary point
containers with range and nearest queries) and `GenericBVH` (:602: bounding
volume hierarchy over AABB objects).

Design: host-side (SURVEY.md §7 hard parts: "keep BSP/BVH and point-cloud
spatial queries host-side or as sorted-array ops") — numpy median splits,
iterative query traversal.  For massive batched nearest-neighbor queries on
device, prefer brute-force distance matrices (one GEMM) over tree traversal.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class _Node:
    axis: int = -1
    split: float = 0.0
    left: int = -1
    right: int = -1
    start: int = 0
    end: int = 0       # leaf range in the permuted index array


class GenericBSP:
    """Median-split k-d tree over (N, D) points."""

    def __init__(self, points: np.ndarray, leaf_size: int = 16):
        self.points = np.asarray(points, np.float64)
        N, D = self.points.shape
        self.dim = D
        self.perm = np.arange(N)
        self.nodes: list[_Node] = []
        self._build(0, N, 0)

    def _build(self, start, end, depth) -> int:
        node = _Node(start=start, end=end)
        idx = len(self.nodes)
        self.nodes.append(node)
        if end - start <= 16:
            return idx
        axis = depth % self.dim
        seg = self.perm[start:end]
        order = np.argsort(self.points[seg, axis], kind="stable")
        self.perm[start:end] = seg[order]
        mid = (start + end) // 2
        node.axis = axis
        node.split = self.points[self.perm[mid], axis]
        node.left = self._build(start, mid, depth + 1)
        node.right = self._build(mid, end, depth + 1)
        return idx

    def range_query(self, lo, hi) -> np.ndarray:
        """Indices of points inside the axis-aligned box [lo, hi]."""
        lo = np.asarray(lo)
        hi = np.asarray(hi)
        out = []
        stack = [0]
        while stack:
            n = self.nodes[stack.pop()]
            if n.axis < 0:
                seg = self.perm[n.start:n.end]
                pts = self.points[seg]
                keep = np.all((pts >= lo) & (pts <= hi), axis=1)
                out.extend(seg[keep].tolist())
                continue
            if lo[n.axis] <= n.split:
                stack.append(n.left)
            if hi[n.axis] >= n.split:
                stack.append(n.right)
        return np.asarray(sorted(out), np.int64)

    def nearest(self, query) -> int:
        """Index of the nearest point to `query`."""
        q = np.asarray(query, np.float64)
        best = (-1, np.inf)
        stack = [0]
        while stack:
            n = self.nodes[stack.pop()]
            if n.axis < 0:
                seg = self.perm[n.start:n.end]
                d = ((self.points[seg] - q) ** 2).sum(1)
                k = int(np.argmin(d))
                if d[k] < best[1]:
                    best = (int(seg[k]), float(d[k]))
                continue
            delta = q[n.axis] - n.split
            near, far = (n.left, n.right) if delta <= 0 else (n.right, n.left)
            if delta * delta < best[1]:
                stack.append(far)
            stack.append(near)
        return best[0]


class GenericBVH:
    """Bounding-volume hierarchy over (N, 2, D) AABBs (min, max)."""

    def __init__(self, boxes: np.ndarray, leaf_size: int = 8):
        self.boxes = np.asarray(boxes, np.float64)
        centers = self.boxes.mean(1)
        self.perm = np.arange(len(self.boxes))
        self.nodes = []
        self._build(centers, 0, len(self.boxes), 0, leaf_size)

    def _build(self, centers, start, end, depth, leaf_size) -> int:
        idx = len(self.nodes)
        seg = self.perm[start:end]
        bmin = self.boxes[seg, 0].min(0)
        bmax = self.boxes[seg, 1].max(0)
        node = {"bmin": bmin, "bmax": bmax, "left": -1, "right": -1,
                "start": start, "end": end}
        self.nodes.append(node)
        if end - start <= leaf_size:
            return idx
        axis = int(np.argmax(bmax - bmin))
        order = np.argsort(centers[seg, axis], kind="stable")
        self.perm[start:end] = seg[order]
        mid = (start + end) // 2
        node["left"] = self._build(centers, start, mid, depth + 1, leaf_size)
        node["right"] = self._build(centers, mid, end, depth + 1, leaf_size)
        return idx

    def query_box(self, lo, hi) -> np.ndarray:
        """Indices of boxes intersecting [lo, hi]."""
        lo = np.asarray(lo)
        hi = np.asarray(hi)
        out = []
        stack = [0]
        while stack:
            n = self.nodes[stack.pop()]
            if np.any(n["bmax"] < lo) or np.any(n["bmin"] > hi):
                continue
            if n["left"] < 0:
                for k in self.perm[n["start"]:n["end"]]:
                    if (np.all(self.boxes[k, 1] >= lo)
                            and np.all(self.boxes[k, 0] <= hi)):
                        out.append(int(k))
                continue
            stack.append(n["left"])
            stack.append(n["right"])
        return np.asarray(sorted(out), np.int64)
