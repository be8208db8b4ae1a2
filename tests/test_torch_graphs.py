"""The port's `graphs` (max-flow / min-cut on its own native solver, the
graph and DCEL types) and graph-cut foreground segmentation against the
JAX package's on the CPU, on the same numpy-seeded inputs: flows within
1e-12 relative, source sides, cut edges and masks exactly."""

import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from libstevi_tpu.graphs import dcel as JD
from libstevi_tpu.graphs import flow as JFlow
from libstevi_tpu.graphs import graphs as JG
from libstevi_tpu.imageproc import foreground_segmentation as JFG

from libstevi_tpu_torch import native
from libstevi_tpu_torch.graphs import dcel as TD
from libstevi_tpu_torch.graphs import flow as TFlow
from libstevi_tpu_torch.graphs import graphs as TG
from libstevi_tpu_torch.imageproc import foreground_segmentation as TFG

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def _graph(seed, integer=False):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 40))
    m = int(rng.integers(3, 160))
    edges = rng.integers(0, n, (m, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    if integer:
        caps = rng.integers(0, 20, len(edges)).astype(np.float64)
    else:
        caps = rng.uniform(0, 1, len(edges)) * np.pi
    return n, edges, caps


def _same_cut(a, b, rel=1e-12):
    assert a.max_flow == pytest.approx(b.max_flow, rel=rel, abs=1e-300)
    assert np.array_equal(a.source_side, b.source_side)
    assert a.cut_edges == b.cut_edges


@pytest.mark.parametrize("seed", range(6))
def test_native_max_flow_matches_jax(seed):
    """Float capacities through both packages' native solvers (the same
    C++ source, built apart): the flow within 1e-12 relative, the source
    side and the cut edges equal."""
    n, edges, caps = _graph(seed)
    _same_cut(TFlow.max_flow_min_cut(n, edges, caps, 0, n - 1),
              JFlow.max_flow_min_cut(n, edges, caps, 0, n - 1))


@pytest.mark.parametrize("seed", range(3))
def test_scipy_max_flow_matches_jax(seed):
    """``backend="scipy"`` stays an explicit choice: equal to the JAX
    package's scipy route on integer capacities, and to the native one."""
    n, edges, caps = _graph(100 + seed, integer=True)
    got = TFlow.max_flow_min_cut(n, edges, caps, 0, n - 1, backend="scipy")
    _same_cut(got, JFlow.max_flow_min_cut(n, edges, caps, 0, n - 1,
                                          backend="scipy"))
    assert got.max_flow == TFlow.max_flow_min_cut(n, edges, caps, 0,
                                                  n - 1).max_flow
    assert TFlow.reachable_vertices_in_cut(got) is got.source_side


def _native_state():
    d = REPO / "libstevi_tpu" / "native"
    return {p.name: (p.stat().st_mtime_ns,
                     hashlib.sha256(p.read_bytes()).hexdigest())
            for p in sorted(d.iterdir()) if p.is_file()}


def test_native_solver_builds_into_the_port_build_dir():
    """The port's solver is `libstevi_tpu_torch/native/maxflow.cpp` built
    into `libstevi_tpu_torch/_build/` under a name hashing the source and
    the flags; nothing under `libstevi_tpu/native/` is built, loaded or
    changed."""
    before = _native_state()
    n, edges, caps = _graph(7)
    TFlow.max_flow_min_cut(n, edges, caps, 0, n - 1)
    path = native.lib_path("maxflow")
    assert path.exists()
    assert path.parent == REPO / "libstevi_tpu_torch" / "_build"
    assert path.name.startswith("maxflow-") and path.suffix == ".so"
    loaded = Path(native.maxflow_library()._name).resolve()
    assert loaded == path.resolve()
    assert _native_state() == before


def test_native_backend_raises_without_a_compiler(tmp_path, monkeypatch):
    """Where the native solver cannot be built, ``backend="native"``
    raises: no fallback to the int32-quantised scipy route."""
    import warnings
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    native.maxflow_library.cache_clear()
    try:
        n, edges, caps = _graph(1)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
                TFlow.max_flow_min_cut(n, edges, caps, 0, n - 1)
        assert not (tmp_path / "_build").exists()
    finally:
        native.maxflow_library.cache_clear()
    with pytest.raises(ValueError, match="backend"):
        TFlow.max_flow_min_cut(n, edges, caps, 0, n - 1, backend="other")


def test_native_endpoint_check():
    """An edge endpoint outside [0, n) raises before the C++ solver runs
    (`flow.py:95-101`), with the JAX package's message."""
    edges, caps = np.array([[0, 1], [1, 5]]), np.array([1.0, 1.0])
    with pytest.raises(ValueError) as ej:
        JFlow.max_flow_min_cut(3, edges, caps, 0, 2)
    with pytest.raises(ValueError) as et:
        TFlow.max_flow_min_cut(3, edges, caps, 0, 2)
    assert str(et.value) == str(ej.value)


def _dcel_ops(mod):
    d = mod.DoublyConnectedEdgeList.with_vertices(9)
    faces = [d.make_face([3 * r + c, 3 * r + c + 1, 3 * r + c + 4,
                          3 * r + c + 3]) for r in range(2) for c in range(2)]
    faces.append(d.make_face([0, 1, 3]))
    e = d.external_edge_leaving_from(0)
    return (faces, [vars(x) for x in d.edges], d.vertices_out_edge, d.faces,
            d.exterior_cycle(), [d.face_vertices(f) for f in range(d.n_faces)],
            e, d.exterior_edge_for_vertex(2), d.edge_between_vertices(4, 5))


def test_dcel_and_graph_match_jax():
    """The plain-Python copies behave as the JAX package's: a 2x2 quad
    grid plus a rejected face, every link and query equal; the capacity
    matrix of a directed and an undirected graph equal."""
    assert _dcel_ops(TD) == _dcel_ops(JD)
    for kind in ("DIRECTED", "UNDIRECTED"):
        gs = []
        for mod in (TG, JG):
            g = mod.Graph(mod.EdgeDirectedType[kind])
            for _ in range(4):
                g.add_vertex()
            for u, v, w in ((0, 1, 2.0), (1, 2, 1.5), (2, 0, 0.5),
                            (3, 1, 4.0)):
                g.add_edge(u, v, w)
            gs.append((g.to_capacity_matrix(), list(g.out_edges(1))))
        np.testing.assert_array_equal(gs[0][0], gs[1][0])
        assert gs[0][1] == gs[1][1]


# -- graph-cut foreground segmentation -----------------------------------------

def _noisy_square(seed, H=24, W=24, sigma=0.3):
    rng = np.random.default_rng(seed)
    truth = np.zeros((H, W), bool)
    truth[H // 3:2 * H // 3, W // 3:2 * W // 3] = True
    cost = np.zeros((H, W, 2), np.float32)
    noise = rng.normal(0, sigma, (H, W))
    cost[..., 1] = np.where(truth, 0.2, 1.0) + noise   # fg label cost
    cost[..., 0] = np.where(truth, 1.0, 0.2) - noise   # bg label cost
    return cost, truth


@pytest.mark.parametrize("guided", [False, True], ids=["plain", "guided"])
def test_global_refined_mask_matches_jax(guided):
    """`TestFgSegmentation`'s noisy square (24x24): the mask equal to the
    JAX package's, at its accuracy bar; with an RGB guide too (the
    guided cost policy), the cost given as a tensor."""
    cost, truth = _noisy_square(0)
    guide = None
    if guided:
        guide = np.random.default_rng(1).uniform(0, 1, (24, 24, 3))
        guide[truth] += 1.0
    want = JFG.get_global_refined_mask(cost, 0.6, guide, min_switch_cost=0.1)
    got = TFG.get_global_refined_mask(torch.from_numpy(cost), 0.6,
                                      None if guide is None
                                      else torch.from_numpy(guide), 0.1)
    assert np.array_equal(got, want)
    assert (got == truth.astype(int)).mean() > 0.97


@pytest.mark.parametrize("guided", [False, True], ids=["plain", "guided"])
def test_hierarchical_refined_mask_matches_jax(guided):
    """Three levels (12x12, 24x24, 48x48) of a noisy square, coarsest
    first: the band refinement's mask equal to the JAX package's (with
    a guide per level too), and held to the truth."""
    costs, guides = [], []
    for k, s in enumerate((12, 24, 48)):
        c, truth = _noisy_square(10 + k, s, s, 0.2)
        costs.append(c)
        guides.append(np.random.default_rng(20 + k).uniform(0, 1, (s, s)))
    gd = guides if guided else None
    want = JFG.hierarchical_global_refined_mask(costs, 0.4, gd)
    got = TFG.hierarchical_global_refined_mask(
        [torch.from_numpy(c) for c in costs], 0.4, gd)
    assert np.array_equal(got, want)
    assert (got == truth.astype(int)).mean() > 0.95
    # numpy costs: the band dilations on the CPU
    assert np.array_equal(TFG.hierarchical_global_refined_mask(costs, 0.4, gd),
                          want)
