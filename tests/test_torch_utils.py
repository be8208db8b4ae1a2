"""The port's `utils` (`libstevi_tpu_torch/utils/profiling.py`,
`checkpointing.py`) against the JAX package's (`libstevi_tpu/utils`):
the cost analysis of a matrix product equals XLA's, the roofline report
has JAX's keys, a trace is written, and checkpoints written by either
package load in the other into the same tree (JAX's leaf order: sorted
dict keys, ``None`` no leaf)."""

import collections
import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libstevi_tpu import utils as j_utils
from libstevi_tpu_torch import utils as t_utils
from libstevi_tpu_torch.utils import checkpointing as t_ckpt
from libstevi_tpu_torch.utils import profiling as t_prof

torch.set_num_threads(2)


# -- profiling ---------------------------------------------------------------

def test_cost_analysis_of_a_matmul_equals_jax(rng):
    """(64, 128) @ (128, 32) float32: 2 * 64 * 128 * 32 = 524288 flops and
    (64 * 128 + 128 * 32 + 64 * 32) * 4 = 57344 bytes, in both packages."""
    a = rng.uniform(size=(64, 128)).astype(np.float32)
    b = rng.uniform(size=(128, 32)).astype(np.float32)
    got = t_utils.cost_analysis(lambda x, y: x @ y, torch.from_numpy(a),
                                torch.from_numpy(b))
    want = j_utils.cost_analysis(lambda x, y: x @ y, jnp.asarray(a),
                                 jnp.asarray(b))
    assert got == {"flops": 524288.0, "bytes accessed": 57344.0}
    assert want["flops"] == got["flops"]
    assert want["bytes accessed"] == got["bytes accessed"]


def test_cost_analysis_counts_ops_not_views(rng):
    """An elementwise op moves its inputs and output and counts no flops
    (XLA counts one a result: the port's docstring says so); views move
    nothing; a convolution's flops are counted."""
    x = torch.from_numpy(rng.uniform(size=(100, 30)).astype(np.float32))
    ca = t_utils.cost_analysis(lambda a: a + 1.0, x)
    assert ca == {"flops": 0.0, "bytes accessed": 2 * 3000 * 4.0}
    ca = t_utils.cost_analysis(lambda a: a.reshape(-1)[:10].view(2, 5), x)
    assert ca["bytes accessed"] == 0.0
    ca = t_utils.cost_analysis(lambda a: a.T.reshape(-1), x)
    assert ca["bytes accessed"] == 2 * 3000 * 4.0        # one copy
    idx = torch.zeros(3000, dtype=torch.int64)
    ca = t_utils.cost_analysis(
        lambda a: torch.zeros(1).scatter_reduce_(0, idx, a.reshape(-1),
                                                 "amin"), x)
    # zeros writes 4 bytes; scatter_reduce_ reads self, index and src and
    # writes self
    assert ca["bytes accessed"] == 4 + 4 + 3000 * 8 + 3000 * 4 + 4
    img = torch.zeros(1, 1, 16, 16)
    w = torch.zeros(1, 1, 3, 3)
    ca = t_utils.cost_analysis(torch.nn.functional.conv2d, img, w)
    assert ca["flops"] == 2 * 14 * 14 * 9


def test_roofline_has_jax_keys(rng):
    x = rng.uniform(size=(128, 128)).astype(np.float32)
    got = t_utils.roofline(lambda a: a @ a + 1.0, torch.from_numpy(x),
                           iters=3)
    want = j_utils.roofline(lambda a: a @ a + 1.0, jnp.asarray(x), iters=3)
    assert list(got) == list(want)
    # XLA also counts the add's 128 * 128 flops
    assert got["flops"] == 2 * 128 ** 3
    assert want["flops"] == 2 * 128 ** 3 + 128 ** 2
    assert got["bound_by"] in ("memory", "compute")
    assert got["measured_s"] > 0 and np.isfinite(
        got["fraction_of_roofline"])
    assert got["memory_bound_s"] == got["bytes_accessed"] \
        / t_utils.H100_HBM_BYTES_PER_S
    assert got["compute_bound_s"] == got["flops"] \
        / t_utils.H100_PEAK_FLOPS_F32


def test_h100_peaks():
    """The H100 SXM5 80GB HBM3's published peaks at 700 W (no TPU
    constant is carried over)."""
    assert t_utils.H100_HBM_BYTES_PER_S == 3.35e12
    assert t_utils.H100_PEAK_FLOPS_F32 == 67e12
    assert t_utils.H100_PEAK_FLOPS_BF16 == 989e12
    assert not [k for k in dir(t_prof) if k.startswith("V5E")]


def test_device_time_measures_work(rng):
    x = torch.from_numpy(rng.uniform(size=(256, 256)).astype(np.float32))
    t_small = t_utils.device_time(lambda a: a * 2.0, x, iters=5)

    def big(a):
        for _ in range(8):
            a = a @ a * 1e-3
        return a

    t_big = t_utils.device_time(big, x, iters=5)
    assert t_small > 0 and np.isfinite(t_small)
    assert t_big > 2 * t_small
    measure = t_utils.device_timer(big, x)
    assert measure(2) > 0 and measure(3) > 0


def test_trace_writes_a_trace(tmp_path, rng):
    x = torch.from_numpy(rng.uniform(size=(64, 64)).astype(np.float32))
    with t_utils.trace(str(tmp_path)) as prof:
        torch.mul(x, 3.0)
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mul" in names
    assert any(e.key == "aten::mul" for e in prof.key_averages())


# -- checkpointing -----------------------------------------------------------

Pair = collections.namedtuple("Pair", "left right")


def _trees(rng):
    """One state as the port holds it and as the JAX package does: dict
    keys out of order, ``None`` entries, a named tuple, Python and numpy
    scalars."""
    a = rng.normal(size=(7, 3)).astype(np.float32)
    b = rng.integers(0, 9, (4,)).astype(np.int32)
    c = rng.normal(size=(2, 2)).astype(np.float32)
    port = {"zeta": torch.from_numpy(a), "alpha": None,
            "mid": [torch.from_numpy(b), None, (torch.from_numpy(c), 2.5)],
            "pair": Pair(torch.tensor(1.5), np.int64(4))}
    jax_ = {"zeta": jnp.asarray(a), "alpha": None,
            "mid": [jnp.asarray(b), None, (jnp.asarray(c), 2.5)],
            "pair": Pair(jnp.float32(1.5), np.int64(4))}
    return port, jax_


def _check(back, port):
    assert list(back) == list(port) and back["alpha"] is None
    torch.testing.assert_close(back["zeta"], port["zeta"], rtol=0, atol=0)
    assert back["mid"][1] is None
    torch.testing.assert_close(back["mid"][0], port["mid"][0], rtol=0,
                               atol=0)
    assert back["mid"][2][0].dtype == port["mid"][2][0].dtype
    torch.testing.assert_close(back["mid"][2][0], port["mid"][2][0],
                               rtol=0, atol=0)
    assert float(back["mid"][2][1]) == 2.5
    assert isinstance(back["pair"], Pair) and int(back["pair"].right) == 4
    assert back["pair"].left.item() == 1.5


def test_leaf_order_is_jax(rng):
    """`_flatten` numbers the leaves as `jax.tree_util.tree_flatten`
    does (sorted keys, no leaf for None; an OrderedDict in its order)."""
    import jax
    port, jax_ = _trees(rng)
    got = [np.asarray(l) for l in t_ckpt._flatten(port)]
    want = [np.asarray(l) for l in jax.tree_util.tree_leaves(jax_)]
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    od = collections.OrderedDict([("b", 1), ("a", 2)])
    assert t_ckpt._flatten(od) == jax.tree_util.tree_leaves(od) == [1, 2]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_cross_loads(writer, rng, tmp_path):
    """A checkpoint of one package loads in the other into the same tree:
    the port's ``like`` tree gets tensors of its leaves' dtypes, JAX's gets
    its arrays."""
    import jax
    port, jax_ = _trees(rng)
    if writer == "jax":
        path = j_utils.save_checkpoint(str(tmp_path), 3, jax_)
    else:
        path = t_utils.save_checkpoint(str(tmp_path), 3, port)
    assert os.path.basename(path) == "step_00000003.npz"
    _check(t_utils.load_checkpoint(path, like=port), port)
    back = j_utils.load_checkpoint(path, like=jax_)
    for g, w in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jax_)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert jax.tree_util.tree_structure(back) \
        == jax.tree_util.tree_structure(jax_)


def test_checkpoint_round_trip_and_latest(rng, tmp_path):
    tree = {"x": torch.from_numpy(rng.normal(size=(7, 3)).astype(
        np.float32)), "step": np.int64(4),
        "nested": [torch.arange(5), np.float32(2.5)]}
    p = t_utils.save_checkpoint(str(tmp_path), 12, tree)
    t_utils.save_checkpoint(str(tmp_path), 9, tree)
    step, path = t_utils.latest_checkpoint(str(tmp_path))
    assert step == 12 and path == p
    assert t_utils.latest_checkpoint(str(tmp_path / "none")) is None
    back = t_utils.load_checkpoint(path, like=tree)
    assert torch.equal(back["x"], tree["x"])
    assert torch.equal(back["nested"][0], tree["nested"][0])
    assert back["step"] == 4
    leaves = t_utils.load_checkpoint(path)
    assert [l.shape for l in leaves] == [(5,), (), (), (7, 3)]
    assert not [f for f in os.listdir(tmp_path) if "tmp" in f]


def test_checkpoint_restores_like_dtype_and_refuses_mismatch(rng, tmp_path):
    x = torch.from_numpy(rng.normal(size=(3,)))
    p = t_utils.save_checkpoint(str(tmp_path), 1, {"x": x})
    like = {"x": torch.zeros(3, dtype=torch.float32)}
    back = t_utils.load_checkpoint(p, like=like)
    assert back["x"].dtype == torch.float32
    torch.testing.assert_close(back["x"], x.float(), rtol=0, atol=0)
    with pytest.raises(ValueError):
        t_utils.load_checkpoint(p, like={"x": x, "y": x})


def test_bfloat16_leaf(rng, tmp_path):
    """A bfloat16 leaf: the JAX package's file holds its raw 16-bit
    patterns (numpy ``V2``); the port writes the same and loads either
    file's leaf into a bfloat16 tensor bit for bit; into any other dtype
    it refuses."""
    v = rng.normal(size=(5,)).astype(np.float32)
    tb = torch.from_numpy(v).bfloat16()
    pj = j_utils.save_checkpoint(str(tmp_path / "j"), 1,
                                 {"w": jnp.asarray(v, jnp.bfloat16)})
    pt = t_utils.save_checkpoint(str(tmp_path / "t"), 1, {"w": tb})
    with np.load(pj) as zj, np.load(pt) as zt:
        assert zj["leaf_0"].dtype.kind == zt["leaf_0"].dtype.kind == "V"
        assert zj["leaf_0"].tobytes() == zt["leaf_0"].tobytes()
    for p in (pj, pt):
        back = t_utils.load_checkpoint(p, like={"w": torch.zeros(
            5, dtype=torch.bfloat16)})["w"]
        assert back.dtype == torch.bfloat16 and torch.equal(back, tb)
        with pytest.raises(ValueError):
            t_utils.load_checkpoint(p, like={"w": torch.zeros(5)})


def test_resumable_iterate_resumes(tmp_path):
    calls = []

    def step(s):
        calls.append(1)
        return {"v": s["v"] + 1, "skip": None}

    start = {"v": torch.tensor(0), "skip": None}
    out = t_utils.resumable_iterate(step, start, 5, str(tmp_path),
                                    checkpoint_every=2)
    assert out["v"].item() == 5 and len(calls) == 5
    assert sorted(os.listdir(tmp_path)) == [
        "step_00000002.npz", "step_00000004.npz", "step_00000005.npz"]
    calls.clear()
    out = t_utils.resumable_iterate(step, start, 5, str(tmp_path))
    assert out["v"].item() == 5 and len(calls) == 0
    out = t_utils.resumable_iterate(step, start, 8, str(tmp_path))
    assert out["v"].item() == 8 and len(calls) == 3
    # the JAX package resumes from the port's checkpoints, and the reverse
    out = j_utils.resumable_iterate(
        lambda s: {"v": s["v"] + 1, "skip": None},
        {"v": np.int64(0), "skip": None}, 10, str(tmp_path))
    assert int(out["v"]) == 10
    out = t_utils.resumable_iterate(step, start, 11, str(tmp_path))
    assert out["v"].item() == 11


def test_resume_after_a_stop_equals_the_run(tmp_path):
    """A run stopped after 3 of 6 steps (a checkpoint every 2) and resumed
    ends in the uninterrupted run's state, bit for bit."""
    def step(s):
        x = s["x"]
        return {"x": x - 0.1 * torch.sin(x) * x, "n": s["n"] + 1}

    s0 = {"x": torch.linspace(-3, 3, 101), "n": torch.tensor(0)}
    whole = t_utils.resumable_iterate(step, s0, 6, str(tmp_path / "a"),
                                      checkpoint_every=2)
    calls = []

    def stopping(s):
        if len(calls) == 3:
            raise KeyboardInterrupt
        calls.append(1)
        return step(s)

    with pytest.raises(KeyboardInterrupt):
        t_utils.resumable_iterate(stopping, s0, 6, str(tmp_path / "b"),
                                  checkpoint_every=2)
    assert t_utils.latest_checkpoint(str(tmp_path / "b"))[0] == 2
    resumed = t_utils.resumable_iterate(step, s0, 6, str(tmp_path / "b"),
                                        checkpoint_every=2)
    assert torch.equal(resumed["x"], whole["x"])
    assert resumed["n"].item() == whole["n"].item() == 6
