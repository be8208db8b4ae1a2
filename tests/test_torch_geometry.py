"""The port's `geometry` package (`libstevi_tpu_torch/geometry`) against the
JAX package's on the CPU, on the same numpy-seeded inputs: cross products,
rotations (the three regimes of the inverse Rodrigues formula, a tie in
the near-pi regime), quaternions, the rigid-body and similarity
transforms, Euler angles, image coordinates, the rotation speed, sensor
frames, the BSP/BVH indexes, the lens model with each subset of its terms
and the single-camera rectifier in each ROI mode.  Float32 on both sides;
the tolerance is stated in each test."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libstevi_tpu import geometry as J
from libstevi_tpu.geometry import bsp as jbsp
from libstevi_tpu.geometry import posesmath as jposes
from libstevi_tpu.geometry import sensorframes as jframes
from libstevi_tpu.geometry.lensdistortion import (
    inverse_skew_distortion as j_inv_skew,
    invert_tangential_distortion as j_inv_tan)

from libstevi_tpu_torch import geometry as T
from libstevi_tpu_torch.geometry import bsp as tbsp
from libstevi_tpu_torch.geometry import posesmath as tposes
from libstevi_tpu_torch.geometry import sensorframes as tframes
from libstevi_tpu_torch.geometry.lensdistortion import (
    inverse_skew_distortion as t_inv_skew,
    invert_tangential_distortion as t_inv_tan)

torch.set_num_threads(2)

CPU = "cpu"


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _j(x):
    return jnp.asarray(np.array(x, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _vectors(seed, n=6):
    """Axis-angle vectors: random angles up to 3, one tiny (the Taylor
    branch) and one exactly zero."""
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(n, 3))
    r = r / np.linalg.norm(r, axis=1, keepdims=True) \
        * rng.uniform(0.01, 3.0, (n, 1))
    return np.concatenate([r, [[1e-8, 0, 0], [0, 0, 0]]]).astype(np.float32)


# -- core and rotations --------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_skew_unskew_and_affine_match_jax(seed):
    """`skew`, `unskew` exactly; `AffineTransform` apply, compose and
    inverse within 1e-6."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(4, 3)).astype(np.float32)
    np.testing.assert_array_equal(T.skew(_t(a)).numpy(), J.skew(_j(a)))
    m = rng.normal(size=(3, 3)).astype(np.float32)
    np.testing.assert_array_equal(T.unskew(_t(m)).numpy(), J.unskew(_j(m)))
    R1, R2 = rng.normal(size=(2, 3, 3)).astype(np.float32)
    t1, t2 = rng.normal(size=(2, 3)).astype(np.float32)
    pts = rng.normal(size=(7, 3)).astype(np.float32)
    ja, jb = J.AffineTransform(_j(R1), _j(t1)), J.AffineTransform(_j(R2), _j(t2))
    ta, tb = T.AffineTransform(_t(R1), _t(t1)), T.AffineTransform(_t(R2), _t(t2))
    _close(ta.apply(_t(pts)), ja.apply(_j(pts)), 1e-6)
    _close((ta * tb).R, (ja * jb).R, 1e-6)
    _close((ta * tb).t, (ja * jb).t, 1e-6)
    _close(ta.inverse().t, ja.inverse().t, 1e-5)
    ident = T.AffineTransform.identity(CPU)
    _close(ident.apply(_t(pts)), pts, 0)


ROT_FUNCS = ["rodrigues_formula", "diff_rodrigues_lie_algebra",
             "axis_angle_to_quaternion"]


@pytest.mark.parametrize("name", ROT_FUNCS)
@pytest.mark.parametrize("seed", [0, 1])
def test_rotation_functions_match_jax(name, seed):
    """Each axis-angle function on random vectors, a 1e-8 one (the Taylor
    branch) and zero, within 1e-6."""
    r = _vectors(seed)
    _close(getattr(T, name)(_t(r)), getattr(J, name)(_j(r)), 1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_angle_axis_rotate_and_quaternions_match_jax(seed):
    """`angle_axis_rotate` of a point batch by one vector and by a vector
    a point; `quaternion_to_axis_angle` (both hemispheres) and
    `quaternion_product`; within 1e-5."""
    rng = np.random.default_rng(seed)
    r = _vectors(seed)
    v = rng.normal(size=r.shape).astype(np.float32)
    _close(T.angle_axis_rotate(_t(r[0]), _t(v)),
           J.angle_axis_rotate(_j(r[0]), _j(v)), 1e-5)
    _close(T.angle_axis_rotate(_t(r), _t(v)), J.angle_axis_rotate(_j(r), _j(v)),
           1e-5)
    q = rng.normal(size=(8, 4)).astype(np.float32)
    _close(T.quaternion_to_axis_angle(_t(q)), J.quaternion_to_axis_angle(_j(q)),
           1e-5)
    from libstevi_tpu.geometry.rotations import quaternion_product as jqp
    from libstevi_tpu_torch.geometry.rotations import quaternion_product as tqp
    _close(tqp(_t(q), _t(q[::-1].copy())), jqp(_j(q), _j(q[::-1].copy())), 1e-5)


def _regime(kind, seed):
    """Rotation matrices in one regime of `inverse_rodrigues_formula`
    (d = (trace - 1) / 2): near identity (d > 0.999), near pi (the
    antisymmetric part below 1e-3; one axis with equal x and y
    components, a tie for the dominant-row `argmax`), and generic."""
    rng = np.random.default_rng(seed)
    axes = rng.normal(size=(5, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    if kind == "identity":
        ang = rng.uniform(0.0, 0.04, (5, 1))
    elif kind == "pi":
        axes[0] = [1 / np.sqrt(2), 1 / np.sqrt(2), 0.0]
        axes[1] = [0.0, 0.0, 1.0]
        ang = np.pi - rng.uniform(0.0, 2e-4, (5, 1))
        ang[0] = np.pi
    else:
        ang = rng.uniform(0.2, 2.8, (5, 1))
    R = np.asarray(J.rodrigues_formula(_j(axes * ang)))
    return R, (axes * ang).astype(np.float32)


@pytest.mark.parametrize("kind", ["identity", "pi", "generic"])
@pytest.mark.parametrize("seed", [0, 1])
def test_inverse_rodrigues_three_regimes_match_jax(kind, seed):
    """The port's inverse within 2e-5 of JAX's on the same matrices in
    each regime (the near-pi `where` nesting and first-index `argmax`
    kept), and both within 1e-3 of the generating vector (up to the sign
    of the axis at pi)."""
    R, r = _regime(kind, seed)
    got = T.inverse_rodrigues_formula(_t(R)).numpy()
    want = np.asarray(J.inverse_rodrigues_formula(_j(R)))
    _close(got, want, 2e-5)
    err = np.minimum(np.abs(got - r).max(1), np.abs(got + r).max(1))
    assert (err < 1e-3).all(), err


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rigid_and_similarity_transforms_match_jax(seed):
    """`RigidBodyTransform` and `ShapePreservingTransform`: apply,
    compose, inverse, to/from affine and the on-manifold interpolation,
    within 1e-5."""
    rng = np.random.default_rng(seed)
    r1, r2, t1, t2 = rng.normal(size=(4, 3)).astype(np.float32) * 0.6
    pts = rng.normal(size=(7, 3)).astype(np.float32)
    ja, jb = J.RigidBodyTransform(_j(r1), _j(t1)), J.RigidBodyTransform(_j(r2), _j(t2))
    ta, tb = T.RigidBodyTransform(_t(r1), _t(t1)), T.RigidBodyTransform(_t(r2), _t(t2))
    for got, want in (((ta * tb).r, (ja * jb).r), ((ta * tb).t, (ja * jb).t),
                      (ta.inverse().t, ja.inverse().t),
                      (ta.apply(_t(pts)), ja.apply(_j(pts))),
                      (ta.to_affine().R, ja.to_affine().R),
                      (T.RigidBodyTransform.from_affine(ta.to_affine()).r,
                       J.RigidBodyTransform.from_affine(ja.to_affine()).r)):
        _close(got, want, 1e-5)
    ji = J.interpolate_rigid_body_transform_on_manifold(0.3, ja, 0.7, jb)
    ti = T.interpolate_rigid_body_transform_on_manifold(0.3, ta, 0.7, tb)
    _close(ti.r, ji.r, 1e-5)
    _close(ti.t, ji.t, 1e-5)
    s = 0.5 + rng.uniform()
    js = J.ShapePreservingTransform(_j(r1), _j(t1), jnp.float32(s))
    ts = T.ShapePreservingTransform(_t(r1), _t(t1), torch.tensor(s))
    js2 = J.ShapePreservingTransform(_j(r2), _j(t2), jnp.float32(2.0))
    ts2 = T.ShapePreservingTransform(_t(r2), _t(t2), torch.tensor(2.0))
    for got, want in ((ts.apply(_t(pts)), js.apply(_j(pts))),
                      (ts.inverse().apply(_t(pts)), js.inverse().apply(_j(pts))),
                      ((ts * ts2).r, (js * js2).r), ((ts * ts2).s, (js * js2).s),
                      (ts.to_affine().R, js.to_affine().R)):
        _close(got, want, 1e-5)
    ident = T.ShapePreservingTransform.identity(CPU)
    _close(ident.apply(_t(pts)), pts, 0)


@pytest.mark.parametrize("deg", [False, True])
def test_euler_matches_jax(deg):
    """Scalar and batched angles, in radians and degrees, within 1e-6."""
    angles = [(0.0, 0.0, np.pi / 2), (0.3, -0.2, 1.1)]
    if deg:
        angles = [tuple(np.degrees(a)) for a in angles]
    jf = J.euler_degxyz_to_rotation if deg else J.euler_radxyz_to_rotation
    tf = T.euler_degxyz_to_rotation if deg else T.euler_radxyz_to_rotation
    for a in angles:
        _close(tf(*a, device=CPU), jf(*a), 1e-6)
    batch = np.array(angles, np.float32).T
    _close(tf(*map(_t, batch)), jf(*map(_j, batch)), 1e-6)


@pytest.mark.parametrize("anchor", list(J.ImageAnchors), ids=lambda a: a.name)
@pytest.mark.parametrize("f", [500.0, np.array([500.0, 520.0])],
                         ids=["scalar", "pair"])
def test_image_coordinates_match_jax(anchor, f):
    """Both directions for each anchor, scalar and (2,) focal: exact."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 200, (9, 2)).astype(np.float32)
    pp = (100.0, 120.0)
    tanchor = T.ImageAnchors[anchor.name]
    hom_j = J.image_to_homogeneous(_j(pts), f, pp, anchor)
    hom_t = T.image_to_homogeneous(_t(pts), f, pp, tanchor)
    _close(hom_t, hom_j, 0)
    _close(T.homogeneous_to_image(hom_t, f, pp, tanchor),
           J.homogeneous_to_image(hom_j, f, pp, anchor), 0)


def test_rotation_speed_matches_jax():
    """`compute_rotation_speed` (`test_utils_extra.py`'s case and random
    pose pairs) within 1e-5."""
    rng = np.random.default_rng(4)
    r1 = np.concatenate([[[0, 0, 0]], rng.normal(0, 0.5, (5, 3))]).astype(np.float32)
    r2 = np.concatenate([[[0, 0, 0.1]], rng.normal(0, 0.5, (5, 3))]).astype(np.float32)
    _close(tposes.compute_rotation_speed(_t(r1), _t(r2), 0.5),
           jposes.compute_rotation_speed(_j(r1), _j(r2), 0.5), 1e-5)


FRAMES = ["RAS", "FLU", "NED", "ENU"]


@pytest.mark.parametrize("src", FRAMES)
@pytest.mark.parametrize("dst", FRAMES)
def test_sensor_frame_conversions_match_jax(src, dst):
    """The numpy copy gives JAX's conversion matrix exactly."""
    np.testing.assert_array_equal(
        tframes.get_sensor_frame_conversion(getattr(tframes, src),
                                            getattr(tframes, dst)),
        jframes.get_sensor_frame_conversion(getattr(jframes, src),
                                            getattr(jframes, dst)))


def test_sensor_frame_rejects_a_degenerate_system():
    for mod in (tframes, jframes):
        with pytest.raises(ValueError, match="orthogonal"):
            mod.AxisSystemDefinition(mod.Axis.RIGHT, mod.Axis.LEFT,
                                     mod.Axis.UP)


@pytest.mark.parametrize("seed", [0, 1])
def test_bsp_and_bvh_match_jax(seed):
    """`GenericBSP` nearest and range queries and `GenericBVH` box queries
    on random points and boxes: the same indices as JAX's copy."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (300, 3))
    jb, tb = jbsp.GenericBSP(pts), tbsp.GenericBSP(pts)
    for q in rng.uniform(-1, 1, (10, 3)):
        assert tb.nearest(q) == jb.nearest(q) == int(
            np.argmin(((pts - q) ** 2).sum(1)))
    lo, hi = np.array([-0.3, -0.5, -1.0]), np.array([0.4, 0.2, 0.5])
    np.testing.assert_array_equal(tb.range_query(lo, hi),
                                  jb.range_query(lo, hi))
    c = rng.uniform(-1, 1, (80, 3))
    boxes = np.stack([c - 0.05, c + 0.05], 1)
    jv, tv = jbsp.GenericBVH(boxes), tbsp.GenericBVH(boxes)
    np.testing.assert_array_equal(tv.query_box(lo, hi), jv.query_box(lo, hi))


# -- lens distortion -------------------------------------------------------------

K = np.array([0.1, -0.05, 0.01], np.float32)
TT = np.array([0.01, -0.02], np.float32)
B = np.array([2.0, 1.0], np.float32)
F2 = np.array([800.0, 820.0], np.float32)
PP = np.array([320.0, 240.0], np.float32)


def test_distortion_terms_match_jax():
    """Radial, tangential and skew terms and the skew inverse within
    1e-6 (pixels: 1e-4)."""
    rng = np.random.default_rng(5)
    pos = rng.uniform(-0.5, 0.5, (20, 2)).astype(np.float32)
    _close(T.radial_distortion(_t(pos), K), J.radial_distortion(_j(pos), K),
           1e-6)
    _close(T.tangential_distortion(_t(pos), TT),
           J.tangential_distortion(_j(pos), TT), 1e-6)
    px = T.skew_distortion(_t(pos), B, F2, PP)
    _close(px, J.skew_distortion(_j(pos), B, F2, PP), 1e-4)
    _close(t_inv_skew(px, B, F2, PP), j_inv_skew(_j(px.numpy()), B, F2, PP),
           1e-6)


@pytest.mark.parametrize("iters", [5, 10])
def test_distortion_inverses_match_jax(iters):
    """The three Newton inverses (fixed counts) within 1e-6."""
    rng = np.random.default_rng(6)
    pos = rng.uniform(-0.5, 0.5, (20, 2)).astype(np.float32)
    _close(T.invert_radial_distortion(_t(pos), K, iters),
           J.invert_radial_distortion(_j(pos), K, iters), 1e-6)
    _close(t_inv_tan(_t(pos), TT, iters), j_inv_tan(_j(pos), TT, iters), 1e-6)
    _close(T.invert_radial_tangential_distortion(_t(pos), K, TT, iters),
           J.invert_radial_tangential_distortion(_j(pos), K, TT, iters), 1e-6)


TERMS = {"none": {}, "k": dict(k123=K), "t": dict(t12=TT),
         "kt": dict(k123=K, t12=TT), "ktB": dict(k123=K, t12=TT, B12=B),
         "B": dict(B12=B)}


@pytest.mark.parametrize("terms", TERMS)
def test_full_lens_model_matches_jax(terms):
    """The forward model (pixels within 1e-3) and its inverse
    (homogeneous within 1e-6) with each subset of the terms; the inverse
    round-trips within 1e-4 (`test_geometry.py`'s bar)."""
    rng = np.random.default_rng(7)
    pos = rng.uniform(-0.3, 0.3, (15, 2)).astype(np.float32)
    kw = TERMS[terms]
    px_t = T.full_lens_distortion_homogeneous(_t(pos), F2, PP, **kw)
    px_j = J.full_lens_distortion_homogeneous(_j(pos), F2, PP, **kw)
    _close(px_t, px_j, 1e-3)
    back_t = T.invert_full_lens_distortion_homogeneous(px_t, F2, PP, **kw,
                                                       iters=10)
    back_j = J.invert_full_lens_distortion_homogeneous(_j(px_t.numpy()), F2,
                                                       PP, **kw, iters=10)
    _close(back_t, back_j, 1e-6)
    _close(back_t, pos, 1e-4)


@pytest.mark.parametrize("roi", ["same", "maximal", "minimal"])
@pytest.mark.parametrize("terms", ["none", "k", "kt", "ktB"])
def test_image_rectifier_matches_jax(roi, terms):
    """`ImageRectifier.compute` at 48x64 in each ROI mode: the same
    outcome and ROI, the backward map within 1e-4 px, the target
    principal point exact."""
    kw = TERMS[terms]
    jr = J.ImageRectifier(500.0, np.array([32.0, 24.0]), (48, 64), **kw)
    tr = T.ImageRectifier(500.0, np.array([32.0, 24.0]), (48, 64), **kw,
                          device=CPU)
    ok = jr.compute(roi)
    assert tr.compute(roi) == ok
    if not ok:
        return
    np.testing.assert_array_equal(tr.roi_top_left, jr.roi_top_left)
    np.testing.assert_array_equal(tr.roi_bottom_right, jr.roi_bottom_right)
    assert tr.backward_map.shape == jr.backward_map.shape
    _close(tr.backward_map, jr.backward_map, 1e-4)
    _close(tr.target_pp, jr.target_pp, 0)


def test_image_rectifier_identity_without_distortion():
    """`test_geometry.py`'s case: without distortion the 'same' map is the
    pixel grid; an unknown ROI method is refused."""
    rect = T.ImageRectifier(500.0, np.array([32.0, 24.0]), (48, 64),
                            device=CPU)
    assert rect.compute("same")
    bm = rect.backward_map.numpy()
    assert bm.shape == (48, 64, 2)
    np.testing.assert_allclose(bm[..., 0], np.arange(48)[:, None] * np.ones(64),
                               atol=1e-3)
    np.testing.assert_allclose(bm[..., 1], np.ones(48)[:, None] * np.arange(64),
                               atol=1e-3)
    assert not T.ImageRectifier(500.0, (32.0, 24.0), (48, 64), k123=K,
                                device=CPU).compute("other")


def test_exports_are_jax_exports():
    assert T.__all__ == J.__all__
