"""The port's point-cloud IO (`libstevi_tpu_torch/io/las_stream.py`,
`pointcloud_io.py`, `sdc_io.py`, `metacloud_io.py` and the LAS / LZF
codecs of `libstevi_tpu_torch/native/`) against the JAX package's.

Every codec's file written by the port equals the JAX package's file for
the same cloud byte for byte (LAS point formats 0-10 with VLRs, EVLRs and
extra bytes, PCD ascii / binary / binary_compressed, SDC 5.0-5.4, the
metacloud descriptor with its points file and sidecar), and each package
reads the other's file to the same arrays.  Then `tests/test_io.py`'s
point-cloud cases (LAS, PCD, the attribute mapper, streaming, SDC and
metacloud) run against the port."""

import filecmp
import glob
import os

import numpy as np
import pytest

from libstevi_tpu.io import las_stream as j_las
from libstevi_tpu.io import metacloud_io as j_meta
from libstevi_tpu.io import pointcloud_io as j_pc
from libstevi_tpu.io import sdc_io as j_sdc
from libstevi_tpu import native as j_native
from libstevi_tpu_torch import native as t_native
from libstevi_tpu_torch.io import (PointCloud, open_point_cloud, read_las,
                                   read_pcd, save_point_cloud, write_las,
                                   write_pcd)
from libstevi_tpu_torch.io import las_stream as t_las
from libstevi_tpu_torch.io import metacloud_io as t_meta
from libstevi_tpu_torch.io import pointcloud_io as t_pc
from libstevi_tpu_torch.io import sdc_io as t_sdc
from test_io import SAMPLES     # the reference's sample clouds, if present


def _same_files(a, b):
    assert filecmp.cmp(str(a), str(b), shallow=False), (a, b)


def _equal_chunks(a, b):
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _las_attrs(rng, n, pf):
    """Every attribute point format ``pf`` stores, plus two custom ones
    (a float32 and a uint8: extra bytes)."""
    a = {"intensity": rng.integers(0, 65535, n).astype(np.uint16),
         "return_number": rng.integers(1, 5, n).astype(np.uint8),
         "number_of_returns": np.full(n, 5, np.uint8),
         "scan_direction": rng.integers(0, 2, n).astype(np.uint8),
         "edge_of_flight_line": rng.integers(0, 2, n).astype(np.uint8),
         "classification": rng.integers(0, 31, n).astype(np.uint8),
         "synthetic": rng.integers(0, 2, n).astype(bool),
         "withheld": rng.integers(0, 2, n).astype(bool),
         "scan_angle": rng.integers(-90, 90, n).astype(np.int16),
         "user_data": rng.integers(0, 255, n).astype(np.uint8),
         "point_source_id": rng.integers(0, 100, n).astype(np.uint16),
         "reflectance": rng.uniform(-20, 10, n).astype(np.float32),
         "ring": rng.integers(0, 64, n).astype(np.uint8)}
    if pf >= 6:
        a["overlap"] = rng.integers(0, 2, n).astype(bool)
        a["scanner_channel"] = rng.integers(0, 3, n).astype(np.uint8)
    if pf in (1, 3, 4, 5) or pf >= 6:
        a["gps_time"] = rng.uniform(0, 1e6, n)
    if pf in (2, 3, 5, 7, 8, 10):
        a["rgb"] = rng.integers(0, 65535, (n, 3)).astype(np.uint16)
    if pf in (8, 10):
        a["nir"] = rng.integers(0, 65535, n).astype(np.uint16)
    if pf in (4, 5, 9, 10):
        a["wave_packet"] = rng.integers(0, 255, (n, 29)).astype(np.uint8)
    return a


# -- the files of the two packages, byte for byte ---------------------------

@pytest.mark.parametrize("pf", range(11))
def test_las_file_equals_jax(pf, rng, tmp_path):
    """`write_las_v2` of each package on one cloud of point format ``pf``
    with a VLR, an EVLR and extra bytes: the same bytes; each package
    reads the other's file to the same chunk, and the port reads back the
    cloud it wrote."""
    n = 257
    xyz = rng.uniform(-100, 100, (n, 3))
    attrs = _las_attrs(rng, n, pf)
    vlrs = [t_las.Vlr("MyApp", 7, b"hello payload", "test vlr"),
            t_las.Vlr("MyApp", 8, b"E" * 700, "evlr", is_evlr=True)]
    j_vlrs = [j_las.Vlr(v.user_id, v.record_id, v.payload, v.description,
                        v.is_evlr) for v in vlrs]
    pj, pt = tmp_path / "j.las", tmp_path / "t.las"
    j_las.write_las_v2(str(pj), xyz, attrs, point_format=pf, vlrs=j_vlrs)
    t_las.write_las_v2(str(pt), xyz, attrs, point_format=pf, vlrs=vlrs)
    _same_files(pj, pt)
    _equal_chunks(t_las.LasReader(str(pj)).read_chunk(0, n),
                  j_las.LasReader(str(pt)).read_chunk(0, n))
    r = t_las.LasReader(str(pt))
    assert r.header.point_format == pf and r.header.version == (1, 4)
    assert [(v.user_id, v.record_id, v.payload, v.is_evlr)
            for v in r.header.vlrs if v.user_id == "MyApp"] \
        == [(v.user_id, v.record_id, v.payload, v.is_evlr) for v in vlrs]
    assert r.attributes == j_las.LasReader(str(pj)).attributes
    ch = r.read_chunk(0, n)
    np.testing.assert_allclose(ch["xyz"], xyz, atol=1e-4)
    for k, v in attrs.items():
        if k in ("reflectance", "gps_time"):
            np.testing.assert_allclose(ch[k], v, err_msg=k)
        else:
            np.testing.assert_array_equal(ch[k], v, err_msg=k)


@pytest.mark.parametrize("mode", ["ascii", "binary", "binary_compressed"])
def test_pcd_file_equals_jax(mode, rng, tmp_path):
    """`write_pcd` of each package in each data mode: the same bytes, and
    `read_pcd` of each gives the same cloud from the other's file."""
    n = 300
    cloud = PointCloud(rng.uniform(-10, 10, (n, 3)),
                       {"intensity": rng.uniform(0, 1, n).astype(np.float32),
                        "label": rng.integers(0, 9, n).astype(np.uint16),
                        "offset": rng.integers(-99, 99, n).astype(np.int32)})
    kw = dict(binary=mode != "ascii", compressed=mode == "binary_compressed")
    pj, pt = tmp_path / "j.pcd", tmp_path / "t.pcd"
    j_pc.write_pcd(str(pj), j_pc.PointCloud(cloud.positions,
                                            cloud.attributes), **kw)
    write_pcd(str(pt), cloud, **kw)
    _same_files(pj, pt)
    a, b = read_pcd(str(pj)), j_pc.read_pcd(str(pt))
    np.testing.assert_array_equal(a.positions, b.positions)
    _equal_chunks(a.attributes, b.attributes)


@pytest.mark.parametrize("minor", range(5))
def test_sdc_file_equals_jax(minor, rng, tmp_path):
    """`write_sdc` of each package at SDC 5.``minor``: the same bytes;
    each package reads the other's file to the same cloud."""
    n = 120
    attrs = {"time": rng.uniform(0, 10, n),
             "range": rng.uniform(1, 50, n).astype(np.float32),
             "amplitude": rng.integers(0, 1000, n).astype(np.uint16),
             "targettype": rng.integers(0, 4, n).astype(np.uint8),
             "classid": rng.integers(0, 9, n).astype(np.uint8),
             "rho": rng.uniform(0, 1, n).astype(np.float32),
             "reflectance": rng.integers(-300, 300, n).astype(np.int16)}
    pos = rng.uniform(-5, 5, (n, 3))
    pj, pt = tmp_path / "j.sdc", tmp_path / "t.sdc"
    j_sdc.write_sdc(str(pj), j_pc.PointCloud(pos, attrs), 5, minor)
    t_sdc.write_sdc(str(pt), PointCloud(pos, attrs), 5, minor)
    _same_files(pj, pt)
    a, b = t_sdc.read_sdc(str(pj)), j_sdc.read_sdc(str(pt))
    np.testing.assert_array_equal(a.positions, b.positions)
    _equal_chunks(a.attributes, b.attributes)
    assert ("classid" in a.attributes) == (minor >= 2)
    assert ("reflectance" in a.attributes) == (minor >= 4)


def test_metacloud_files_equal_jax(rng, tmp_path):
    """`write_metacloud` of each package: the descriptor, the points LAS
    and the extra-attribute sidecar are the same bytes, and each package
    reads the other's metacloud to the same cloud and metadata."""
    n = 64
    pos = rng.uniform(-5, 5, (n, 3))
    attrs = {"intensity": rng.integers(0, 100, n).astype(np.uint16),
             "reflectance": rng.uniform(-10, 5, n).astype(np.float32),
             "ring": rng.integers(0, 32, n).astype(np.uint8),
             "valid": rng.integers(0, 2, n).astype(bool)}
    meta = {"sensor": "riegl x", "count": 42, "rate": 2.5}
    idx = [("idx.bsp", "bsp", "main")]
    for tag, mod, cls in (("j", j_meta, j_pc.PointCloud),
                          ("t", t_meta, PointCloud)):
        (tmp_path / tag).mkdir()
        mod.write_metacloud(str(tmp_path / tag / "c.metacloud"),
                            cls(pos, dict(attrs)), meta=meta,
                            index_files=idx)
    for name in ("c.metacloud", "c_points.las", "c_extra.bin"):
        _same_files(tmp_path / "j" / name, tmp_path / "t" / name)
    a = t_meta.read_metacloud(str(tmp_path / "j" / "c.metacloud"))
    b = j_meta.read_metacloud(str(tmp_path / "t" / "c.metacloud"))
    np.testing.assert_array_equal(a.positions, b.positions)
    assert sorted(a.attributes) == sorted(b.attributes)
    for k in a.attributes:
        np.testing.assert_array_equal(a.attributes[k], b.attributes[k])
    assert a.metacloud_attributes == b.metacloud_attributes == meta
    assert a.metacloud_index_files == b.metacloud_index_files == idx


@pytest.mark.parametrize("chunk", [128, 1000])
def test_chunk_writer_file_equals_jax(chunk, rng, tmp_path):
    """`LasChunkWriter` of each package, fed the same chunks (the header
    backpatched at close): the same bytes."""
    n = 1000
    xyz = rng.uniform(-50, 50, (n, 3))
    attrs = {"intensity": rng.integers(0, 9999, n).astype(np.uint16),
             "gps_time": rng.uniform(0, 1e5, n),
             "temperature": rng.uniform(-20, 40, n).astype(np.float32)}
    for tag, mod in (("j", j_las), ("t", t_las)):
        with mod.LasChunkWriter(str(tmp_path / f"{tag}.las")) as w:
            for s in range(0, n, chunk):
                w.write_chunk(xyz[s:s + chunk],
                              {k: v[s:s + chunk] for k, v in attrs.items()})
    _same_files(tmp_path / "j.las", tmp_path / "t.las")


def test_lzf_equals_jax_codec(rng):
    """The port's LZF build encodes as the JAX package's does and decodes
    either's stream."""
    for data in (b"", b"a" * 1000,
                 rng.integers(0, 4, 5000, dtype=np.uint8).tobytes(),
                 rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()):
        c = t_native.lzf_compress(data)
        assert c == j_native.lzf_compress(data)
        assert t_native.lzf_decompress(c, len(data)) == data
        assert j_native.lzf_decompress(c, len(data)) == data
    with pytest.raises(IOError):
        t_native.lzf_decompress(b"\xff\xff\xff", 10)


def test_codecs_build_into_the_port(tmp_path):
    """The codecs load from the port's own ``_build/`` (never the JAX
    package's committed libraries)."""
    for lib, name in ((t_native.las_library(), "las_codec"),
                      (t_native.lzf_library(), "lzf_codec")):
        assert lib._name == str(t_native.lib_path(name))
        assert os.path.dirname(lib._name).endswith(
            os.path.join("libstevi_tpu_torch", "_build"))


# -- `tests/test_io.py`'s cases, on the port --------------------------------

def test_las_round_trip(rng, tmp_path):
    n = 1000
    cloud = PointCloud(
        rng.uniform(-100, 100, (n, 3)),
        {"intensity": rng.integers(0, 65535, n).astype(np.uint16),
         "classification": rng.integers(0, 31, n).astype(np.uint8),
         "gps_time": rng.uniform(0, 1e6, n)})
    p = str(tmp_path / "c.las")
    write_las(p, cloud)
    back = read_las(p)
    assert back.n_points == n
    np.testing.assert_allclose(back.positions, cloud.positions, atol=1e-3)
    np.testing.assert_array_equal(back.attributes["intensity"],
                                  cloud.attributes["intensity"])
    np.testing.assert_allclose(back.attributes["gps_time"],
                               cloud.attributes["gps_time"])


@pytest.mark.parametrize("kind", ["las", "pcd", "sdc", "metacloud"])
def test_reads_reference_samples(kind):
    files = glob.glob(os.path.join(SAMPLES, kind, f"*.{kind}"))
    if not files:
        pytest.skip("no reference samples")
    ok = 0
    for path in files:
        try:
            cloud = open_point_cloud(path)
        except IOError:
            continue
        assert cloud.n_points > 0
        assert np.isfinite(cloud.positions).all()
        ok += 1
    assert ok >= 1


@pytest.mark.parametrize("binary", [True, False])
def test_pcd_round_trip(rng, binary, tmp_path):
    n = 200
    cloud = PointCloud(rng.uniform(-10, 10, (n, 3)),
                       {"intensity": rng.uniform(0, 1, n).astype(np.float32)})
    p = str(tmp_path / "c.pcd")
    write_pcd(p, cloud, binary=binary)
    back = read_pcd(p)
    assert back.n_points == n
    np.testing.assert_allclose(back.positions, cloud.positions, atol=1e-4)
    np.testing.assert_allclose(back.attributes["intensity"],
                               cloud.attributes["intensity"], atol=1e-6)


def test_pcd_binary_compressed_round_trip(rng, tmp_path):
    xyz = rng.normal(size=(500, 3))
    cloud = PointCloud(xyz, {"intensity":
                             rng.uniform(0, 1, 500).astype(np.float32)})
    p = str(tmp_path / "c.pcd")
    assert write_pcd(p, cloud, compressed=True)
    with open(p, "rb") as f:
        assert b"binary_compressed" in f.read(400)
    back = read_pcd(p)
    np.testing.assert_allclose(back.positions, xyz.astype(np.float32),
                               atol=1e-6)
    np.testing.assert_array_equal(back.attributes["intensity"],
                                  cloud.attributes["intensity"])


def test_rename_and_drop(rng):
    c = PointCloud(rng.uniform(size=(5, 3)),
                   {"a": np.arange(5), "b": np.ones(5)})
    r = c.rename_attributes({"a": "alpha"})
    assert "alpha" in r.attributes and "a" not in r.attributes
    d = r.drop_attributes(["b"])
    assert list(d.attributes) == ["alpha"]


def test_geometry_mapper(rng):
    """x <-> y swap and z extracted into a plain attribute (the vacated
    axis reads 0); the JAX package's mapper gives the same cloud."""
    pos = rng.uniform(-5, 5, (6, 3))
    c = PointCloud(pos.copy(), {"i": np.arange(6)})
    mapping = {"x": "y", "y": "x", "z": "newZ"}
    m = t_pc.map_point_cloud_attributes(c, mapping)
    np.testing.assert_array_equal(m.positions[:, 0], pos[:, 1])
    np.testing.assert_array_equal(m.positions[:, 1], pos[:, 0])
    np.testing.assert_array_equal(m.positions[:, 2], 0.0)
    np.testing.assert_array_equal(m.attributes["newZ"], pos[:, 2])
    assert "i" in m.attributes
    mj = j_pc.map_point_cloud_attributes(
        j_pc.PointCloud(pos.copy(), {"i": np.arange(6)}), mapping)
    np.testing.assert_array_equal(m.positions, mj.positions)
    _equal_chunks(m.attributes, mj.attributes)
    k = t_pc.map_point_cloud_attributes(c, {"z": "h"}, only_keep=True)
    assert list(k.attributes) == ["h"] and k.positions[:, 2].max() == 0


def test_mapper_stream(rng, tmp_path):
    """The chunk-streaming mapper equals the whole-cloud mapper on a LAS
    file."""
    n = 64
    c = PointCloud(rng.uniform(-5, 5, (n, 3)),
                   {"intensity": rng.integers(0, 99, n).astype(np.uint16)})
    path = str(tmp_path / "m.las")
    save_point_cloud(path, c)
    mapping = {"x": "y", "y": "x", "intensity": "amp"}
    st = t_pc.AttributeMapperStream(t_pc.open_point_cloud_stream(path),
                                    mapping)
    assert "amp" in st.attributes
    got = st.read_chunk(0, n)
    want = t_pc.map_point_cloud_attributes(open_point_cloud(path), mapping)
    np.testing.assert_allclose(got["xyz"], want.positions, atol=1e-6)
    np.testing.assert_array_equal(got["amp"], want.attributes["amp"])
    assert st.attributes == j_pc.AttributeMapperStream(
        j_pc.open_point_cloud_stream(path), mapping).attributes


def test_mapper_collision_raises(rng):
    c = PointCloud(rng.uniform(size=(4, 3)), {"intensity": np.arange(4)})
    with pytest.raises(ValueError):
        t_pc.map_point_cloud_attributes(c, {"intensity": "z"})
    with pytest.raises(ValueError):
        t_pc.map_point_cloud_attributes(c, {"z": "intensity"})
    m = t_pc.map_point_cloud_attributes(c, {"intensity": "z", "z": "old_z"})
    np.testing.assert_array_equal(m.positions[:, 2], np.arange(4))
    assert "old_z" in m.attributes


def test_sdc_round_trip(rng, tmp_path):
    n = 100
    cloud = PointCloud(rng.uniform(-5, 5, (n, 3)),
                       {"amplitude": rng.integers(0, 1000, n).astype(
                           np.uint16),
                        "time": rng.uniform(0, 10, n)})
    p = str(tmp_path / "c.sdc")
    t_sdc.write_sdc(p, cloud)
    back = t_sdc.read_sdc(p)
    np.testing.assert_allclose(back.positions, cloud.positions, atol=1e-5)
    np.testing.assert_array_equal(back.attributes["amplitude"],
                                  cloud.attributes["amplitude"])


def test_metacloud_round_trip(rng, tmp_path):
    cloud = PointCloud(rng.uniform(-5, 5, (40, 3)),
                       {"intensity": rng.integers(0, 100, 40).astype(
                           np.uint16)})
    p = str(tmp_path / "c.metacloud")
    t_meta.write_metacloud(p, cloud, meta={"creator": "test"})
    back = t_meta.read_metacloud(p)
    np.testing.assert_allclose(back.positions, cloud.positions, atol=1e-3)
    assert back.metacloud_attributes["creator"] == "test"


def test_metacloud_extra_attribute_sidecar(rng, tmp_path):
    n = 64
    cloud = PointCloud(
        rng.uniform(-5, 5, (n, 3)),
        {"intensity": rng.integers(0, 100, n).astype(np.uint16),
         "reflectance": rng.uniform(-10, 5, n).astype(np.float32),
         "ring": rng.integers(0, 32, n).astype(np.uint8)})
    p = str(tmp_path / "c.metacloud")
    t_meta.write_metacloud(p, cloud, meta={"sensor": "riegl x", "count": 42,
                                           "rate": 2.5},
                           index_files=[("idx.bsp", "bsp", "main")])
    assert (tmp_path / "c_extra.bin").exists()
    assert t_las.LasReader(str(tmp_path / "c_points.las")) \
        .header.extra_bytes == 0
    back = t_meta.read_metacloud(p)
    np.testing.assert_allclose(back.positions, cloud.positions, atol=1e-3)
    for k in ("intensity", "reflectance", "ring"):
        np.testing.assert_array_equal(back.attributes[k],
                                      cloud.attributes[k])
    assert back.metacloud_attributes["sensor"] == "riegl x"
    assert back.metacloud_attributes["count"] == 42
    assert isinstance(back.metacloud_attributes["count"], int)
    assert back.metacloud_attributes["rate"] == 2.5
    assert back.metacloud_index_files == [("idx.bsp", "bsp", "main")]


def test_metacloud_hand_written_descriptor(rng, tmp_path):
    n = 10
    write_las(str(tmp_path / "pts.las"), PointCloud(
        rng.uniform(0, 1, (n, 3)), {}))
    np.arange(n, dtype=np.float64).tofile(str(tmp_path / "e.bin"))
    (tmp_path / "h.metacloud").write_text(
        "# a comment\n"
        "POINTS_FILES\n"
        '  "pts.las"\n'
        "\n"
        "EXTRA_ATTRIBUTES\n"
        '"e.bin" float64 "height"\n'
        "METACLOUD_ATTRIBUTES\n"
        'quotednum "123"\n'
        "realnum 123\n")
    back = t_meta.read_metacloud(str(tmp_path / "h.metacloud"))
    np.testing.assert_allclose(back.attributes["height"], np.arange(n))
    assert back.metacloud_attributes["quotednum"] == "123"
    assert back.metacloud_attributes["realnum"] == 123


def _v2_attrs(rng, n):
    return {
        "intensity": rng.integers(0, 65535, n).astype(np.uint16),
        "classification": rng.integers(0, 255, n).astype(np.uint8),
        "gps_time": rng.uniform(0, 1e6, n),
        "rgb": rng.integers(0, 65535, (n, 3)).astype(np.uint16),
        "nir": rng.integers(0, 65535, n).astype(np.uint16),
        "return_number": rng.integers(1, 5, n).astype(np.uint8),
        "number_of_returns": np.full(n, 5, np.uint8),
        "scanner_channel": rng.integers(0, 3, n).astype(np.uint8),
        "synthetic": rng.integers(0, 2, n).astype(bool),
        "overlap": rng.integers(0, 2, n).astype(bool),
        "scan_angle": rng.integers(-15000, 15000, n).astype(np.int16),
        "point_source_id": rng.integers(0, 100, n).astype(np.uint16),
        "reflectance": rng.uniform(-20, 10, n).astype(np.float32),
        "ring": rng.integers(0, 64, n).astype(np.uint8),
    }


def test_las_format8_extra_bytes_vlr_evlr(rng, tmp_path):
    n = 1000
    xyz = rng.uniform(-100, 100, (n, 3))
    attrs = _v2_attrs(rng, n)
    vlrs = [t_las.Vlr("MyApp", 7, b"hello payload", "test vlr"),
            t_las.Vlr("MyApp", 8, b"E" * 70000, "big evlr", is_evlr=True)]
    p = str(tmp_path / "f8.las")
    t_las.write_las_v2(p, xyz, attrs, point_format=8, vlrs=vlrs)
    r = t_las.LasReader(p)
    assert r.header.version == (1, 4)
    assert r.header.point_format == 8
    assert r.header.extra_bytes == 5
    ch = r.read_chunk(0, n)
    np.testing.assert_allclose(ch["xyz"], xyz, atol=1e-3)
    for k in ("intensity", "classification", "rgb", "nir", "return_number",
              "number_of_returns", "scanner_channel", "scan_angle",
              "point_source_id", "synthetic", "overlap", "ring"):
        np.testing.assert_array_equal(ch[k], attrs[k])
    np.testing.assert_allclose(ch["gps_time"], attrs["gps_time"])
    np.testing.assert_allclose(ch["reflectance"], attrs["reflectance"])
    mine = [v for v in r.header.vlrs if v.user_id == "MyApp"]
    assert mine[0].payload == b"hello payload" and not mine[0].is_evlr
    assert len(mine[1].payload) == 70000 and mine[1].is_evlr


def test_las_chunked_streaming_matches_full(rng, tmp_path):
    n = 997
    xyz = rng.uniform(0, 10, (n, 3))
    inten = rng.integers(0, 65535, n).astype(np.uint16)
    p = str(tmp_path / "s.las")
    t_las.write_las_v2(p, xyz, {"intensity": inten}, point_format=6)
    r = t_las.LasReader(p)
    assert r.header.point_format == 6 and r.header.version == (1, 4)
    parts = list(r.chunks(size=100))
    np.testing.assert_array_equal(
        np.concatenate([c["intensity"] for c in parts]), inten)
    np.testing.assert_allclose(np.concatenate([c["xyz"] for c in parts]),
                               xyz, atol=1e-3)
    mid = r.read_chunk(500, 50)
    np.testing.assert_allclose(mid["xyz"], xyz[500:550], atol=1e-3)


def test_las_wave_packets_format9(rng, tmp_path):
    n = 64
    wp = rng.integers(0, 255, (n, 29)).astype(np.uint8)
    p = str(tmp_path / "f9.las")
    t_las.write_las_v2(p, rng.uniform(0, 1, (n, 3)),
                       {"gps_time": rng.uniform(0, 1, n),
                        "wave_packet": wp}, point_format=9)
    np.testing.assert_array_equal(
        t_las.LasReader(p).read_chunk(0, n)["wave_packet"], wp)


def test_las_legacy_classification_bits(rng, tmp_path):
    n = 128
    cloud = PointCloud(
        rng.uniform(0, 1, (n, 3)),
        {"classification": rng.integers(0, 31, n).astype(np.uint8),
         "synthetic": rng.integers(0, 2, n).astype(bool),
         "withheld": rng.integers(0, 2, n).astype(bool)})
    p = str(tmp_path / "leg.las")
    write_las(p, cloud, point_format=0)
    back = read_las(p)
    for k in ("classification", "synthetic", "withheld"):
        np.testing.assert_array_equal(back.attributes[k],
                                      cloud.attributes[k])


def test_las_descriptor_scale_offset(rng, tmp_path):
    n = 100
    vals = 5.0 + 0.01 * rng.integers(0, 1000, n)
    desc = [t_las.ExtraBytesDescriptor("scaled", 3, scale=0.01, offset=5.0)]
    p = str(tmp_path / "d.las")
    t_las.write_las_v2(p, rng.uniform(0, 1, (n, 3)), {"scaled": vals},
                       point_format=6, extra_descriptors=desc)
    ch = t_las.LasReader(p).read_chunk(0, n)
    np.testing.assert_allclose(ch["scaled"], vals, atol=1e-9)


def test_large_las_streams_in_bounded_chunks(tmp_path):
    """A 2M-point LAS iterates through fixed-size windows."""
    n = 2_000_000
    xyz = np.stack([np.arange(n, dtype=np.float64) % 1000,
                    np.arange(n, dtype=np.float64) // 1000,
                    np.zeros(n)], -1)
    p = str(tmp_path / "big.las")
    t_las.write_las_v2(p, xyz, {"intensity": (np.arange(n) % 65536).astype(
        np.uint16)}, point_format=0)
    r = t_pc.open_point_cloud_stream(p)
    assert r.n_points == n
    total, checksum = 0, 0
    for ch in r.chunks(size=250_000):
        assert len(ch["xyz"]) <= 250_000
        total += len(ch["xyz"])
        checksum += int(ch["intensity"].sum())
    assert total == n
    assert checksum == int((np.arange(n) % 65536).sum())


def test_stream_adapter_for_pcd(rng, tmp_path):
    cloud = PointCloud(rng.uniform(0, 1, (100, 3)),
                       {"i": rng.uniform(0, 1, 100).astype(np.float32)})
    p = str(tmp_path / "c.pcd")
    write_pcd(p, cloud)
    r = t_pc.open_point_cloud_stream(p)
    assert isinstance(r, t_pc.InMemoryStream) and r.n_points == 100
    ch = r.read_chunk(40, 10)
    np.testing.assert_allclose(ch["xyz"], cloud.positions[40:50], atol=1e-6)
    np.testing.assert_allclose(ch["i"], cloud.attributes["i"][40:50])


def test_chunk_writer_multichunk_equals_monolithic(rng, tmp_path):
    n = 1000
    xyz = rng.uniform(-50, 50, (n, 3))
    attrs = {"intensity": rng.integers(0, 9999, n).astype(np.uint16),
             "gps_time": rng.uniform(0, 1e5, n),
             "temperature": rng.uniform(-20, 40, n).astype(np.float32)}
    mono = str(tmp_path / "mono.las")
    t_las.write_las_v2(mono, xyz, attrs)
    chunked = str(tmp_path / "chunked.las")
    with t_las.LasChunkWriter(chunked) as w:
        for s in range(0, n, 128):
            w.write_chunk(xyz[s:s + 128],
                          {k: v[s:s + 128] for k, v in attrs.items()})
    ra, rb = t_las.LasReader(mono), t_las.LasReader(chunked)
    assert rb.n_points == n
    ca, cb = ra.read_chunk(0, n), rb.read_chunk(0, n)
    np.testing.assert_allclose(cb["xyz"], ca["xyz"], atol=2e-4)
    np.testing.assert_array_equal(cb["intensity"], ca["intensity"])
    np.testing.assert_allclose(cb["temperature"], ca["temperature"],
                               rtol=1e-6)
    np.testing.assert_allclose(rb.header.mins, xyz.min(0), atol=2e-4)
    np.testing.assert_allclose(rb.header.maxs, xyz.max(0), atol=2e-4)


def test_stream_to_stream(rng, tmp_path):
    n = 500
    c = PointCloud(rng.uniform(-5, 5, (n, 3)),
                   {"intensity": rng.integers(0, 99, n).astype(np.uint16)})
    src, dst = str(tmp_path / "s.las"), str(tmp_path / "d.las")
    save_point_cloud(src, c)
    st = t_pc.AttributeMapperStream(t_pc.open_point_cloud_stream(src),
                                    {"x": "y", "y": "x"})
    t_pc.write_point_cloud_stream(dst, st, chunk_size=100)
    back = open_point_cloud(dst)
    np.testing.assert_allclose(back.positions[:, 0], c.positions[:, 1],
                               atol=1e-3)
    np.testing.assert_allclose(back.positions[:, 1], c.positions[:, 0],
                               atol=1e-3)
    np.testing.assert_array_equal(back.attributes["intensity"],
                                  c.attributes["intensity"])
    # a PCD destination materializes the stream through `save_point_cloud`
    t_pc.write_point_cloud_stream(str(tmp_path / "d.pcd"), st,
                                  chunk_size=100)
    np.testing.assert_allclose(read_pcd(str(tmp_path / "d.pcd")).positions,
                               back.positions, atol=1e-4)


def test_chunk_writer_fmt7_evlr(rng, tmp_path):
    n = 300
    xyz = rng.uniform(-10, 10, (n, 3))
    attrs = {"gps_time": rng.uniform(0, 1e4, n),
             "rgb": rng.integers(0, 65535, (n, 3)).astype(np.uint16),
             "score": rng.uniform(0, 1, n).astype(np.float64)}
    path = str(tmp_path / "c7.las")
    vlrs = [t_las.Vlr("MyApp", 7, b"hdr payload", "in header"),
            t_las.Vlr("MyApp", 9, b"E" * 4096, "after points", is_evlr=True)]
    with t_las.LasChunkWriter(path, point_format=7, vlrs=vlrs) as w:
        for s in range(0, n, 77):
            w.write_chunk(xyz[s:s + 77],
                          {k: v[s:s + 77] for k, v in attrs.items()})
    r = t_las.LasReader(path)
    assert r.header.point_format == 7 and r.header.version == (1, 4)
    assert r.n_points == n
    ch = r.read_chunk(0, n)
    np.testing.assert_allclose(ch["xyz"], xyz, atol=2e-4)
    np.testing.assert_array_equal(ch["rgb"], attrs["rgb"])
    np.testing.assert_allclose(ch["score"], attrs["score"], rtol=1e-12)
    evs = [v for v in r.header.vlrs if v.is_evlr and v.user_id == "MyApp"]
    assert len(evs) == 1 and len(evs[0].payload) == 4096
    hdrs = [v for v in r.header.vlrs if not v.is_evlr
            and v.user_id == "MyApp"]
    assert hdrs and hdrs[0].payload == b"hdr payload"


def test_descriptor_signed_no_data_round_trip():
    d = t_las.ExtraBytesDescriptor("height", 6, no_data=-1.0)
    assert t_las.ExtraBytesDescriptor.unpack(d.pack()).no_data == -1.0
    assert d.pack() == j_las.ExtraBytesDescriptor("height", 6,
                                                  no_data=-1.0).pack()


def test_descriptor_non_ascii_name_keeps_record_length():
    a = t_las.ExtraBytesDescriptor("héight", 9)
    b = t_las.ExtraBytesDescriptor("plain", 9)
    assert len(a.pack()) == 192
    descs = t_las.parse_extra_bytes_vlr(a.pack() + b.pack())
    assert descs[1].name == "plain" and descs[1].data_type == 9


def test_nir_format_inference_and_guard(rng, tmp_path):
    n = 40
    xyz = rng.uniform(-1, 1, (n, 3))
    attrs = {"gps_time": rng.uniform(0, 1, n),
             "rgb": rng.integers(0, 99, (n, 3)).astype(np.uint16),
             "nir": rng.integers(0, 99, n).astype(np.uint16)}
    p = str(tmp_path / "nir.las")
    t_las.write_las_v2(p, xyz, attrs)
    r = t_las.LasReader(p)
    assert r.header.point_format == 8
    np.testing.assert_array_equal(r.read_chunk(0, n)["nir"], attrs["nir"])
    with pytest.raises(ValueError):
        w = t_las.LasChunkWriter(str(tmp_path / "bad.las"), point_format=2)
        w.write_chunk(xyz, attrs)


def test_scaled_extra_bytes_write_inversion(rng, tmp_path):
    n = 30
    xyz = rng.uniform(-1, 1, (n, 3))
    desc = [t_las.ExtraBytesDescriptor("temp", 3, scale=0.01, offset=5.0)]
    vals = 5.0 + 0.01 * rng.integers(0, 1000, n)
    p1, p2 = str(tmp_path / "a.las"), str(tmp_path / "b.las")
    with t_las.LasChunkWriter(p1, extra_descriptors=desc) as w:
        w.write_chunk(xyz, {"temp": vals})
    r1 = t_las.LasReader(p1)
    got1 = r1.read_chunk(0, n)["temp"]
    np.testing.assert_allclose(got1, vals, atol=1e-9)
    with t_las.LasChunkWriter(p2, extra_descriptors=r1.extra_descriptors) \
            as w:
        w.write_chunk(xyz, {"temp": got1})
    np.testing.assert_allclose(t_las.LasReader(p2).read_chunk(0, n)["temp"],
                               vals, atol=1e-9)


def test_oversized_header_vlr_promoted_to_evlr(rng, tmp_path):
    p = str(tmp_path / "big.las")
    with t_las.LasChunkWriter(p, vlrs=[t_las.Vlr("MyApp", 1, b"x" * 70000,
                                                 "big")]) as w:
        w.write_chunk(rng.uniform(-1, 1, (10, 3)), {})
    r = t_las.LasReader(p)
    mine = [v for v in r.header.vlrs if v.user_id == "MyApp"]
    assert len(mine) == 1 and mine[0].is_evlr
    assert len(mine[0].payload) == 70000
    assert r.n_points == 10


def test_empty_chunk_writer_and_bad_files(tmp_path):
    """Zero chunks give a valid empty cloud (as in JAX); a file that is
    no LAS, and an unknown extension, raise IOError."""
    p = str(tmp_path / "empty.las")
    t_las.LasChunkWriter(p).close()
    j_las.LasChunkWriter(str(tmp_path / "j.las")).close()
    _same_files(p, tmp_path / "j.las")
    assert t_las.LasReader(p).n_points == 0
    (tmp_path / "junk.las").write_bytes(b"not a las file at all" * 20)
    with pytest.raises(IOError):
        t_las.LasReader(str(tmp_path / "junk.las"))
    with pytest.raises(IOError):
        open_point_cloud(str(tmp_path / "c.xyz"))
    with pytest.raises(IOError):
        save_point_cloud(str(tmp_path / "c.xyz"),
                         PointCloud(np.zeros((1, 3)), {}))
