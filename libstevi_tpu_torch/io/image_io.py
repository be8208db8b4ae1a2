"""Image IO in numpy, the counterpart of `libstevi_tpu/io/image_io.py`:
``.stevimg`` (the reference's raw format), ``.flo`` (Middlebury optical
flow), ``.pfm`` (float disparities) and ``.exr`` (`exr_io`), and
`read_image`/`write_image`, which dispatch on the extension as the JAX
package's do.  Every other extension (PNG, JPEG, BMP, ...) goes to
imageio, imported where it is used as the JAX package imports it: where
imageio is not installed those formats raise its ImportError, and the
four formats above still work.

Reference parity: `io/image_io.h:49-160` — a ``.stevimg`` file is a text
header line ``<dtype> <ndim> <shape...> <strides...>`` with dtype
descriptors like ``f32``/``u8`` followed by raw row-major data;
`read_flo.h:14` — ``.flo`` is the float magic 202021.25, int32 width and
height, then interleaved float2.
"""

from __future__ import annotations

import os

import numpy as np

_DTYPE_DESCR = {
    np.dtype(np.uint8): "u8", np.dtype(np.int8): "i8",
    np.dtype(np.uint16): "u16", np.dtype(np.int16): "i16",
    np.dtype(np.uint32): "u32", np.dtype(np.int32): "i32",
    np.dtype(np.uint64): "u64", np.dtype(np.int64): "i64",
    np.dtype(np.float32): "f32", np.dtype(np.float64): "f64",
}
_DESCR_DTYPE = {v: k for k, v in _DTYPE_DESCR.items()}

_FLO_MAGIC = 202021.25


def write_stevimg(path: str, image: np.ndarray) -> bool:
    img = np.ascontiguousarray(image)
    descr = _DTYPE_DESCR.get(img.dtype)
    if descr is None:
        raise ValueError(f"unsupported dtype {img.dtype}")
    strides = [s // img.itemsize for s in img.strides]
    header = (f"{descr} {img.ndim} "
              + " ".join(str(s) for s in img.shape) + " "
              + " ".join(str(s) for s in strides) + "\n")
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(img.tobytes())
    return True


def read_stevimg(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"\n"):
            c = f.read(1)
            if not c:
                raise ValueError("truncated stevimg header")
            header += c
        parts = header.decode().split()
        dtype = _DESCR_DTYPE[parts[0]]
        ndim = int(parts[1])
        shape = tuple(int(v) for v in parts[2:2 + ndim])
        data = np.frombuffer(f.read(), dtype=dtype)
    return data.reshape(shape).copy()


def write_flo(path: str, flow: np.ndarray) -> bool:
    """flow: (H, W, 2) float32."""
    H, W, C = flow.shape
    assert C == 2
    with open(path, "wb") as f:
        np.float32(_FLO_MAGIC).tofile(f)
        np.int32(W).tofile(f)
        np.int32(H).tofile(f)
        flow.astype(np.float32).tofile(f)
    return True


def read_flo(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, 1)[0]
        if abs(magic - _FLO_MAGIC) > 1e-3:
            raise ValueError("not a .flo file")
        W = int(np.fromfile(f, np.int32, 1)[0])
        H = int(np.fromfile(f, np.int32, 1)[0])
        data = np.fromfile(f, np.float32, H * W * 2)
    return data.reshape(H, W, 2)


def write_pfm(path: str, image: np.ndarray, scale: float = -1.0) -> bool:
    """Native PFM writer (`image_io.cpp` PFM branch; the Middlebury
    float-disparity format of `examples/io_img_and_disp/main.cpp:54-83`):
    'Pf'/'PF' magic, W H, negative scale = little-endian, rows stored
    bottom-to-top, float32 exact (no quantization)."""
    img = np.asarray(image, np.float32)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    color = img.ndim == 3
    if color and img.shape[-1] != 3:
        raise ValueError("PFM stores 1 or 3 channels")
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{img.shape[1]} {img.shape[0]}\n{scale:g}\n".encode())
        data = img[::-1]                 # bottom-to-top row order
        if abs(scale) not in (0.0, 1.0):
            data = data / np.float32(abs(scale))   # stored = physical/|s|
        if scale > 0:                    # positive scale = big-endian
            data = data.astype(">f4")
        f.write(np.ascontiguousarray(data).tobytes())
    return True


def read_pfm(path: str) -> np.ndarray:
    """Native PFM reader; returns (H, W) or (H, W, 3) float32.  The
    header scale's sign gives the endianness and its magnitude the
    sample unit factor — applied here (files written with |scale| != 1
    come back in physical units; our writer emits -1, a unit factor)."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic not in (b"Pf", b"PF"):
            raise IOError(f"not a PFM file: {magic!r}")
        dims = f.readline().split()
        while dims and dims[0].startswith(b"#"):
            dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        n_ch = 3 if magic == b"PF" else 1
        dt = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(f.read(4 * w * h * n_ch), dt)
    img = data.reshape((h, w, 3) if n_ch == 3 else (h, w))[::-1]
    img = np.ascontiguousarray(img, np.float32)
    if abs(scale) not in (0.0, 1.0):
        img = img * np.float32(abs(scale))
    return img


def read_image(path: str, dtype=None) -> np.ndarray:
    """`IO::readImage` (`image_io.h:171`): ``.stevimg``, ``.pfm``,
    ``.flo`` and ``.exr`` natively, any other extension through
    ``imageio.v3.imread``."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".stevimg":
        img = read_stevimg(path)
    elif ext == ".pfm":
        img = read_pfm(path)
    elif ext == ".flo":
        img = read_flo(path)
    elif ext == ".exr":
        from .exr_io import read_exr
        planes = read_exr(path)
        if len(planes) == 1:
            img = next(iter(planes.values()))
        else:
            # RGB(A)-style channel order when present, else alphabetical
            order = [c for c in ("R", "G", "B", "A", "Y") if c in planes]
            order += [c for c in sorted(planes) if c not in order]
            img = np.stack([planes[c] for c in order], -1)
    else:
        import imageio.v3 as iio
        img = iio.imread(path)
    return img if dtype is None else img.astype(dtype)


def write_image(path: str, image: np.ndarray) -> bool:
    """`IO::writeImage` (`image_io.h:177`): ``.stevimg``, ``.pfm``,
    ``.flo`` and ``.exr`` natively, any other extension through
    ``imageio.v3.imwrite``, float images scaled by 255 and clipped to
    uint8 for ``.png``, ``.jpg``, ``.jpeg`` and ``.bmp``."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".stevimg":
        return write_stevimg(path, image)
    if ext == ".pfm":
        return write_pfm(path, image)
    if ext == ".flo":
        return write_flo(path, image)
    if ext == ".exr":
        from .exr_io import write_exr
        img = np.asarray(image, np.float32)
        if img.ndim == 2:
            return write_exr(path, {"Y": img})
        names = ["R", "G", "B", "A"][:img.shape[-1]]
        return write_exr(path, {n: img[..., i] for i, n in enumerate(names)})
    import imageio.v3 as iio
    img = image
    if img.dtype in (np.float32, np.float64) and ext in (".png", ".jpg",
                                                         ".jpeg", ".bmp"):
        img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    iio.imwrite(path, img)
    return True
