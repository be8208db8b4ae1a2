""".stevimg image IO in numpy (the `read_stevimg`/`write_stevimg` part of
`libstevi_tpu/io/image_io.py`), and `read_image`/`write_image`, which
dispatch on the extension as the JAX package's do.  Only ``.stevimg`` is
ported; other formats raise ValueError (the card's machine has no
imageio).

Reference parity: `io/image_io.h:49-160` — a text header line ``<dtype>
<ndim> <shape...> <strides...>`` with dtype descriptors like ``f32``/``u8``
followed by raw row-major data.
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


def _ext(path: str) -> str:
    ext = os.path.splitext(path)[1].lower()
    if ext != ".stevimg":
        raise ValueError(f"{path}: only .stevimg images are ported "
                         "(ROADMAP.md A11)")
    return ext


def read_image(path: str, dtype=None) -> np.ndarray:
    """`IO::readImage` (`image_io.h:171`) for ``.stevimg`` files."""
    _ext(path)
    img = read_stevimg(path)
    return img if dtype is None else img.astype(dtype)


def write_image(path: str, image: np.ndarray) -> bool:
    """`IO::writeImage` (`image_io.h:177`) for ``.stevimg`` files."""
    _ext(path)
    return write_stevimg(path, image)
