"""The census cost volume as two CUDA kernels (`csrc/census_cv.cu`).

`census_words` launches the words kernel once for both images: the census
words of every pixel's (2v+1) x (2h+1) window (row-major over (dy, dx),
zeros outside the image), bit b of word w being sample 0 > sample
1 + 32 w + b with sample 0 the window's first sample, a trailing partial
word's unused bits 0 (`correlation/census.h:70-131`, `ops/census.py`).
`census_cv` then launches the volume kernel once, for any D: the (H, W, D)
Hamming volume, RIGHT_TO_LEFT (the right image the source, the left one
sampled at j + d), the target words 0 where j + d >= W.  It is the volume
`unfold_based_cost_volume(CENSUS, ...)` builds on the unfold route, which
runs one xor and popcount a disparity as torch ops, and which is
`census_cv_plain`.

The costs are integers, so the kernels and their plain versions
(`census_words_plain`, `census_cv_plain`) agree bit for bit in any order of
operations.  Each wrapper launches its kernel for CUDA tensors, counting
launches in ``launches.<wrapper>`` (`utils.profiling.counters`), and runs
its plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from .. import _build
from ..core.types import MatchingFunction
from ..utils.profiling import count
from .census import census_transform_2d
from .cost_volume import unfold_based_cost_volume

WORD_BITS = 32


def n_words(h_radius: int, v_radius: int) -> int:
    """Census words a pixel: ceil(((2h+1)(2v+1) - 1) / 32)."""
    n_bits = (2 * h_radius + 1) * (2 * v_radius + 1) - 1
    if n_bits < 1:
        raise ValueError("census: the window needs more than one sample")
    return (n_bits + WORD_BITS - 1) // WORD_BITS


def census_words_plain(img_l: torch.Tensor, img_r: torch.Tensor,
                       h_radius: int, v_radius: int) -> torch.Tensor:
    """The plain version of the words kernel: (2, n_words, H, W) int64
    (uint32 values), [0] the source (right) image's words, [1] the target
    (left) one's: `census_transform_2d` of the float32 images."""
    return torch.stack([census_transform_2d(img.float(), h_radius, v_radius)
                        .permute(2, 0, 1) for img in (img_r, img_l)])


def census_cv_plain(img_l: torch.Tensor, img_r: torch.Tensor,
                    h_radius: int, v_radius: int, disp_width: int,
                    cv_dtype=torch.float32) -> torch.Tensor:
    """The plain version of the census volume: the unfold route of
    `unfold_based_cost_volume(CENSUS, ...)` on the float32 images, rounded
    once to ``cv_dtype``."""
    return unfold_based_cost_volume(
        MatchingFunction.CENSUS, img_l.float(), img_r.float(), h_radius,
        v_radius, int(disp_width), backend="unfold").to(cv_dtype)


def _check(img_l, img_r, h_radius, v_radius):
    if not (img_l.is_cuda and img_r.device == img_l.device):
        raise ValueError("census_cv: both images on one CUDA device")
    if img_l.ndim != 2 or img_r.shape != img_l.shape:
        raise ValueError("census_cv: two gray (H, W) images of one shape")
    if h_radius < 0 or v_radius < 0:
        raise ValueError("census_cv: negative window radius")


def _words_launch(lib, img_l, img_r, h_radius, v_radius, stream):
    """The words kernel on CUDA images: (2, n_words, H, W) int32 holding
    the uint32 words' bits."""
    src = img_r.float().contiguous()
    tgt = img_l.float().contiguous()
    H, W = src.shape
    nw = n_words(h_radius, v_radius)
    words = torch.empty((2, nw, H, W), dtype=torch.int32, device=src.device)
    err = lib.census_words_launch(src.data_ptr(), tgt.data_ptr(),
                                  words.data_ptr(), H, W, h_radius, v_radius,
                                  nw, stream)
    _build.check(lib, err, "census_words_launch")
    count("launches.census_words")
    return words


def census_words(img_l: torch.Tensor, img_r: torch.Tensor, h_radius: int,
                 v_radius: int) -> torch.Tensor:
    """`census_words_plain`'s words; on CUDA from one launch of the words
    kernel for both images, as int32 holding the uint32 bits (compare
    ``words.long() & 0xFFFFFFFF`` with the plain version's values)."""
    if img_l.device.type == "cpu":
        return census_words_plain(img_l, img_r, h_radius, v_radius)
    _check(img_l, img_r, h_radius, v_radius)
    lib = _build.load("census_cv")
    with torch.cuda.device(img_l.device):
        return _words_launch(lib, img_l, img_r, h_radius, v_radius,
                             torch.cuda.current_stream().cuda_stream)


def census_cv(img_l: torch.Tensor, img_r: torch.Tensor, h_radius: int,
              v_radius: int, disp_width: int, cv_dtype=torch.float32,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """(H, W, D) census cost volume of a gray pair, RIGHT_TO_LEFT over d in
    [0, D), stored as ``cv_dtype`` (float32 or bfloat16), into ``out`` if
    given (contiguous, of that shape and dtype, on the images' device).  On
    CUDA, one launch of the words kernel (`census_words`) and one of the
    volume kernel, for any D."""
    D = int(disp_width)
    if out is not None:
        shape = tuple(img_l.shape) + (D,)
        if (tuple(out.shape) != shape or out.dtype != cv_dtype
                or out.device != img_l.device or not out.is_contiguous()):
            raise ValueError(f"census_cv: out must be contiguous {cv_dtype} "
                             f"of shape {shape} on the images' device")
    if img_l.device.type == "cpu":
        cv = census_cv_plain(img_l, img_r, h_radius, v_radius, D, cv_dtype)
        return cv if out is None else out.copy_(cv)
    _check(img_l, img_r, h_radius, v_radius)
    if cv_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("census_cv stores float32 or bfloat16 volumes")
    if D < 1:
        raise ValueError("census_cv: D >= 1")
    H, W = img_l.shape
    if out is None:
        out = torch.empty((H, W, D), dtype=cv_dtype, device=img_l.device)
    lib = _build.load("census_cv")
    with torch.cuda.device(img_l.device):
        stream = torch.cuda.current_stream().cuda_stream
        words = _words_launch(lib, img_l, img_r, h_radius, v_radius, stream)
        err = lib.census_cv_launch(words.data_ptr(), out.data_ptr(), H, W, D,
                                   words.shape[1],
                                   int(cv_dtype == torch.bfloat16), stream)
    _build.check(lib, err, "census_cv_launch")
    count("launches.census_cv")
    return out
