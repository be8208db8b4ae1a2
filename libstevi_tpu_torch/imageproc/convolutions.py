"""Generic convolution engine (counterpart of
`libstevi_tpu/imageproc/convolutions.py`).

Reference parity: `imageProcessing/convolutions.h:32-560` — `Filter<T,
Ds...>` with per-axis roles, strides, and Constant / Periodic / Mirror
padding:

  * Moving      — the filter slides along this axis (present in input,
                  filter and output; output size =
                  in - k + 1 + pre + post);
  * Aggregate   — summed away (present in input and filter; input extent
                  must equal the filter extent; absent from the output);
  * BatchedInput  — batched through unchanged (absent from the filter);
  * BatchedOutput — a filter-bank axis (absent from the input; output
                  extent = filter extent).

An axis list fully defines the correspondence between input, filter and
output shapes (`correspondanceForExcludedAxisType`, :199-254): the input
sees every axis except BatchedOutput, the filter every axis except
BatchedInput, the output every axis except Aggregate.  The operation is
correlation (no kernel flip).

The roles merge as in the JAX package: the Moving axes are the spatial
axes, the (merged) Aggregate axes the contracted channel axis, the
(merged) BatchedInput axes the batch and the (merged) BatchedOutput axes
the filter bank.  The correlation itself is a shifted-product sum, for
any number of Moving axes: one strided slice of the padded input a filter
offset, multiplied by that offset's coefficients and added in offset
order (the channel contraction a broadcast product summed over the
channel axis).  No cuDNN convolution and no matmul, so nothing is rounded
to TF32 on a GPU: the sums are plain float32, and a single-channel filter
gives the same bits on the CPU and on the card.

Padding is an index map per Moving axis (modular for Periodic, reflected
for Mirror, as `jnp.pad`'s ``wrap`` / ``reflect``, for pads of any width)
gathered with `index_select`; Constant pads with zeros.

Deviation (the JAX package's): the reference's `MovingWindowAxis` stride
is stored but never applied in its convolve loop (:86-109 vs :405-470 —
dead code); here a stride of s keeps every (s+1)-th window position.
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass

import numpy as np
import torch


class AxisType(enum.Enum):
    MOVING = 0          # the filter slides along this axis
    AGGREGATE = 1       # summed away (input channels)
    BATCHED_INPUT = 2   # batched on the input only (depthwise)
    BATCHED_OUTPUT = 3  # batched on the output only (filter bank axis)


class PaddingType(enum.Enum):
    CONSTANT = 0
    PERIODIC = 1
    MIRROR = 2


@dataclass(frozen=True)
class PaddingInfos:
    pre: int = 0
    post: int | None = None
    mode: PaddingType = PaddingType.CONSTANT

    @property
    def post_val(self) -> int:
        return self.pre if self.post is None else self.post


@dataclass(frozen=True)
class MovingWindowAxis:
    """`MovingWindowAxis` (:79-110)."""
    padding: PaddingInfos = PaddingInfos()
    stride: int = 0

    axis_type = AxisType.MOVING


@dataclass(frozen=True)
class AggregateWindowsAxis:
    axis_type = AxisType.AGGREGATE


@dataclass(frozen=True)
class BatchedInputAxis:
    axis_type = AxisType.BATCHED_INPUT


@dataclass(frozen=True)
class BatchedOutputAxis:
    axis_type = AxisType.BATCHED_OUTPUT


def pad_axis(x: torch.Tensor, axis: int, pre: int, post: int,
             mode: PaddingType) -> torch.Tensor:
    """``x`` padded by ``pre`` / ``post`` along ``axis``: zeros (Constant),
    ``jnp.pad``'s ``wrap`` (Periodic) or ``reflect`` (Mirror, the edge not
    repeated), at any width."""
    if pre == 0 and post == 0:
        return x
    n = x.shape[axis]
    if mode is PaddingType.CONSTANT:
        shape = list(x.shape)
        parts = []
        for w in (pre, post):
            shape[axis] = w
            parts.append(x.new_zeros(shape))
        return torch.cat([parts[0], x, parts[1]], axis)
    i = torch.arange(-pre, n + post, device=x.device)
    if mode is PaddingType.PERIODIC:
        i = i % n
    elif n == 1:
        i = torch.zeros_like(i)
    else:
        period = 2 * (n - 1)
        i = i % period
        i = torch.where(i >= n, period - i, i)
    return x.index_select(axis, i)


def _correlate(xs: torch.Tensor, ks: torch.Tensor, strides) -> torch.Tensor:
    """VALID strided correlation of xs (N, spatial..., C) with ks
    (kspatial..., C, O) -> (N, out..., O), a shifted-product sum."""
    nsp = ks.ndim - 2
    ksp = ks.shape[:nsp]
    out_sp = [-(-(xs.shape[1 + a] - ksp[a] + 1) // strides[a])
              for a in range(nsp)]
    out = None
    for off in itertools.product(*(range(k) for k in ksp)):
        sl = tuple(slice(o, o + s * (n - 1) + 1, s)
                   for o, s, n in zip(off, strides, out_sp))
        win = xs[(slice(None),) + sl]                 # (N, out..., C)
        term = (win[..., None] * ks[off]).sum(-2)     # (N, out..., O)
        out = term if out is None else out + term
    return out


class FilterND:
    """Reference-style N-d filter (`Filter<T, Ds...>`,
    `convolutions.h:169`): construct with an n-filter-axis coefficient
    array and one axis-role descriptor per logical dimension."""

    def __init__(self, coefficients, *axes):
        self.axes = tuple(axes)
        self.types = [a.axis_type for a in axes]
        self.coefficients = torch.as_tensor(coefficients,
                                            dtype=torch.float32)
        # correspondence tables (:199-254)
        self.in_axes = [i for i, t in enumerate(self.types)
                        if t is not AxisType.BATCHED_OUTPUT]
        self.filt_axes = [i for i, t in enumerate(self.types)
                          if t is not AxisType.BATCHED_INPUT]
        self.out_axes = [i for i, t in enumerate(self.types)
                         if t is not AxisType.AGGREGATE]
        if self.coefficients.ndim != len(self.filt_axes):
            raise ValueError("coefficient rank does not match the "
                             "non-BatchedInput axis count")

    def _role(self, kind):
        return [i for i, t in enumerate(self.types) if t is kind]

    def output_shape(self, input_shape):
        """`outputShape` (:305-338)."""
        in_of = {d: i for i, d in enumerate(self.in_axes)}
        f_of = {d: i for i, d in enumerate(self.filt_axes)}
        out = []
        for d in self.out_axes:
            t = self.types[d]
            if t is AxisType.MOVING:
                p = self.axes[d].padding
                full = (input_shape[in_of[d]]
                        - self.coefficients.shape[f_of[d]] + 1
                        + p.pre + p.post_val)
                out.append(-(-full // (self.axes[d].stride + 1)))
            elif t is AxisType.BATCHED_INPUT:
                out.append(input_shape[in_of[d]])
            else:                        # BatchedOutput
                out.append(self.coefficients.shape[f_of[d]])
        return tuple(out)

    def convolve(self, input_arr: torch.Tensor) -> torch.Tensor:
        x = input_arr.float()
        if x.ndim != len(self.in_axes):
            raise ValueError("input rank does not match the "
                             "non-BatchedOutput axis count")
        in_of = {d: i for i, d in enumerate(self.in_axes)}
        f_of = {d: i for i, d in enumerate(self.filt_axes)}

        moving = self._role(AxisType.MOVING)
        agg = self._role(AxisType.AGGREGATE)
        b_in = self._role(AxisType.BATCHED_INPUT)
        b_out = self._role(AxisType.BATCHED_OUTPUT)

        for d in agg:
            if x.shape[in_of[d]] != self.coefficients.shape[f_of[d]]:
                raise ValueError("aggregate axis extent mismatch")

        for d in moving:
            p = self.axes[d].padding
            x = pad_axis(x, in_of[d], p.pre, p.post_val, p.mode)

        # input -> (N, spatial..., C): batch = merged BatchedInput,
        # C = merged Aggregate
        perm = ([in_of[d] for d in b_in] + [in_of[d] for d in moving]
                + [in_of[d] for d in agg])
        x = x.permute(perm)
        nb = int(np.prod(x.shape[:len(b_in)]))
        spatial = tuple(x.shape[len(b_in):len(b_in) + len(moving)])
        nc = int(np.prod(x.shape[len(b_in) + len(moving):]))
        xs = x.reshape((nb,) + spatial + (nc,))

        # filter -> (spatial..., I, O)
        k = self.coefficients.to(x.device)
        kperm = ([f_of[d] for d in moving] + [f_of[d] for d in agg]
                 + [f_of[d] for d in b_out])
        k = k.permute(kperm)
        kspatial = tuple(k.shape[:len(moving)])
        no = int(np.prod(k.shape[len(moving) + len(agg):]))
        ks = k.reshape(kspatial + (nc, no))

        strides = [self.axes[d].stride + 1 for d in moving]
        out = _correlate(xs, ks, strides)
        out_sp = list(out.shape[1:1 + len(moving)])

        # unmerge batch / bank axes and restore the output axis order
        b_in_shape = [input_arr.shape[in_of[d]] for d in b_in]
        b_out_shape = [self.coefficients.shape[f_of[d]] for d in b_out]
        out = out.reshape(tuple(b_in_shape) + tuple(out_sp)
                          + tuple(b_out_shape))
        # current order: b_in..., moving..., b_out...; target: out_axes
        cur = [*b_in, *moving, *b_out]
        return out.permute([cur.index(d) for d in self.out_axes])


def convolve_2d(img: torch.Tensor, kernel,
                paddings=(PaddingInfos(), PaddingInfos()),
                strides=(1, 1)) -> torch.Tensor:
    """Correlation with role-driven channel handling (the common 2-D
    cases of `FilterND`, kept as a direct path):

      * (H, W) image, (kh, kw) kernel          -> (H', W')
      * (H, W, C) image, (kh, kw) kernel       -> (H', W', C)  [depthwise]
      * (H, W, C) image, (kh, kw, C) kernel    -> (H', W')     [aggregate]
    """
    chan = img.ndim == 3
    x = img.float()
    if not chan:
        x = x[..., None]
    k = torch.as_tensor(kernel, dtype=torch.float32, device=x.device)
    for axis, p in enumerate(paddings):
        x = pad_axis(x, axis, p.pre, p.post_val, p.mode)
    if k.ndim == 3:
        # aggregate: the channels contract against k's third axis
        return _correlate(x[None], k[..., None], strides)[0, ..., 0]
    # depthwise: the channels ride as the batch
    out = _correlate(x.permute(2, 0, 1)[..., None], k[..., None, None],
                     strides)[..., 0].permute(1, 2, 0)
    return out if chan else out[..., 0]


@dataclass
class Filter:
    """2-D reference-style filter object (`Filter<T, Ds...>`,
    `convolutions.h:169`) — the Moving x Moving [+ channel role] special
    case; arbitrary role combinations use `FilterND`."""

    coefficients: torch.Tensor
    paddings: tuple = (PaddingInfos(), PaddingInfos())
    strides: tuple = (1, 1)

    def convolve(self, img: torch.Tensor) -> torch.Tensor:
        return convolve_2d(img, self.coefficients, self.paddings,
                           self.strides)
