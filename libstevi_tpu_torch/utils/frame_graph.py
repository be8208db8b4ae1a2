"""A frame of a stereo entry replayed as one CUDA graph per input geometry.

`FrameGraphs(forward, buffers)` wraps a pair entry ``forward(img_l, img_r,
**buffers) -> disparity``.  CPU inputs run ``forward`` eagerly, every
call.  On CUDA, by the geometry of the pair (`frame_key`: each image's
device, shape, dtype and strides):

- the first call runs ``forward`` eagerly, as an unwrapped entry does: it
  builds the kernels and makes the route's run-time choices;
- the second allocates the static inputs and ``buffers(img_l, img_r)``
  (the large tensors the frame writes: they stay allocated, so the
  allocator's peak still counts them), runs the frame once on a side
  stream into them (the warm-up PyTorch asks for before a capture; its
  answer is this call's), then captures the frame into a `CUDAGraph`;
- every later call copies the pair into the static inputs, replays the
  graph and returns a clone of the static disparity, so results held at
  once never alias.  Everything runs in the caller's stream order: the
  replays of a geometry share its static inputs, so one `FrameGraphs`
  serves one stream at a time.

At most `KEYS` geometries are held (those seen once among them), least
recently used first out; an evicted frame's graph and buffers are freed.

Counters (`utils.profiling`): the counts the capture made (``launches.*``,
``route.*``, ``form.*``) are taken back, since nothing ran, and added again
on every replay with ``graph.replay``; a capture counts ``graph.capture``.
A replayed frame draws the spans ``stevi.dense_sgm_stereo`` and, inside
it, ``stevi.route`` (the geometry's lookup); the stage spans are entered
only when the frame runs eagerly.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from .profiling import count, counters, span

KEYS = 2  # geometries held at once


def frame_key(*images: torch.Tensor) -> tuple:
    """What a captured frame is bound to: each image's device, shape,
    dtype and strides."""
    return tuple((t.device, tuple(t.shape), t.dtype, t.stride())
                 for t in images)


class _Frame:
    """One captured frame: its graph, static inputs and output, the
    buffers its kernels write, and the counts of one run of it."""

    def __init__(self, forward, inputs, buffers, stream):
        """Capture ``forward(*inputs, **buffers)`` on ``stream``; the
        counts it makes are taken back (nothing ran)."""
        # held: the graph's kernels read and write them at every replay
        self.inputs, self.buffers = inputs, buffers
        before = counters()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream):
            self.output = forward(*inputs, **buffers)
        after = counters()
        self.counts = [(k, after[k] - before[k]) for k in after
                       if after[k] != before[k] and not k.startswith("span")]
        for k, n in self.counts:
            count(k, -n)
        count("graph.capture")

    def replay(self, img_l, img_r) -> torch.Tensor:
        for s, t in zip(self.inputs, (img_l, img_r)):
            s.copy_(t)
        self.graph.replay()
        for k, n in self.counts:
            count(k, n)
        count("graph.replay")
        return self.output.clone()

    def release(self) -> None:
        """Free the graph's pool once the replays queued on the device
        are done; the buffers go with the last reference."""
        torch.cuda.synchronize(self.output.device)
        self.graph.reset()


class FrameGraphs:
    """``forward`` on a gray pair, replayed from a CUDA graph per input
    geometry from that geometry's third call on (see the module)."""

    def __init__(self, forward, buffers):
        self.forward = forward
        self.buffers = buffers
        # geometry -> its `_Frame`, or None after its first (eager) call
        self._frames: OrderedDict = OrderedDict()

    def __call__(self, img_l: torch.Tensor,
                 img_r: torch.Tensor) -> torch.Tensor:
        if img_l.device.type != "cuda":
            return self.forward(img_l, img_r)
        key = frame_key(img_l, img_r)
        frame = self._frames.get(key)
        if frame is not None:
            with span("stevi.dense_sgm_stereo"):
                with span("stevi.route"):
                    self._frames.move_to_end(key)
                return frame.replay(img_l, img_r)
        if key not in self._frames:
            self._frames[key] = None
            self._evict()
            return self.forward(img_l, img_r)
        with torch.cuda.device(img_l.device):
            return self._capture(key, img_l, img_r)

    def _capture(self, key, img_l, img_r) -> torch.Tensor:
        """The geometry's second call: its frame run on a side stream into
        the static inputs and buffers (this call's answer), then captured
        there."""
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        inputs = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in (img_l, img_r)]
        buffers = self.buffers(img_l, img_r)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for s, t in zip(inputs, (img_l, img_r)):
                s.copy_(t)
            answer = self.forward(*inputs, **buffers)
        main.wait_stream(side)
        answer.record_stream(main)  # allocated on the side stream
        self._frames[key] = _Frame(self.forward, inputs, buffers, side)
        self._frames.move_to_end(key)
        return answer

    def _evict(self) -> None:
        while len(self._frames) > KEYS:
            _, frame = self._frames.popitem(last=False)
            if frame is not None:
                frame.release()

    def clear(self) -> None:
        """Drop every geometry, freeing the captured frames."""
        while self._frames:
            _, frame = self._frames.popitem()
            if frame is not None:
                frame.release()
