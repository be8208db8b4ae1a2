"""Device mesh of the distributed stereo pipelines (counterpart of
`libstevi_tpu/parallel/mesh.py`).

The mesh has the JAX package's three logical axes:

  * ``batch`` — data parallelism over stereo pairs (no communication);
  * ``tile``  — image rows (halo exchange for window margins, carry relays
    for the SGM scanlines);
  * ``dsh``   — the disparity axis of the cost volume (the WTA or the SGM
    input reassembles it).

JAX's `shard_map` is single-controller: one program drives every shard.
The port keeps that model: the mesh is an array of `torch.device`s, and
one Python controller loops over the per-shard tensors (`parallel.stereo`,
`parallel.sgm_dist`).  A device may appear more than once, so a mesh of
eight "virtual" shards fits on one card (``[torch.device("cuda:0")] * 8``)
or on the CPU (``["cpu"] * 8``), as the JAX package checks its sharded
paths on eight virtual CPU devices.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

AXES = ("batch", "tile", "dsh")


@dataclass(frozen=True)
class MeshSpec:
    batch: int = 1
    tile: int = 1
    dsh: int = 1

    @property
    def n_devices(self) -> int:
        return self.batch * self.tile * self.dsh


class StereoMesh:
    """A (batch, tile, dsh) array of `torch.device`s.  ``shape`` maps each
    axis name to its size, as `jax.sharding.Mesh.shape` does."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 3:
            raise ValueError("a stereo mesh is a (batch, tile, dsh) array")
        self.devices = devices

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, self.devices.shape))

    def tile_devices(self, b: int = 0, s: int = 0) -> list:
        """The devices of one row of the ``tile`` axis."""
        return list(self.devices[b, :, s])


def make_stereo_mesh(spec: MeshSpec, devices=None) -> StereoMesh:
    """The mesh of ``spec`` over the first ``spec.n_devices`` entries of
    ``devices`` (default: the visible CUDA devices; never the CPU).  A list
    may repeat a device.  Raises ValueError when there are too few."""
    if devices is None:
        devices = [torch.device("cuda", k)
                   for k in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if len(devices) < spec.n_devices:
        raise ValueError(
            f"mesh needs {spec.n_devices} devices, have {len(devices)}")
    arr = np.empty(spec.n_devices, dtype=object)
    arr[:] = devices[:spec.n_devices]
    return StereoMesh(arr.reshape(spec.batch, spec.tile, spec.dsh))
