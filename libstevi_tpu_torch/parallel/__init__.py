"""The distributed stereo pipelines (counterpart of `libstevi_tpu/parallel/`):
a (batch, tile, dsh) mesh of torch devices driven by one controller, halo
exchange, the SGM carry relay (kernels K2s and K4c), the pipeline steps,
and `schur` (distributed Gauss-Newton over one mesh axis, the partial
normal equations summed in shard order, and the Schur-complement solve of
a pose + structure system)."""

from .mesh import make_stereo_mesh, MeshSpec
from .halo import halo_exchange_rows
from .stereo import (
    distributed_cost_volume_wta,
    distributed_dense_stereo_step,
    dshard_wta,
)
from .sgm_dist import distributed_sgm, distributed_sgm_fused
from .schur import (distributed_gauss_newton, distributed_multiview_alignment,
                    schur_complement_solve)

__all__ = [
    "make_stereo_mesh", "MeshSpec",
    "halo_exchange_rows",
    "distributed_cost_volume_wta", "distributed_dense_stereo_step",
    "dshard_wta", "distributed_sgm", "distributed_sgm_fused",
    "distributed_gauss_newton", "distributed_multiview_alignment",
    "schur_complement_solve",
]
