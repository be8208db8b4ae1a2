from .filters import box_filter_2d, mean_filter_2d, sigma_filter
from .unfold import (unfold, unfold_offsets, unfold_permutation,
                     unfold_sliding_subwindow_idxs, PatchOrientation)
from .census import census_features, census_transform_2d
from .matching import feature_comparison, compare_feature_volumes
from .box_backend import box_cost_volume, supports_box
from .fv_backend import fused_fv_cost_volume, FUSABLE_KERNELS
from .cost_volume import (normalize_feature_volume, channels_mean,
                          channels_norm, channels_zero_mean_norm,
                          aggregate_cost, feature_volume_to_cost_volume,
                          unfold_based_cost_volume,
                          unfold_based_2d_disparity_cost_volume,
                          extract_selected_index, extract_selected_2d_index,
                          selected_index_to_disp, selected_2d_index_to_disp,
                          selected_cost, truncated_cost_volume,
                          truncated_bidirectional_cost_volume,
                          extract_in_bound_domain)
from .refinement import (InterpolationKernel, IsotropyHypothesis,
                         refine_cost_triplet, refine_disp_cost_interpolation,
                         refine_disp_2d_cost_interpolation,
                         refine_disp_2d_cost_patch_interpolation)
from .sgm import (SgmDirection, directions_for, sgm_cost_volume,
                  sgm_wta_truncated, dense_sgm_stereo)
from .patchmatch import patch_match, patch_match_stereo, patch_match_flow
from .image_refinement import (
    refine_barycentric_disp, refine_barycentric_symmetric_disp,
    refine_barycentric_2d_disp, refine_cost_symmetric_disp,
    refine_subpart_barycentric_disp,
    refine_subpart_barycentric_symmetric_disp,
    refine_subpart_barycentric_2d_disp,
    refine_barycentric_symmetric_2d_disp,
    refine_subpart_barycentric_symmetric_2d_disp,
    refine_arbitrary_interpolation_disp,
    refine_arbitrary_interpolation_2d_disp,
    refined_barycentric_symmetric_disp_fv, refined_barycentric_disp_fv,
    refined_cost_symmetric_disp_fv, refined_barycentric_2d_disp_fv,
    refined_barycentric_symmetric_2d_disp_fv,
    refined_barycentric_symmetric_disp, refined_barycentric_disp,
    refined_cost_symmetric_disp, refined_barycentric_2d_disp,
    refined_barycentric_symmetric_2d_disp)
from .compressor import (UnFoldCompressor, unfold_compressed,
                         grpix17r3_filter, grpix17r4_filter)

__all__ = [
    "box_filter_2d", "mean_filter_2d", "sigma_filter",
    "unfold", "unfold_offsets", "unfold_permutation",
    "unfold_sliding_subwindow_idxs", "PatchOrientation",
    "census_features", "census_transform_2d",
    "feature_comparison", "compare_feature_volumes",
    "box_cost_volume", "supports_box",
    "fused_fv_cost_volume", "FUSABLE_KERNELS",
    "normalize_feature_volume", "channels_mean", "channels_norm",
    "channels_zero_mean_norm", "aggregate_cost",
    "feature_volume_to_cost_volume",
    "unfold_based_cost_volume", "unfold_based_2d_disparity_cost_volume",
    "extract_selected_index", "extract_selected_2d_index",
    "selected_index_to_disp", "selected_2d_index_to_disp", "selected_cost",
    "truncated_cost_volume", "truncated_bidirectional_cost_volume",
    "extract_in_bound_domain",
    "InterpolationKernel", "IsotropyHypothesis", "refine_cost_triplet",
    "refine_disp_cost_interpolation", "refine_disp_2d_cost_interpolation",
    "refine_disp_2d_cost_patch_interpolation",
    "SgmDirection", "directions_for", "sgm_cost_volume",
    "sgm_wta_truncated", "dense_sgm_stereo",
    "patch_match", "patch_match_stereo", "patch_match_flow",
    "refine_barycentric_disp", "refine_barycentric_symmetric_disp",
    "refine_barycentric_2d_disp", "refine_cost_symmetric_disp",
    "refine_subpart_barycentric_disp",
    "refine_subpart_barycentric_symmetric_disp",
    "refine_subpart_barycentric_2d_disp",
    "refine_barycentric_symmetric_2d_disp",
    "refine_subpart_barycentric_symmetric_2d_disp",
    "refine_arbitrary_interpolation_disp",
    "refine_arbitrary_interpolation_2d_disp",
    "refined_barycentric_symmetric_disp_fv", "refined_barycentric_disp_fv",
    "refined_cost_symmetric_disp_fv", "refined_barycentric_2d_disp_fv",
    "refined_barycentric_symmetric_2d_disp_fv",
    "refined_barycentric_symmetric_disp", "refined_barycentric_disp",
    "refined_cost_symmetric_disp", "refined_barycentric_2d_disp",
    "refined_barycentric_symmetric_2d_disp",
    "UnFoldCompressor", "unfold_compressed", "grpix17r3_filter",
    "grpix17r4_filter",
]
