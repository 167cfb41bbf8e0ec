from .pyramid import gaussian_blur, build_pyramid, pyramid_shapes
from .fast import fast_score, nms3x3, select_topk_grid
from .patch import extract_patches
from .fast_nms import fast_nms_score
from .orb import extract_orb, OrbFeatures, OrbParams
from .match import (
    hamming_matrix,
    hamming_matrix_mxu,
    match_mutual_nn,
    match_projected,
    orientation_consistency,
)
from .remap import remap_bilinear
