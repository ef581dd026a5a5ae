"""slr.registration — multi-scan alignment (SURVEY.md components 14-16).

Coarse: FPFH-style device-side descriptors + vectorized RANSAC rigid fit.
Fine: point-to-plane ICP whose correspondence search is a tiled
brute-force nearest-neighbour pass formulated as matmuls (the
replacement for the reference's KD-tree: a matrix product computes the
|s|^2+|t|^2-2s.t distance expansion, SURVEY.md section 9 "NN search for
ICP without KD-trees" — with the voxel-hash variant in
slr.registration.voxel for large clouds).
Pose graph: Gauss-Newton over SE(3) with relative-pose residuals
(component 16); the distributed Schur BA lives in slr.dist.ba.
"""

from slr.registration.nn import nearest_neighbors
from slr.registration.normals import grid_normals
from slr.registration.icp import icp_point_to_plane, ICPResult
from slr.registration.features import fpfh_features, ransac_align
from slr.registration.posegraph import pose_graph_optimize
from slr.registration.voxel import voxel_downsample, build_voxel_hash, voxel_hash_nn
from slr.registration.projective import icp_projective
from slr.registration.filters import (
    knn_mean_distance, statistical_outlier_removal, radius_outlier_removal,
)
