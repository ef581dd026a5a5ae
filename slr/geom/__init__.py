"""slr.geom — SE(3) algebra, pinhole+distortion camera model, triangulation.

The JAX substrate replacing the reference's OpenCV/Eigen layer
(SURVEY.md L2) and its ``VirtualCamera``-style ray model (component 21).
Everything is pure JAX, batched-first, f32.
"""

from slr.geom.se3 import (
    so3_exp,
    so3_log,
    se3_exp,
    se3_log,
    se3_compose,
    se3_inverse,
    se3_apply,
    se3_identity,
)
from slr.geom.camera import (
    Camera,
    project,
    distort,
    undistort_iterative,
    pixel_to_ray,
    make_camera,
)
from slr.geom.triangulate import (
    triangulate_midpoint,
    triangulate_plane,
    triangulate_rays,
    triangulate_dlt,
)
