"""slr.kernels — hand-written Pallas kernels for the per-pixel hot path.

The reference's C++ hot loops (SURVEY.md components 4-8, 12: decode
loops, unwrap loops, per-point triangulation) become one fused kernel
here — the "native tier" of the build [B:5]. It reads each pixel's frame
stack once and writes the final per-pixel products, instead of one pass
per stage.

The kernels name the Triton route and compile on the GPU; on the CPU
they run in Pallas interpret mode (slr.kernels.common.use_interpret).
Parity against the pure-JAX reference paths in slr.codec / slr.geom is
asserted in tests/test_kernels.py.
"""

from slr.kernels.common import use_interpret
from slr.kernels.fused_scan import (
    fused_decode_triangulate, fused_decode_triangulate_hdr,
)
