"""slr.dist — device mesh, collectives, sharded pipeline, distributed BA.

SURVEY.md section 3.2: the reference has no distributed layer at all; this
package is the build's first-class parallelism tier. Mesh axes:

- ``pixel_tile``: shards the camera-image H axis (the context/sequence-
  parallel analog for this workload); halo exchange via ppermute feeds the
  spatially-coupled quality-guided unwrap.
- ``map_block``: shards scans/fragments across hosts for registration and
  bundle adjustment; only the reduced Schur pose system crosses blocks
  (psum), structure stays block-local [B:5].

Collectives are XLA's (psum / all_gather / ppermute), which XLA hands
to NCCL on GPUs. Multi-host bring-up goes
through jax.distributed.initialize (slr.dist.mesh.init_distributed).
"""

from slr.dist.mesh import make_mesh, init_distributed
from slr.dist.halo import halo_exchange_rows
from slr.dist.sharded import sharded_reconstruct, sharded_unwrap
from slr.dist.ba import distributed_bundle_adjust, bundle_adjust_reference
from slr.dist.batch import batched_reconstruct
from slr.dist.recovery import resume_ba, reshard_fragments
