from rescan_line_sted_tpu.parallel.mesh import (  # noqa: F401
    make_mesh,
    batch_sharding,
    replicated_sharding,
    shard_batch,
    replicate,
)
from rescan_line_sted_tpu.parallel.multihost import (  # noqa: F401
    initialize_multihost,
    is_initialized,
    local_device_slice,
)
