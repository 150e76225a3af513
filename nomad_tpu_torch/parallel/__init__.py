"""Device-mesh parallelism for the placement engine.

Copied from ``nomad_tpu/parallel/__init__.py`` into the PyTorch port."""
from .sharding import (  # noqa: F401
    batched_place_scan,
    batched_scan_shardings,
    make_mesh,
    node_slices,
)
