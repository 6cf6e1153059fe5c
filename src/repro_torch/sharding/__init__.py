from repro_torch.sharding.rules import (
    Mesh,
    P,
    batch_specs,
    cache_specs,
    make_mesh,
    param_specs,
    resolve_axes,
)

__all__ = ["Mesh", "P", "batch_specs", "cache_specs", "make_mesh", "param_specs",
           "resolve_axes"]
