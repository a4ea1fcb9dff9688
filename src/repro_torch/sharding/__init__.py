"""Placement rules (``specs``, the reference's) and their application to a
``DeviceMesh`` (``placement``)."""
from repro_torch.sharding.specs import (
    batch_spec,
    cache_specs,
    mesh_info_from_mesh,
    opt_state_specs,
    param_specs,
    state_specs,
)

__all__ = ["param_specs", "opt_state_specs", "state_specs", "batch_spec",
           "cache_specs", "mesh_info_from_mesh"]
