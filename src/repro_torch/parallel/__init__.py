from .sharding import (
    P,
    batch_specs,
    data_axes,
    fsdp_gather_layer,
    gather_tree,
    gnn_specs,
    lm_cache_spec,
    lm_param_specs,
    opt_state_specs,
    recsys_param_specs,
    sanitize_specs,
    shard_tree,
)

__all__ = [
    "P",
    "batch_specs",
    "data_axes",
    "fsdp_gather_layer",
    "gather_tree",
    "gnn_specs",
    "lm_cache_spec",
    "lm_param_specs",
    "opt_state_specs",
    "recsys_param_specs",
    "sanitize_specs",
    "shard_tree",
]
