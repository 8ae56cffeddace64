from .grad_compression import compressed_grad_allreduce, compressed_psum, init_error_feedback
from .optimizer import AdamWConfig, adamw_init, adamw_update, cast_like, cosine_schedule, global_norm

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "cast_like",
    "cosine_schedule",
    "global_norm",
    "compressed_grad_allreduce",
    "compressed_psum",
    "init_error_feedback",
]
