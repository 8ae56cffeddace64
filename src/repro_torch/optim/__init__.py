from .optimizer import AdamWConfig, adamw_init, adamw_update, cast_like, cosine_schedule, global_norm

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cast_like", "cosine_schedule", "global_norm"]
