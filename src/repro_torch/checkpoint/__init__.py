from .checkpoint import (
    CheckpointManager,
    append_durable,
    fsync_json,
    latest_numbered,
    latest_step,
    replace_dir,
    restore_checkpoint,
    retain_latest,
    save_checkpoint,
)

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "CheckpointManager",
    "fsync_json",
    "append_durable",
    "replace_dir",
    "retain_latest",
    "latest_numbered",
]
