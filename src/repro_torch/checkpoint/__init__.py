from .checkpoint import (
    append_durable,
    fsync_json,
    latest_numbered,
    replace_dir,
    retain_latest,
)

__all__ = [
    "fsync_json",
    "append_durable",
    "replace_dir",
    "retain_latest",
    "latest_numbered",
]
