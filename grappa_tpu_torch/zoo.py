"""Dataset tag resolution, the local part of `grappa_tpu.zoo`.

A tag is an existing path, or the name of a directory under the cache
(`GRAPPA_TPU_CACHE`, else ~/.cache/grappa_tpu) in `datasets/<tag>`. The
port downloads nothing: a tag that is neither raises a RuntimeError that
names it (downloads, the tag lists and model tags are queued, ROADMAP.md).
"""
from __future__ import annotations

import os
from pathlib import Path


def cache_dir() -> Path:
    root = os.environ.get('GRAPPA_TPU_CACHE',
                          str(Path.home() / '.cache' / 'grappa_tpu'))
    return Path(root)


def dataset_path_from_tag(tag: str) -> Path:
    """Resolve a dataset tag or path to a local dataset directory."""
    p = Path(tag)
    if p.exists():
        return p
    target = cache_dir() / 'datasets' / tag
    if target.exists():
        return target
    raise RuntimeError(
        f"dataset {tag!r} is neither a path nor a directory under "
        f"{cache_dir() / 'datasets'}; this package does not download "
        f"datasets: place the dataset directory there or pass its path")
