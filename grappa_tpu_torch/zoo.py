"""Model and dataset zoo: tag resolution and downloads.

Counterpart of `grappa_tpu.zoo` (reference: src/grappa/utils/
loading_utils.py:18-32 model tags, src/grappa/utils/dataset_utils.py:15-78
dataset tags). A tag is an existing path, or a name resolved in the cache
(`GRAPPA_TPU_CACHE`, else ~/.cache/grappa_tpu): `models/<file>` for model
tags, `datasets/<tag>` (a directory, else `<tag>.zip` extracted there) for
dataset tags. Only a file the cache lacks is downloaded from the release;
without a network, place the files in the cache or pass their paths.
"""
from __future__ import annotations

import os
import shutil
import zipfile
from pathlib import Path
from typing import Dict

BASE_URL = 'https://github.com/graeter-group/grappa/releases/download'

MODEL_TAGS: Dict[str, str] = {
    'grappa-1.1': f'{BASE_URL}/v.1.1.0/grappa-1.1.pth',
    'grappa-1.2': f'{BASE_URL}/v.1.2.0/grappa-1.2.pth',
    'grappa-1.2.1': f'{BASE_URL}/v.1.2.1/grappa-1.2.1.pth',
    'latest': f'{BASE_URL}/v.1.2.1/grappa-1.2.1.pth',
}

DATASET_TAGS = [
    'spice-des-monomers', 'spice-dipeptide', 'spice-pubchem',
    'gen2', 'gen2-torsion', 'pepconf-dlc', 'protein-torsion',
    'rna-diverse', 'rna-trinucleotide', 'rna-nucleoside',
    'spice-dipeptide-amber99', 'dipeptides-300K-amber99',
    'dipeptides-300K-openff-1.2.0', 'dipeptides-1000K-amber99',
    'uncapped-300K-amber99', 'dipeptides-radical-300K',
    'espaloma_split',
]

DATASET_BASE_URL = f'{BASE_URL}/v.1.2.0'


def cache_dir() -> Path:
    root = os.environ.get('GRAPPA_TPU_CACHE',
                          str(Path.home() / '.cache' / 'grappa_tpu'))
    return Path(root)


def model_path_from_tag(tag: str) -> Path:
    """Resolve a model tag (or a file path) to a local file, downloading it
    into the cache if it is not there."""
    if Path(tag).exists():
        return Path(tag)
    if tag not in MODEL_TAGS:
        raise KeyError(f"unknown model tag {tag!r}; known: "
                       f"{sorted(MODEL_TAGS)} (or pass a file path)")
    url = MODEL_TAGS[tag]
    target = cache_dir() / 'models' / url.rsplit('/', 1)[-1]
    if target.exists():
        return target
    return _download(url, target)


def dataset_path_from_tag(tag: str) -> Path:
    """Resolve a dataset tag (or a directory path) to a local dataset
    directory: the cached directory, else the cached `<tag>.zip` extracted,
    else the release's zip downloaded and extracted (reference semantics:
    dataset_utils.get_path_from_tag)."""
    p = Path(tag)
    if p.exists():
        return p
    target = cache_dir() / 'datasets' / tag
    if target.exists():
        return target
    if tag not in DATASET_TAGS:
        raise KeyError(f"unknown dataset tag {tag!r}; known: {DATASET_TAGS} "
                       f"(or pass a dataset directory path)")
    zip_path = cache_dir() / 'datasets' / f'{tag}.zip'
    if not zip_path.exists():
        _download(f'{DATASET_BASE_URL}/{tag}.zip', zip_path)
    return extract_dataset_zip(zip_path, target)


def extract_dataset_zip(zip_path: Path, target: Path) -> Path:
    """Extract a release dataset archive to `target`. An archive that nests
    everything under one top-level directory is flattened; a corrupt one is
    removed, so that the next resolution downloads it again."""
    tmp = target.with_name(target.name + '.extract')
    if tmp.exists():
        shutil.rmtree(tmp)
    try:
        with zipfile.ZipFile(zip_path) as zf:
            zf.extractall(tmp)
    except zipfile.BadZipFile as exc:
        zip_path.unlink(missing_ok=True)
        raise RuntimeError(
            f"cached dataset archive {zip_path} was corrupt and has been "
            f"removed; retry to re-download it") from exc
    entries = list(tmp.iterdir())
    src = entries[0] if len(entries) == 1 and entries[0].is_dir() else tmp
    target.parent.mkdir(parents=True, exist_ok=True)
    src.rename(target)
    if src != tmp and tmp.exists():
        shutil.rmtree(tmp)
    return target


def _download(url: str, target: Path) -> Path:
    import urllib.request
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(target.suffix + '.part')
    try:
        urllib.request.urlretrieve(url, tmp)  # noqa: S310
    except Exception as exc:
        raise RuntimeError(
            f"could not download {url} (offline environment?); place the "
            f"file at {target} manually") from exc
    tmp.rename(target)
    return target
