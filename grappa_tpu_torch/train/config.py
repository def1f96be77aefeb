"""Training configuration: nested dict with the same four sections and key
names as the JAX package's and the reference's (reference: src/grappa/
training/config.py:30-121), so configs interchange. Keys that are
torch-loader specific (worker counts, pin_memory) are accepted but ignored.

`write_yaml` writes JSON, which is valid YAML: the JAX package's reader
reads it, and writing it needs no yaml module. `read_yaml` reads JSON, and
imports yaml only for a file that is not JSON.
"""
from __future__ import annotations

import json
from typing import Dict

from grappa_tpu_torch.models.grappa_model import get_default_model_config


def default_config() -> Dict:
    data_config = {
        "datasets": [
            "spice-des-monomers", "spice-dipeptide", "spice-pubchem",
            "gen2", "gen2-torsion", "pepconf-dlc", "protein-torsion",
            "rna-diverse",
        ],
        "conf_strategy": 32,
        "val_conf_strategy": 500,
        "train_batch_size": 32,
        "val_batch_size": 32,
        "test_batch_size": 1,
        "seed": 0,
        "splitpath": None,
        "partition": [0.8, 0.1, 0.1],
        "pure_train_datasets": ["rna-nucleoside"],
        "pure_val_datasets": ["rna-trinucleotide"],
        "pure_test_datasets": [],
        "tr_subsampling_factor": None,
        "weights": {
            "rna-diverse": 3.0,
            "rna-nucleoside": 5.0,
            "spice-pubchem": 0.8,
        },
        "balance_factor": 0.0,
    }

    lit_model_config = {
        "lr": 1.5e-5,
        "start_qm_epochs": 2,
        "add_restarts": [],
        "warmup_steps": 500,
        "energy_weight": 1.0,
        "gradient_weight": 0.8,
        "param_weight": 1e-3,
        "proper_regularisation": 1e-3,
        "improper_regularisation": 1e-3,
        "log_train_interval": 5,
        "weight_decay": 0.0,
        "early_stopping_energy_weight": 3.0,
        "patience": 50,
        "lr_decay": 0.8,
        "time_limit": 23.5,
        # wall-clock bound for THIS session only (hours). Unlike time_limit
        # (cumulative across resumes via elapsed_time, reference parity),
        # this bounds a single fit() call — the chip-sharing knob: a bounded
        # run checkpoints, finalizes and frees the chip, and a later resume
        # gets a fresh budget instead of exiting immediately.
        "session_time_limit": None,
        "finish_criterion": {},
        "param_loss_epochs": None,
        "param_weights_by_dataset": {},
    }

    trainer_config = {
        "max_epochs": 10000,
        "gradient_clip_val": 10.0,
        "early_stopping_criterion": "early_stopping_loss",
        "name": None,
        "notes": None,
        "checkpoint_every": 5,
        # the JAX package's dropout PRNG; kept so configs interchange (the
        # port draws its dropout seeds from a torch.Generator)
        "prng_impl": "rbg",
        # each epoch as one loop over the device-resident batch cache with
        # one host fetch of its losses; needs cache_batches
        "scan_epochs": False,
        # stream checkpoint writes on a background thread (device-side
        # snapshot first, skip-if-busy throttling)
        "async_checkpoints": False,
    }

    return {
        "model_config": get_default_model_config(),
        "data_config": data_config,
        "lit_model_config": lit_model_config,
        "trainer_config": trainer_config,
        "test_model": False,
    }


# dict-valued config entries that are DATA (arbitrary keys), not schema —
# replaced wholesale instead of key-validated recursive merge
_LEAF_DICT_KEYS = {'weights', 'finish_criterion', 'param_weights_by_dataset',
                   'in_feat_dims'}


def overwrite_config(updates: Dict, config: Dict) -> Dict:
    """Recursively apply updates; unknown keys raise."""
    for k, v in updates.items():
        if k not in config:
            raise KeyError(f"Key {k} not in config.")
        if (isinstance(v, dict) and isinstance(config[k], dict)
                and k not in _LEAF_DICT_KEYS):
            overwrite_config(v, config[k])
        else:
            config[k] = v
    return config


def validate_config(config: Dict):
    default = default_config()
    unknown = set(config) - set(default)
    if unknown:
        raise KeyError(f"unknown top-level config keys: {sorted(unknown)}")


# Reference-config keys with no counterpart here: torch DataLoader process
# knobs, lightning cosmetics, and legacy aliases. Dropped (with a notice)
# by normalize_reference_config so published reference yamls load verbatim.
_DROPPED_REFERENCE_KEYS = {
    'data_config': {'pin_memory', 'train_loader_workers',
                    'val_loader_workers', 'test_loader_workers'},
    'lit_model_config': {'log_classical', 'log_metrics', 'log_params'},
    'trainer_config': {'profiler'},
    'model_config': {'in_feats', 'in_feat_dims'},
}


def normalize_reference_config(config: Dict, verbose: bool = True) -> Dict:
    """Translate a reference-format grappa_config.yaml dict (reference
    training/config.py:30-121 schema) into a validated config.

    * torch-/lightning-only knobs are dropped (worker counts, pin_memory,
      profiler, log_* flags, the in_feats/in_feat_dims aliases);
    * reference keys with real semantics we do not implement raise loudly
      instead of being silently ignored (currently: tuplewise_weight != 0 —
      every published production config sets it to 0);
    * everything else is strictly key-validated against default_config(),
      so typos in translated configs fail instead of training wrong.
    """
    import copy
    cfg = copy.deepcopy(config)
    for section, keys in _DROPPED_REFERENCE_KEYS.items():
        sec = cfg.get(section)
        if not isinstance(sec, dict):
            continue
        for key in keys:
            if key in sec:
                val = sec.pop(key)
                if verbose and val not in (None, {}, [], 0, False):
                    print(f"normalize_reference_config: dropping "
                          f"{section}.{key}={val!r} (no counterpart)")
    lit = cfg.get('lit_model_config', {})
    if isinstance(lit, dict) and 'tuplewise_weight' in lit:
        tw = lit.pop('tuplewise_weight')
        if tw not in (0, 0.0, None):
            raise NotImplementedError(
                f"tuplewise_weight={tw!r}: the tuplewise-energy loss term "
                f"is not implemented (all published reference production "
                f"configs use 0)")
    base = default_config()
    overwrite_config(cfg, base)
    return base


def write_yaml(config: Dict, path):
    """Write `config` as JSON (a subset of YAML) to `path`."""
    with open(path, 'w') as f:
        json.dump(config, f, indent=1)
        f.write('\n')


def read_yaml(path) -> Dict:
    """Read a config written by `write_yaml` or by any YAML writer."""
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        pass
    try:
        import yaml
    except ImportError:
        raise RuntimeError(
            f"{path} is not JSON, and reading other YAML needs the pyyaml "
            f"package, which is not installed") from None
    return yaml.safe_load(text)
