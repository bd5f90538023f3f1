"""YAML config loader with recursive ``inherit_from`` merge (torch port of
utils/config.py; the reference's utils/config_utils.py semantics: the
child dict masks the parent, merged recursively).

``yaml`` is imported only inside ``load_config``: configs passed as dicts
need no pyyaml.
"""

from __future__ import annotations

import os


def _yaml():
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            "load_config reads YAML files and needs pyyaml (pip install "
            "pyyaml); pass the config as a dict instead") from e
    return yaml


def load_config(path: str, default_path: str | None = None) -> dict:
    yaml = _yaml()
    with open(path, "r") as f:
        cfg_special = yaml.full_load(f)

    inherit_from = cfg_special.get("inherit_from")
    if inherit_from is not None:
        # resolve relative to the working directory first (the
        # reference's behaviour), then to the config file's own directory,
        # then to the repository root
        candidates = [
            inherit_from,
            os.path.join(os.path.dirname(path), inherit_from),
            os.path.join(os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))), inherit_from),
        ]
        for c in candidates:
            if os.path.isfile(c):
                inherit_from = c
                break
        cfg = load_config(inherit_from, default_path)
    elif default_path is not None:
        with open(default_path, "r") as f:
            cfg = yaml.full_load(f)
    else:
        cfg = dict()

    update_recursive(cfg, cfg_special)
    return cfg


def update_recursive(dict1: dict, dict2: dict) -> None:
    for k, v in dict2.items():
        if k not in dict1:
            dict1[k] = dict()
        if isinstance(v, dict):
            update_recursive(dict1[k], v)
        else:
            dict1[k] = v
