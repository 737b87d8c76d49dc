"""Config system (counterpart of ``skelsplat_tpu/config/__init__.py``):
hydra-compatible YAML without the hydra dependency.

``python -m skelsplat_tpu_torch.train --config-name <dataset>.yaml
[group.key=value ...]`` loads ``configs/<dataset>.yaml`` (copies of the JAX
package's files) with six groups (dataset, training, debug, model,
optimization, pipeline) and a timestamped run dir. This module covers the
subset of hydra the CLIs use: loading by name, dotted overrides with
YAML-typed values, ``${now:...}`` interpolation for the run dir, and the
``ConfigHandler`` attribute-group facade.
"""

from __future__ import annotations

import copy
import datetime
import os
import re
from typing import Any

import yaml

DEFAULT_CONFIG_DIR = os.path.join(os.path.dirname(__file__), "configs")


class ParamGroup:
    """Attribute view over one config group."""

    def __init__(self, d: dict):
        self._dict = dict(d or {})
        for key, value in self._dict.items():
            setattr(self, key, value)

    def to_dict(self):
        return {k: getattr(self, k) for k in self._dict}

    def __repr__(self):
        return f"ParamGroup({self.to_dict()!r})"


def _interpolate(value: str, now: datetime.datetime) -> str:
    def repl(m):
        spec = m.group(1)
        if spec.startswith("now:"):
            return now.strftime(spec[4:])
        raise ValueError(f"unsupported interpolation ${{{spec}}}")
    return re.sub(r"\$\{([^}]+)\}", repl, value)


def _set_dotted(cfg: dict, dotted: str, value: Any):
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def parse_overrides(overrides: list[str]) -> dict[str, Any]:
    """hydra-style ``group.key=value`` overrides; values parsed as YAML
    (so ``true``, ``1e-5``, ``[1,2]`` get proper types)."""
    out = {}
    for ov in overrides:
        if "=" not in ov:
            raise SystemExit(f"override {ov!r} is not of form key=value")
        key, _, raw = ov.partition("=")
        # hydra's append (+key) / force-append (++key) prefixes: our configs
        # are plain dicts, so adding and overriding are the same operation
        out[key.strip().lstrip("+")] = yaml.safe_load(raw)
    return out


class Config:
    """Loaded configuration: dict access + per-group attribute access."""

    def __init__(self, data: dict, run_dir: str | None):
        self._data = data
        self.run_dir = run_dir
        for group, values in data.items():
            if group == "hydra" or group == "defaults":
                continue
            if isinstance(values, dict):
                setattr(self, group, ParamGroup(values))

    def __getitem__(self, key):
        return getattr(self, key)

    def to_dict(self):
        return copy.deepcopy(self._data)


def load_config(config_name: str, overrides: list[str] | None = None,
                config_dir: str | None = None,
                make_run_dir: bool = True) -> Config:
    """Load ``<config_dir>/<config_name>``(.yaml) and apply overrides.

    Creates the templated run dir (experiments/<ds>/<date>/<time>) and dumps
    the resolved config there, mirroring hydra's run-dir behavior.
    """
    config_dir = config_dir or DEFAULT_CONFIG_DIR
    name = config_name if config_name.endswith(".yaml") else config_name + ".yaml"
    path = name if os.path.isabs(name) else os.path.join(config_dir, name)
    if not os.path.exists(path) and os.path.exists(config_name):
        path = config_name
    with open(path) as f:
        data = yaml.safe_load(f) or {}

    for key, value in parse_overrides(overrides or []).items():
        _set_dotted(data, key, value)

    run_dir = None
    now = datetime.datetime.now()
    tmpl = (data.get("hydra", {}) or {}).get("run", {}).get("dir")
    if tmpl:
        run_dir = _interpolate(tmpl, now)
        if make_run_dir:
            os.makedirs(run_dir, exist_ok=True)
            hydra_dir = os.path.join(run_dir, ".hydra")
            os.makedirs(hydra_dir, exist_ok=True)
            dump = {k: v for k, v in data.items() if k != "hydra"}
            with open(os.path.join(hydra_dir, "config.yaml"), "w") as f:
                yaml.safe_dump(dump, f, sort_keys=False)
    return Config(data, run_dir)


def latest_run_dir(cfg: Config) -> str:
    """Newest existing run dir matching the config's hydra template (the
    ${now:...} segments become globs)."""
    import glob

    tmpl = (cfg.to_dict().get("hydra", {}) or {}).get("run", {}).get("dir")
    if not tmpl:
        raise SystemExit("config has no hydra.run.dir template")
    pattern = re.sub(r"\$\{[^}]+\}", "*", tmpl)
    runs = sorted(glob.glob(pattern))
    # ignore the empty dir this very invocation may have just created
    runs = [r for r in runs if os.listdir(r)]
    if not runs:
        raise SystemExit(f"no runs matching {pattern}")
    return runs[-1]


class ConfigHandler:
    """The run dir and the six groups of a loaded config."""

    def __init__(self, cfg: Config):
        self.hydra_out = cfg.run_dir
        self.dataset = cfg.dataset
        self.training = cfg.training
        self.debug = cfg.debug
        self.model = cfg.model
        self.optimization = cfg.optimization
        self.pipeline = cfg.pipeline



class TriangulationConfigHandler:
    """The run dir and the dataset and debug groups of a triangulation
    config."""

    def __init__(self, cfg: Config):
        self.hydra_out = cfg.run_dir
        self.dataset = cfg.dataset
        self.debug = cfg.debug
