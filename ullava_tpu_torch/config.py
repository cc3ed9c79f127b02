"""YAML config loader with the six-top-level-key layout (counterpart of
`ullava_tpu/config.py`).

A `Config(cfg_path)` object whose `assign_config()` returns
`(model_cfg, dataset_cfg, eval_dataset_cfg, training_cfg, task_cfg,
processor_cfg)` and whose YAML files use the fixed top-level keys
`model / task / processor / dataset / eval_dataset / training`.

PyYAML parsed into `ConfigNode`, a small recursive attribute-dict that
supports `node.key`, `node['key']`, `node.get(key, default)`, iteration,
and `to_dict()`. PyYAML is imported only to read a file, so
`Config(cfg_dict=...)` needs none.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterator, Mapping, Optional

from ullava_tpu_torch.registry import registry


class ConfigNode(Mapping):
    """Recursive attribute-access wrapper over a plain dict."""

    def __init__(self, data: Optional[Dict[str, Any]] = None) -> None:
        object.__setattr__(self, "_data", {})
        if data:
            for k, v in data.items():
                self._data[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, value: Any) -> Any:
        if isinstance(value, Mapping) and not isinstance(value, ConfigNode):
            return ConfigNode(dict(value))
        if isinstance(value, (list, tuple)):
            return [cls._wrap(v) for v in value]
        return value

    # Mapping protocol --------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: object) -> bool:
        return key in self._data

    # Attribute access --------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        try:
            return self._data[key]
        except KeyError:
            raise AttributeError(key) from None

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = self._wrap(value)

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = self._wrap(value)

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def setdefault(self, key: str, default: Any = None) -> Any:
        if key not in self._data:
            self._data[key] = self._wrap(default)
        return self._data[key]

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def values(self):
        return self._data.values()

    def to_dict(self) -> Dict[str, Any]:
        def unwrap(v: Any) -> Any:
            if isinstance(v, ConfigNode):
                return v.to_dict()
            if isinstance(v, list):
                return [unwrap(x) for x in v]
            return v

        return {k: unwrap(v) for k, v in self._data.items()}

    def merge_from(self, other: Mapping) -> "ConfigNode":
        """Recursive merge; `other`'s values win."""
        for k, v in other.items():
            if (
                k in self._data
                and isinstance(self._data[k], ConfigNode)
                and isinstance(v, Mapping)
            ):
                self._data[k].merge_from(v)
            else:
                self._data[k] = self._wrap(v)
        return self

    def __repr__(self) -> str:
        return f"ConfigNode({self._data!r})"


class Config:
    """Loads a YAML file and exposes the six standard config sub-trees."""

    TOP_KEYS = ("model", "task", "processor", "dataset", "eval_dataset", "training")

    def __init__(self, cfg_path: Optional[str] = None, cfg_dict: Optional[Dict] = None):
        if cfg_dict is None:
            if cfg_path is None:
                raise ValueError("one of cfg_path / cfg_dict is required")
            import yaml

            with open(cfg_path) as f:
                cfg_dict = yaml.safe_load(f)
        self.cfg_path = cfg_path
        raw = ConfigNode(cfg_dict)

        model = raw.get("model")
        if model is None:
            raise KeyError("Missing 'model' configuration.")
        arch = model.get("arch")
        if arch is not None and registry.get_model_class(arch) is None:
            raise KeyError(f"Model '{arch}' has not been registered.")
        for required in ("task", "processor", "training"):
            if raw.get(required) is None:
                raise KeyError(f"Expecting '{required}' as a root config key.")

        self.config = ConfigNode(
            {
                "model": model,
                "task": raw.get("task"),
                "processor": raw.get("processor"),
                "dataset": raw.get("dataset") or {},
                "eval_dataset": raw.get("eval_dataset") or {},
                "training": raw.get("training"),
            }
        )
        registry.register("configuration", self)

    # Accessors ----------------------------------------------------------
    @property
    def model_cfg(self) -> ConfigNode:
        return self.config.model

    @property
    def dataset_cfg(self) -> ConfigNode:
        return self.config.dataset

    @property
    def eval_dataset_cfg(self) -> ConfigNode:
        return self.config.eval_dataset

    @property
    def training_cfg(self) -> ConfigNode:
        return self.config.training

    @property
    def task_cfg(self) -> ConfigNode:
        return self.config.task

    @property
    def processor_cfg(self) -> ConfigNode:
        return self.config.processor

    def assign_config(self):
        return (
            self.model_cfg,
            self.dataset_cfg,
            self.eval_dataset_cfg,
            self.training_cfg,
            self.task_cfg,
            self.processor_cfg,
        )

    def get_config(self) -> ConfigNode:
        return self.config

    def to_dict(self) -> Dict[str, Any]:
        return self.config.to_dict()

    def pretty_print(self) -> str:
        out = []
        for key in self.TOP_KEYS:
            out.append(f"======  {key} ======")
            out.append(json.dumps(self.config[key].to_dict(), indent=4, sort_keys=True))
        text = "\n".join(out)
        print(text)
        return text
