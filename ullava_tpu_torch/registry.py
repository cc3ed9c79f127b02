"""Global name registries binding YAML vocabulary to Python classes
(counterpart of `ullava_tpu/registry.py`).

Dataset builders, processors, collators, models and tasks are referenced
by name from YAML: one dict per kind, decorator registration, and a
`state` store for cross-cutting values (paths, seeds). The port's
registry is its own: names registered by the JAX package are not in it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Registry:
    """String -> class maps, one namespace per component kind."""

    _KINDS = ("builder", "model", "processor", "collator", "task")

    def __init__(self) -> None:
        self._maps: Dict[str, Dict[str, type]] = {k: {} for k in self._KINDS}
        self._state: Dict[str, Any] = {}

    # -- registration -------------------------------------------------------
    def _register(self, kind: str, name: str) -> Callable[[type], type]:
        def deco(cls: type) -> type:
            mapping = self._maps[kind]
            if name in mapping and mapping[name] is not cls:
                raise KeyError(
                    f"{kind} name '{name}' already registered to {mapping[name]!r}"
                )
            mapping[name] = cls
            return cls

        return deco

    def register_builder(self, name: str):
        return self._register("builder", name)

    def register_model(self, name: str):
        return self._register("model", name)

    def register_processor(self, name: str):
        return self._register("processor", name)

    def register_collator(self, name: str):
        return self._register("collator", name)

    def register_task(self, name: str):
        return self._register("task", name)

    # -- lookup -------------------------------------------------------------
    def _get(self, kind: str, name: str) -> Optional[type]:
        return self._maps[kind].get(name)

    def get_builder_class(self, name: str):
        return self._get("builder", name)

    def get_model_class(self, name: str):
        return self._get("model", name)

    def get_processor_class(self, name: str):
        return self._get("processor", name)

    def get_collator_class(self, name: str):
        return self._get("collator", name)

    def get_task_class(self, name: str):
        return self._get("task", name)

    def list_names(self, kind: str):
        return sorted(self._maps[kind])

    # -- generic state store ------------------------------------------------
    def register(self, name: str, obj: Any) -> None:
        self._state[name] = obj

    def get(self, name: str, default: Any = None, no_warning: bool = False) -> Any:
        return self._state.get(name, default)

    def unregister(self, name: str) -> None:
        self._state.pop(name, None)


registry = Registry()
