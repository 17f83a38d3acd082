"""Component registry — the Modalities registry/factory mechanism.

The port's own copy of ``repro.config.registry``, with its own registry
instance.

A component is identified by ``(component_key, variant_key)`` and produced by a
*factory* (any callable). Each ``component_key`` is bound to an *interface*
(IF): an abstract base class or plain class the built instance must satisfy.
Custom components can be registered at runtime without touching framework code
— the paper's central extensibility claim.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, Optional, Tuple


class RegistryError(Exception):
    pass


@dataclasses.dataclass
class ComponentEntry:
    component_key: str
    variant_key: str
    factory: Callable[..., Any]
    interface: Optional[type]

    def signature(self) -> inspect.Signature:
        target = self.factory
        if inspect.isclass(target):
            target = target.__init__
            sig = inspect.signature(target)
            params = [p for name, p in sig.parameters.items() if name != "self"]
            return inspect.Signature(params)
        return inspect.signature(target)


class Registry:
    """Maps (component_key, variant_key) -> factory, with IF binding."""

    def __init__(self) -> None:
        self._entries: Dict[Tuple[str, str], ComponentEntry] = {}
        self._interfaces: Dict[str, type] = {}

    # -- registration -------------------------------------------------------
    def register_interface(self, component_key: str, interface: type) -> None:
        existing = self._interfaces.get(component_key)
        if existing is not None and existing is not interface:
            raise RegistryError(
                f"interface for component_key={component_key!r} already bound "
                f"to {existing.__name__}"
            )
        self._interfaces[component_key] = interface

    def register(
        self,
        component_key: str,
        variant_key: str,
        factory: Callable[..., Any],
        interface: Optional[type] = None,
    ) -> None:
        if interface is not None:
            self.register_interface(component_key, interface)
        iface = self._interfaces.get(component_key)
        key = (component_key, variant_key)
        if key in self._entries:
            raise RegistryError(f"component {key} already registered")
        self._entries[key] = ComponentEntry(component_key, variant_key, factory, iface)

    # -- lookup / build -----------------------------------------------------
    def entry(self, component_key: str, variant_key: str) -> ComponentEntry:
        key = (component_key, variant_key)
        if key not in self._entries:
            variants = sorted(v for c, v in self._entries if c == component_key)
            if variants:
                raise RegistryError(
                    f"unknown variant {variant_key!r} for component "
                    f"{component_key!r}; registered variants: {variants}"
                )
            raise RegistryError(
                f"unknown component_key {component_key!r}; registered keys: "
                f"{sorted({c for c, _ in self._entries})}"
            )
        return self._entries[key]

    def validate_kwargs(self, entry: ComponentEntry, kwargs: Dict[str, Any]) -> None:
        """Flag misconfigurations before instantiation (IF-level validation)."""
        sig = entry.signature()
        accepts_var_kw = any(
            p.kind is inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values()
        )
        if not accepts_var_kw:
            unknown = set(kwargs) - set(sig.parameters)
            if unknown:
                raise RegistryError(
                    f"{entry.component_key}/{entry.variant_key}: unexpected config "
                    f"keys {sorted(unknown)}; accepted: {sorted(sig.parameters)}"
                )
        missing = [
            name
            for name, p in sig.parameters.items()
            if p.default is inspect.Parameter.empty
            and p.kind
            in (inspect.Parameter.POSITIONAL_OR_KEYWORD, inspect.Parameter.KEYWORD_ONLY)
            and name not in kwargs
        ]
        if missing:
            raise RegistryError(
                f"{entry.component_key}/{entry.variant_key}: missing required "
                f"config keys {missing}"
            )

    def build(self, component_key: str, variant_key: str, **kwargs: Any) -> Any:
        entry = self.entry(component_key, variant_key)
        self.validate_kwargs(entry, kwargs)
        instance = entry.factory(**kwargs)
        if entry.interface is not None and not isinstance(instance, entry.interface):
            raise RegistryError(
                f"{component_key}/{variant_key} produced {type(instance).__name__}, "
                f"which does not satisfy IF {entry.interface.__name__}"
            )
        return instance

    def variants(self, component_key: str):
        return sorted(v for c, v in self._entries if c == component_key)


#: the port's default registry (populated by repro_torch.core.components)
DEFAULT_REGISTRY = Registry()
