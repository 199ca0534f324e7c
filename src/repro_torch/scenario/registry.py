"""Typed registries (port of ``repro.scenario.registry``; the port keeps its
own copy so it never imports the JAX package).

Every extension point of the pipeline (service-time laws, strategies,
objectives, partitioners) is a named entry in a :class:`Registry`,
populated with decorator registration::

    from repro_torch.scenario.registry import timing_law

    @timing_law("mylaw")
    def _mylaw(): ...

Lookups go through :meth:`Registry.get`, which raises a ``ValueError``
listing the registered names on an unknown key, so a typo fails eagerly
with the available options.  Stdlib only.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


class Registry:
    """A name -> entry mapping with decorator registration and helpful
    unknown-key errors."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: dict[str, Any] = {}

    def register(self, name: str) -> Callable:
        """Decorator: ``@REG.register("name")`` stores the decorated object
        under ``name`` and returns it unchanged."""
        if not isinstance(name, str) or not name:
            raise TypeError(
                f"{self.kind} registry keys must be non-empty strings, "
                f"got {name!r}")

        def deco(obj):
            if name in self._entries:
                raise ValueError(
                    f"{self.kind} {name!r} is already registered "
                    f"(to {self._entries[name]!r})")
            self._entries[name] = obj
            return obj

        return deco

    def get(self, name: str):
        """Entry for ``name``; unknown keys raise listing the options."""
        try:
            return self._entries[name]
        except KeyError:
            plural = (self.kind[:-1] + "ies" if self.kind.endswith("y")
                      else self.kind + "s")
            raise ValueError(
                f"unknown {self.kind}: {name!r}; registered {plural}: "
                f"{sorted(self._entries)}") from None

    def names(self) -> tuple[str, ...]:
        return tuple(sorted(self._entries))

    def items(self):
        return self._entries.items()

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._entries))

    def __len__(self) -> int:
        return len(self._entries)

    def __repr__(self) -> str:
        return f"Registry({self.kind!r}, {sorted(self._entries)})"


# The four extension points of the Scenario API.  ``TIMING_LAWS`` is keyed by
# the ``distribution=`` strings the engines always used ("exponential", ...);
# its kind reads "service distribution", as in the JAX package.
TIMING_LAWS = Registry("service distribution")
STRATEGIES = Registry("strategy")
OBJECTIVES = Registry("objective")
PARTITIONS = Registry("partition")

# decorator aliases: @timing_law("name"), @strategy("name"), ...
timing_law = TIMING_LAWS.register
strategy = STRATEGIES.register
objective = OBJECTIVES.register
partition = PARTITIONS.register
