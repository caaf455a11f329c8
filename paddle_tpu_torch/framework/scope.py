"""Scope: hierarchical name -> value map.

Copy of ``paddle_tpu/framework/scope.py``. Values are torch tensors; the
executor writes each updated persistable back after a run, and an op that
updates in place (the fused Adam kernel) hands back the very tensor the
scope already holds. Every live scope is listed in a weak set
(:func:`live_scopes`), which the CPU's synthetic memory statistics read
(``device.memory_stats``).
"""
from __future__ import annotations

import weakref
from typing import Any, Dict, Iterator, List, Optional

_LIVE: "weakref.WeakSet[Scope]" = weakref.WeakSet()


def live_scopes() -> List["Scope"]:
    """Every scope not yet collected."""
    return list(_LIVE)


class Scope:
    def __init__(self, parent: Optional["Scope"] = None):
        self._parent = parent
        self._vars: Dict[str, Any] = {}
        self._kids: List["Scope"] = []
        _LIVE.add(self)

    def new_scope(self) -> "Scope":
        kid = Scope(self)
        self._kids.append(kid)
        return kid

    def drop_kids(self) -> None:
        self._kids.clear()

    @property
    def parent(self) -> Optional["Scope"]:
        return self._parent

    # -- value access ---------------------------------------------------
    def set(self, name: str, value: Any) -> None:
        """Set in the scope that already owns `name`, else locally."""
        scope = self._owner(name) or self
        scope._vars[name] = value

    def set_local(self, name: str, value: Any) -> None:
        self._vars[name] = value

    def get(self, name: str, default: Any = None) -> Any:
        scope = self._owner(name)
        return scope._vars[name] if scope is not None else default

    def has(self, name: str) -> bool:
        return self._owner(name) is not None

    def erase(self, name: str) -> None:
        scope = self._owner(name)
        if scope is not None:
            del scope._vars[name]

    def _owner(self, name: str) -> Optional["Scope"]:
        s: Optional[Scope] = self
        while s is not None:
            if name in s._vars:
                return s
            s = s._parent
        return None

    def local_var_names(self) -> List[str]:
        return list(self._vars)

    def all_var_names(self) -> List[str]:
        names = []
        s: Optional[Scope] = self
        while s is not None:
            names.extend(s._vars)
            s = s._parent
        return names

    def __iter__(self) -> Iterator[str]:
        return iter(self.all_var_names())

    # reference-compatible aliases
    find_var = get
    var = set_local


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


def reset_global_scope() -> Scope:
    global _global_scope
    _global_scope = Scope()
    return _global_scope
