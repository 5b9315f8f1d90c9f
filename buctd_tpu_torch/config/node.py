"""A minimal yacs-compatible config node.

The reference uses a yacs CfgNode singleton merged from YAML + a flat CLI override list
(lib/config/default.py:180-207).  yacs is not a dependency of this package, so this is a
small reimplementation of the surface it needs: attribute access,
``merge_from_file``, ``merge_from_list``, ``clone``, freeze/defrost, and ``new_allowed``
subtrees (used by ``MODEL.EXTRA``).
"""

from __future__ import annotations

import ast
import copy
from typing import Any

import yaml


class CfgNode(dict):
    """dict with attribute access, freezing, and yacs-style merging."""

    _FROZEN = "__frozen__"
    _NEW_ALLOWED = "__new_allowed__"

    def __init__(self, init_dict: dict | None = None, new_allowed: bool = False):
        super().__init__()
        object.__setattr__(self, CfgNode._FROZEN, False)
        object.__setattr__(self, CfgNode._NEW_ALLOWED, new_allowed)
        if init_dict:
            for k, v in init_dict.items():
                self[k] = self._to_node(v, new_allowed)

    @staticmethod
    def _to_node(value: Any, new_allowed: bool = False) -> Any:
        if isinstance(value, dict) and not isinstance(value, CfgNode):
            return CfgNode(value, new_allowed=new_allowed)
        return value

    # ---- attribute access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode._FROZEN):
            raise AttributeError(f"CfgNode is frozen; cannot set {name}")
        self[name] = self._to_node(value)

    # ---- freeze / defrost -------------------------------------------------
    def freeze(self) -> None:
        object.__setattr__(self, CfgNode._FROZEN, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()

    def defrost(self) -> None:
        object.__setattr__(self, CfgNode._FROZEN, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode._FROZEN)

    def clone(self) -> "CfgNode":
        node = CfgNode(new_allowed=object.__getattribute__(self, CfgNode._NEW_ALLOWED))
        for k, v in self.items():
            node[k] = v.clone() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return node

    # ---- merging ----------------------------------------------------------
    def merge_from_file(self, path: str) -> None:
        with open(path) as f:
            loaded = yaml.safe_load(f) or {}
        self._merge_dict(loaded)

    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        self._merge_dict(other)

    def _merge_dict(self, other: dict) -> None:
        if self.is_frozen():
            raise AttributeError("CfgNode is frozen")
        new_allowed = object.__getattribute__(self, CfgNode._NEW_ALLOWED)
        for k, v in other.items():
            if k in self:
                cur = self[k]
                if isinstance(cur, CfgNode) and isinstance(v, dict):
                    cur._merge_dict(v)
                else:
                    self[k] = self._coerce(v, cur)
            elif new_allowed:
                self[k] = self._to_node(v, new_allowed=True)
            else:
                raise KeyError(f"Non-existent config key: {k}")

    def merge_from_list(self, opts: list) -> None:
        """yacs-style flat KEY VALUE override list (e.g. from CLI)."""
        if len(opts) % 2:
            raise ValueError(f"override list must have even length, got {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            leaf = parts[-1]
            if leaf not in node and not object.__getattribute__(node, CfgNode._NEW_ALLOWED):
                raise KeyError(f"Non-existent config key: {key}")
            cur = node.get(leaf, None)
            node[leaf] = self._coerce(self._decode(value), cur)

    @staticmethod
    def _decode(value: Any) -> Any:
        """Parse a CLI string into a Python literal, matching yacs behavior."""
        if not isinstance(value, str):
            return value
        try:
            return ast.literal_eval(value)
        except (ValueError, SyntaxError):
            return value

    @staticmethod
    def _coerce(value: Any, reference: Any) -> Any:
        """Coerce merged values to stay type-compatible with the default."""
        if isinstance(reference, CfgNode) and isinstance(value, dict):
            merged = reference.clone()
            merged._merge_dict(value)
            return merged
        if isinstance(reference, tuple) and isinstance(value, list):
            return tuple(value)
        if isinstance(reference, list) and isinstance(value, tuple):
            return list(value)
        if isinstance(reference, float) and isinstance(value, int):
            return float(value)
        return CfgNode._to_node(value)

    def dump(self) -> str:
        def to_plain(node):
            if isinstance(node, CfgNode):
                return {k: to_plain(v) for k, v in node.items()}
            if isinstance(node, tuple):
                return list(node)
            return node

        return yaml.safe_dump(to_plain(self), default_flow_style=False)

    def __str__(self) -> str:
        return self.dump()
