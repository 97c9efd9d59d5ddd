"""Minimal yacs-style config node (the port's own copy of
`simple_sfod_tpu/config/cfg_node.py`).

Same merge semantics as the JAX package's node, so every YAML under
`configs/` merges to the same key tree in both packages, except a node of
SWITCH_NODES given as one bool (below). Files are read by
the port's own reader of the YAML subset the configs are written in
(`yaml_subset.py`), so no YAML package is needed.
"""

from __future__ import annotations

import ast
import copy
import os
from typing import Any, List

from . import yaml_subset


# Nodes that a config may give as one bool, by path: the bool sets the named
# switch and turns the node's other bool keys off. Two SFAT YAMLs write
# `DOMAIN_CLASSIFIER: False`; the JAX package's node takes the bool in place
# of the node, and its SFAT trainer then raises AttributeError on
# `DOMAIN_CLASSIFIER.ENABLED` (a fault of the reference the port does not copy).
SWITCH_NODES = {"DOMAIN_CLASSIFIER": "ENABLED"}


def _set_switch(node: "CfgNode", switch: str, value: bool) -> None:
    for k, v in node.items():
        if isinstance(v, bool):
            node[k] = False
    node[switch] = value


class CfgNode(dict):
    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict=None):
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        init_dict = init_dict or {}
        for k, v in init_dict.items():
            self[k] = CfgNode(v) if isinstance(v, dict) else v

    # attribute access ------------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"config key not found: {name}")

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(f"config is frozen; cannot set {name}")
        self[name] = CfgNode(value) if isinstance(value, dict) and not isinstance(value, CfgNode) else value

    # freeze ------------------------------------------------------------------
    def freeze(self):
        object.__setattr__(self, CfgNode.IMMUTABLE, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()

    def defrost(self):
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    # merging -----------------------------------------------------------------
    @staticmethod
    def _decode(value: Any, old: Any) -> Any:
        """Coerce YAML/CLI values toward the default's type (yacs behaviour:
        python-literal strings like '("a",)' eval'd, lists <-> tuples,
        int -> float)."""
        if isinstance(value, str) and not isinstance(old, str):
            try:
                value = ast.literal_eval(value)
            except (ValueError, SyntaxError):
                pass
        if isinstance(old, tuple) and isinstance(value, list):
            return tuple(value)
        if isinstance(old, float) and isinstance(value, int):
            return float(value)
        return value

    def _merge_dict(self, d: dict, allow_new: bool = False, path: str = ""):
        for k, v in d.items():
            full = f"{path}.{k}" if path else k
            if k not in self:
                if not allow_new:
                    raise KeyError(f"non-existent config key: {full}")
                self[k] = CfgNode(v) if isinstance(v, dict) else v
                continue
            if isinstance(v, dict) and isinstance(self[k], CfgNode):
                self[k]._merge_dict(v, allow_new, full)
            elif isinstance(v, bool) and full in SWITCH_NODES and isinstance(self[k], CfgNode):
                _set_switch(self[k], SWITCH_NODES[full], v)
            else:
                self[k] = self._decode(v, self[k])

    def merge_from_file(self, path: str, allow_new: bool = False):
        data = yaml_subset.load(path) or {}
        base = data.pop("_BASE_", None)
        if base:
            if not base.startswith("/"):
                base = os.path.join(os.path.dirname(path), base)
            self.merge_from_file(base, allow_new)
        self._merge_dict(data, allow_new)

    def merge_from_list(self, opts: List[str]):
        if len(opts) % 2:
            raise ValueError(f"opts must be KEY VALUE pairs, got {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"non-existent config key: {key}")
            try:
                parsed = ast.literal_eval(value)
            except (ValueError, SyntaxError):
                parsed = value
            if isinstance(parsed, bool) and key in SWITCH_NODES and isinstance(node[leaf], CfgNode):
                _set_switch(node[leaf], SWITCH_NODES[key], parsed)
            else:
                node[leaf] = self._decode(parsed, node[leaf])
