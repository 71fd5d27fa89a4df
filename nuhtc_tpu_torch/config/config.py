"""Python-file config system with ``_base_`` inheritance and ``${var}`` interpolation.

The port's own copy of nuhtc_tpu/config/config.py (standard library only):
``nuhtc_tpu_torch`` imports nothing of the JAX package. Mirrors the ergonomics of the reference's mmcv ``Config.fromfile`` plus
NuHTC's extra ``${dotted.key}`` string-interpolation pass (reference
nuhtc/utils/vars.py:15-35 and nuhtc/utils/patch.py:69-81), reimplemented
from scratch: a config is a plain Python module executed in an isolated
namespace; ``_base_`` entries are loaded first and deep-merged; any string
value containing ``${key.path}`` is substituted from the resolved tree.
"""

from __future__ import annotations

import copy
import os
import re
import runpy
from typing import Any, Dict, List


class ConfigDict(dict):
    """dict with attribute access (recursive)."""

    def __getattr__(self, name):
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return v

    def __setattr__(self, name, value):
        self[name] = value

    def __deepcopy__(self, memo):
        return ConfigDict(
            {copy.deepcopy(k, memo): copy.deepcopy(v, memo) for k, v in self.items()}
        )

    def get_nested(self, dotted: str, default=None):
        cur: Any = self
        for part in dotted.split("."):
            if isinstance(cur, dict) and part in cur:
                cur = cur[part]
            else:
                return default
        return cur


def _wrap(obj):
    if isinstance(obj, dict) and not isinstance(obj, ConfigDict):
        return ConfigDict({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, ConfigDict):
        return ConfigDict({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        t = type(obj)
        return t(_wrap(v) for v in obj)
    return obj


def _coerce_option(value):
    """CLI override string → typed value (mmcv DictAction semantics)."""
    if not isinstance(value, str):
        return value
    lowered = value.strip()
    if lowered in ("True", "true"):
        return True
    if lowered in ("False", "false"):
        return False
    if lowered in ("None", "null"):
        return None
    try:
        return int(lowered)
    except ValueError:
        pass
    try:
        return float(lowered)
    except ValueError:
        pass
    import ast

    try:
        return ast.literal_eval(lowered)
    except (ValueError, SyntaxError):
        return value


def deep_merge(base: dict, override: dict) -> dict:
    """Merge ``override`` into ``base`` recursively (override wins).

    A ``_delete_: True`` key in an override dict replaces the base subtree
    wholesale (mmcv semantics).
    """
    out = dict(base)
    for k, v in override.items():
        if (
            isinstance(v, dict)
            and k in out
            and isinstance(out[k], dict)
            and not v.get("_delete_", False)
        ):
            out[k] = deep_merge(out[k], v)
        else:
            if isinstance(v, dict):
                v = {kk: vv for kk, vv in v.items() if kk != "_delete_"}
            out[k] = v
    return out


_VAR_RE = re.compile(r"\$\{([\w.]+)\}")


def resolve_vars(cfg: dict, root: dict | None = None) -> dict:
    """Substitute ``${dotted.key}`` patterns in string values from the root tree."""
    root = root if root is not None else cfg

    def subst(value):
        if isinstance(value, str):
            # pure reference → replace with the referenced value (any type)
            m = _VAR_RE.fullmatch(value)
            if m:
                ref = ConfigDict(_wrap(root)).get_nested(m.group(1), value)
                return subst(ref) if isinstance(ref, str) and ref != value else ref

            def repl(m):
                ref = ConfigDict(_wrap(root)).get_nested(m.group(1))
                return str(ref) if ref is not None else m.group(0)

            return _VAR_RE.sub(repl, value)
        if isinstance(value, dict):
            return {k: subst(v) for k, v in value.items()}
        if isinstance(value, (list, tuple)):
            return type(value)(subst(v) for v in value)
        return value

    return subst(cfg)


class Config:
    """A loaded configuration tree."""

    def __init__(self, cfg_dict: Dict[str, Any] | None = None, filename: str | None = None):
        self._cfg = _wrap(cfg_dict or {})
        self.filename = filename

    # -- loading ------------------------------------------------------------
    @staticmethod
    def fromfile(path: str) -> "Config":
        path = os.path.abspath(path)
        raw = Config._load_module(path)
        raw = resolve_vars(raw)
        return Config(raw, filename=path)

    @staticmethod
    def _load_module(path: str) -> dict:
        ns = runpy.run_path(path)
        cfg = {
            k: v
            for k, v in ns.items()
            if not k.startswith("__") and not callable(v) and not isinstance(v, type(os))
        }
        bases: List[str] = []
        b = cfg.pop("_base_", None)
        if b:
            bases = [b] if isinstance(b, str) else list(b)
        merged: dict = {}
        for bpath in bases:
            full = os.path.join(os.path.dirname(path), bpath)
            merged = deep_merge(merged, Config._load_module(full))
        return deep_merge(merged, cfg)

    # -- access -------------------------------------------------------------
    def __getattr__(self, name):
        if name.startswith("_") or name == "filename":
            raise AttributeError(name)
        try:
            return self._cfg[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __getitem__(self, k):
        return self._cfg[k]

    def __contains__(self, k):
        return k in self._cfg

    def get(self, k, default=None):
        return self._cfg.get(k, default)

    def to_dict(self):
        return copy.deepcopy(dict(self._cfg))

    # -- mutation -----------------------------------------------------------
    @staticmethod
    def _coerce(value):
        return _coerce_option(value)

    def merge_from_options(self, options: Dict[str, Any]):
        """Apply ``--cfg-options a.b.c=v`` style deep overrides.

        String values are coerced like mmcv's DictAction: int/float/bool/
        None where they parse, python literals (lists/tuples/dicts) via
        ast.literal_eval, else kept as strings."""
        for dotted, value in options.items():
            parts = dotted.split(".")
            cur = self._cfg
            for p in parts[:-1]:
                if p not in cur or not isinstance(cur[p], dict):
                    cur[p] = ConfigDict()
                cur = cur[p]
            cur[parts[-1]] = _wrap(_coerce_option(value))
        self._cfg = _wrap(resolve_vars(dict(self._cfg)))

    def dump(self, path: str):
        import pprint

        with open(path, "w") as f:
            f.write(pprint.pformat(self.to_dict(), width=100))
