"""Minimal python-fire replacement: expose a function's keyword signature as
CLI flags (the reference exposes its trainers via fire.Fire,
cli_lora_pti.py:1039). Supports --key value / --key=value, positional args,
bools (--flag / --flag=False), ints/floats/None/sets/lists by annotation or
default-type inference."""

from __future__ import annotations

import dataclasses
import inspect
import sys
from typing import Any, Callable, get_args, get_origin


def _coerce(raw: str, hint: Any, default: Any) -> Any:
    if raw.lower() in ("none", "null"):
        return None
    target = hint
    if target is inspect.Parameter.empty or target is Any or target is None:
        target = type(default) if default is not None else str
    origin = get_origin(target)
    if origin is not None:
        args = [a for a in get_args(target) if a is not type(None)]
        if origin.__name__ in ("Union", "UnionType") or str(origin).startswith(
                "typing.Union"):
            target = args[0] if args else str
        elif origin in (list, set, frozenset):
            inner = args[0] if args else str
            vals = [v.strip() for v in raw.split(",") if v.strip()]
            return origin(inner(v) for v in vals)
    if target is bool or isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes", "y")
    if isinstance(default, (set, frozenset)):
        return type(default)(v.strip() for v in raw.split(",") if v.strip())
    if isinstance(default, (list, tuple)):
        return type(default)(v.strip() for v in raw.split(","))
    if target in (int, float, str):
        return target(raw)
    try:
        return type(default)(raw) if default is not None else raw
    except (TypeError, ValueError):
        return raw


def _infer_literal(raw: str) -> Any:
    if raw.lower() in ("none", "null"):
        return None
    if raw.lower() in ("true", "false"):
        return raw.lower() == "true"
    for t in (int, float):
        try:
            return t(raw)
        except ValueError:
            pass
    return raw


def coerce_kwargs_to_dataclass(dc_type, kwargs: dict) -> dict:
    """Re-coerce string/inferred CLI kwargs against a dataclass's field
    types (used by trainers whose CLI shim takes **kwargs)."""
    out = {}
    fields = {f.name: f for f in dataclasses.fields(dc_type)}
    for k, v in kwargs.items():
        if k not in fields:
            raise SystemExit(f"unknown flag --{k}")
        f = fields[k]
        if isinstance(v, str):
            out[k] = _coerce(v, f.type, f.default)
        elif isinstance(f.default, (set, frozenset)) and isinstance(v, str):
            out[k] = type(f.default)(v.split(","))
        else:
            out[k] = v
    return out


def fire(fn_or_dc: Callable, argv=None) -> Any:
    """Call fn with kwargs parsed from argv. If given a dataclass type,
    construct it from flags."""
    argv = list(sys.argv[1:] if argv is None else argv)
    has_var_kw = False
    if dataclasses.is_dataclass(fn_or_dc):
        fields = {f.name: (f.type, f.default) for f in
                  dataclasses.fields(fn_or_dc)}
        sig_params = fields
        call = fn_or_dc
    else:
        sig = inspect.signature(fn_or_dc)
        sig_params = {}
        for k, p in sig.parameters.items():
            if p.kind == inspect.Parameter.VAR_KEYWORD:
                has_var_kw = True
                continue
            if p.kind == inspect.Parameter.VAR_POSITIONAL:
                continue
            sig_params[k] = (p.annotation,
                             None if p.default is p.empty else p.default)
        call = fn_or_dc

    if "--help" in argv or "-h" in argv:
        print(f"usage: {getattr(fn_or_dc, '__name__', 'cmd')} [--flag value]...")
        for k, (hint, d) in sig_params.items():
            print(f"  --{k}  (default: {d!r})")
        sys.exit(0)

    kwargs = {}
    positional = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("--"):
            if "=" in a:
                key, raw = a[2:].split("=", 1)
                i += 1
            else:
                key = a[2:]
                if i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                    raw = argv[i + 1]
                    i += 2
                else:
                    raw = "true"  # bare boolean flag
                    i += 1
            key = key.replace("-", "_")
            if key in sig_params:
                hint, default = sig_params[key]
                kwargs[key] = _coerce(raw, hint, default)
            elif has_var_kw:
                kwargs[key] = _infer_literal(raw)
            else:
                raise SystemExit(f"unknown flag --{key}")
        else:
            positional.append(a)
            i += 1

    if positional:
        names = [k for k in sig_params if k not in kwargs]
        for name, val in zip(names, positional):
            hint, default = sig_params[name]
            kwargs[name] = _coerce(val, hint, default)
    return call(**kwargs)
