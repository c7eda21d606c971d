"""Reflective ``--ClassName.param`` CLI config system (a copy of
``pggan_tpu/utils/config.py``: plain Python, no JAX).

Reproduces the reference's distinctive config UX (utils.py:74-119,
train.py:191-205; the build north-star requires it preserved): for a curated
list of classes, every constructor parameter with a default becomes a
``--ClassName.param`` flag; values are parsed as python literals with a
string fallback; dotted flags are regrouped into per-class kwargs dicts.

Differences: values go through ``ast.literal_eval`` — never ``eval`` (the
reference sandbox-evals arbitrary strings, utils.py:86) — with a
tuple/list/number/bool-aware fallback to str.
"""

from __future__ import annotations

import ast
import inspect


def get_all_classes(module) -> list[type]:
    """All classes defined in (or imported into) a module (reference
    utils.py:74-76)."""
    return [getattr(module, name) for name in dir(module)
            if inspect.isclass(getattr(module, name, None))]


def generic_arg_parse(x: str, hinttype=None):
    """Parse a CLI string: honor an explicit type hint, else try a python
    literal, else keep the string (reference utils.py:79-89 semantics,
    without ``eval``)."""
    if hinttype in (int, float, str):
        try:
            return hinttype(x)
        except ValueError:
            pass  # e.g. "--total_kimg 0.5" with an int-typed default
    s = x
    for _ in range(2):
        s = s.strip("'").strip('"')
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def create_params(classes, excludes=None, overrides=None) -> dict:
    """{class_name: {param: default}} from constructor signatures (reference
    utils.py:92-106). Parameters without defaults are skipped; ``excludes``
    removes params per class; ``overrides`` replaces defaults."""
    excludes = excludes or {}
    overrides = overrides or {}
    params = {}
    for cls in classes:
        nm = cls.__name__
        sig = inspect.signature(cls.__init__)
        entry = {}
        for k, v in sig.parameters.items():
            if v.default is inspect.Parameter.empty:
                continue
            if nm in excludes and k in excludes[nm]:
                continue
            if nm in overrides and k in overrides[nm]:
                entry[k] = overrides[nm][k]
            else:
                entry[k] = v.default
        params[nm] = entry
    return params


def get_structured_params(params: dict) -> dict:
    """Regroup flat ``{'Cls.attr': v}`` entries into ``{'Cls': {'attr': v}}``
    (reference utils.py:109-119)."""
    new_params = {}
    for p, val in params.items():
        if "." in p:
            cls, attr = p.split(".", 1)
            new_params.setdefault(cls, {})[attr] = val
        else:
            new_params[p] = val
    return new_params


def add_class_args(parser, classes, excludes=None, overrides=None,
                   default_params=None) -> dict:
    """Register ``--Cls.param`` flags on an argparse parser; returns the
    auto-params mapping. ``default_params`` (flat dict) is extended in place
    with the flattened defaults so ``parser.set_defaults`` can be applied by
    the caller (reference train.py:196-205 flow)."""
    auto = create_params(classes, excludes, overrides)
    for cls_name, entries in auto.items():
        group = parser.add_argument_group(
            cls_name, f"Arguments for initialization of class {cls_name}")
        for k, default in entries.items():
            flag = f"{cls_name}.{k}"
            group.add_argument(f"--{flag}", type=generic_arg_parse)
            if default_params is not None:
                default_params[flag] = default
    return auto
