"""Minimal dataclass -> argparse CLI in the style of tyro (a copy of
``vla_fastvlm_tpu/utils/cli.py``, which the port may not import).

``--kebab-case`` flags from dataclass fields, Optional[...] fields, bools as
``--flag/--no-flag``, tuples and lists, defaults taken from the dataclass,
and ``--config path.yaml`` for defaults that explicit flags override. YAML
is read with ``yaml``, imported only when ``--config`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import typing
from typing import Any, Optional, Sequence, Type, TypeVar, Union

T = TypeVar("T")


def _unwrap_optional(tp: Any) -> tuple[Any, bool]:
    origin = typing.get_origin(tp)
    if origin is Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0], True
    return tp, False


def _base_parser(value: Any) -> Any:
    if value is bool:
        return bool
    if value is int:
        return int
    if value is float:
        return float
    return str


def parse_cli(
    cls: Type[T],
    args: Optional[Sequence[str]] = None,
    prog: Optional[str] = None,
    config_flag: str = "--config",
) -> T:
    """Parse command-line flags into an instance of dataclass ``cls``.

    ``--config path.yaml`` (when present) loads YAML values as defaults that
    explicit flags override. The reference ships ``configs/train_aloha.yaml``
    but never loads it (dead config, SURVEY.md §2.1); here the artifact is
    functional.
    """
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"parse_cli expects a dataclass, got {cls!r}")

    import sys

    raw_args = list(sys.argv[1:] if args is None else args)
    yaml_defaults: dict = {}
    config_path = None
    # Accept both "--config path" and "--config=path" spellings.
    for idx, arg in enumerate(raw_args):
        if arg == config_flag:
            if idx + 1 >= len(raw_args):
                raise SystemExit(f"{config_flag} requires a path argument")
            config_path = raw_args[idx + 1]
            del raw_args[idx: idx + 2]
            break
        if arg.startswith(config_flag + "="):
            config_path = arg[len(config_flag) + 1:]
            if not config_path:
                raise SystemExit(f"{config_flag} requires a path argument")
            del raw_args[idx]
            break
    if config_path is not None:
        try:
            import yaml
        except ImportError as exc:
            raise SystemExit(
                f"{config_flag} {config_path}: reading YAML needs the 'yaml' package, which is not "
                "installed; pass the settings as flags instead"
            ) from exc

        with open(config_path, encoding="utf-8") as f:
            loaded = yaml.safe_load(f) or {}
        if not isinstance(loaded, dict):
            raise TypeError(f"{config_path} must contain a mapping")
        field_names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(loaded) - field_names
        if unknown:
            raise ValueError(
                f"Unknown config keys in {config_path}: {sorted(unknown)}"
            )
        yaml_defaults = loaded
    args = raw_args

    parser = argparse.ArgumentParser(prog=prog, description=cls.__doc__)
    hints = typing.get_type_hints(cls)

    for field in dataclasses.fields(cls):
        if not field.init:
            continue
        flag = "--" + field.name.replace("_", "-")
        tp, is_optional = _unwrap_optional(hints.get(field.name, field.type))
        origin = typing.get_origin(tp)

        if field.name in yaml_defaults:
            default = yaml_defaults[field.name]
        elif field.default is not dataclasses.MISSING:
            default = field.default
        elif field.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
            default = field.default_factory()  # type: ignore[misc]
        else:
            default = None

        if tp is bool:
            group = parser.add_mutually_exclusive_group()
            group.add_argument(flag, dest=field.name, action="store_true", default=default)
            group.add_argument(
                "--no-" + field.name.replace("_", "-"),
                dest=field.name,
                action="store_false",
            )
        elif origin in (list, tuple):
            elem_types = typing.get_args(tp)
            elem = _base_parser(elem_types[0] if elem_types else str)
            parser.add_argument(flag, dest=field.name, nargs="*", type=elem, default=default)
        else:
            caster = _base_parser(tp)

            def _cast(value: str, caster=caster, is_optional=is_optional):
                if is_optional and value.lower() in ("none", "null"):
                    return None
                return caster(value)

            parser.add_argument(flag, dest=field.name, type=_cast, default=default)

    ns = parser.parse_args(args)
    kwargs = {}
    for field in dataclasses.fields(cls):
        if not field.init:
            continue
        value = getattr(ns, field.name)
        tp, _ = _unwrap_optional(hints.get(field.name, field.type))
        if typing.get_origin(tp) is tuple and isinstance(value, list):
            value = tuple(value)
        kwargs[field.name] = value
    return cls(**kwargs)
