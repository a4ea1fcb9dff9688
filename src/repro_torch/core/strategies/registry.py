"""Decorator registry for multiplexing / demultiplexing strategies.

Strategies register under the name used in ``MuxConfig.strategy`` /
``MuxConfig.demux``; registration stores a singleton instance (strategies
are stateless; parameters live in the module their ``init`` returns).
"""
from __future__ import annotations

from typing import Callable, TypeVar

T = TypeVar("T", bound=type)

_MUX: dict[str, object] = {}
_DEMUX: dict[str, object] = {}


def _register(table: dict, kind: str, name: str) -> Callable[[T], T]:
    def deco(cls: T) -> T:
        if name in table:
            raise ValueError(
                f"{kind} strategy {name!r} already registered "
                f"({type(table[name]).__name__}); unregister_{kind} first "
                f"to replace it")
        cls.name = name
        table[name] = cls()
        return cls
    return deco


def register_mux(name: str) -> Callable[[T], T]:
    """Class decorator: register a MuxStrategy subclass under ``name``."""
    return _register(_MUX, "mux", name)


def register_demux(name: str) -> Callable[[T], T]:
    """Class decorator: register a DemuxStrategy subclass under ``name``."""
    return _register(_DEMUX, "demux", name)


def get_mux(name: str):
    try:
        return _MUX[name]
    except KeyError:
        raise ValueError(
            f"unknown mux strategy {name!r}; registered: "
            f"{list_mux_strategies()}") from None


def get_demux(name: str):
    try:
        return _DEMUX[name]
    except KeyError:
        raise ValueError(
            f"unknown demux strategy {name!r}; registered: "
            f"{list_demux_strategies()}") from None


def list_mux_strategies() -> list[str]:
    return sorted(_MUX)


def list_demux_strategies() -> list[str]:
    return sorted(_DEMUX)


def unregister_mux(name: str) -> None:
    _MUX.pop(name, None)


def unregister_demux(name: str) -> None:
    _DEMUX.pop(name, None)
