"""Leveled per-component logger.

Replaces the reference's macro logger + properties-file configuration
(utils/logger/logger.hpp:161, log_writers.hpp, configs/debruijn/
log.properties): each component gets its own severity threshold, lines
fan out to attached writers (console, file), and thresholds come from a
properties file or programmatic configuration.

Properties format (same shape as the reference's log.properties):

    default=INFO
    Simplification=DEBUG
    ChromosomeRemover=TRACE
    ; comments with ';' or '#'
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

TRACE, DEBUG, INFO, WARN, ERROR = 0, 1, 2, 3, 4
_NAMES = {"trace": TRACE, "debug": DEBUG, "info": INFO,
          "warn": WARN, "warning": WARN, "error": ERROR}
_LABELS = {TRACE: "TRACE", DEBUG: "DEBUG", INFO: "INFO",
           WARN: "WARN", ERROR: "ERROR"}


def parse_level(name: str) -> int:
    try:
        return _NAMES[name.strip().lower()]
    except KeyError:
        raise ValueError(f"unknown log level {name!r}") from None


class _Config:
    def __init__(self):
        self.default = INFO
        self.thresholds: dict[str, int] = {}
        self.writers: list = [lambda line: print(line, file=sys.stderr)]

    def threshold(self, component: str) -> int:
        return self.thresholds.get(component, self.default)


_config = _Config()


def configure(properties_path: str | None = None,
              default: str | int | None = None,
              writers: list | None = None) -> None:
    """(Re)configure global logging.

    ``properties_path`` — log.properties-style file; ``default`` —
    fallback level; ``writers`` — callables taking one formatted line
    (replacing the reference's console/file log_writers.hpp).
    The SPADES_TPU_LOG env var ("LEVEL" or "Comp=LEVEL,Comp2=LEVEL")
    overlays both, mirroring how the reference lets run configs override
    the shipped properties file.
    """
    cfg = _Config()
    if default is not None:
        cfg.default = (default if isinstance(default, int)
                       else parse_level(default))
    if properties_path and os.path.exists(properties_path):
        with open(properties_path) as f:
            for raw in f:
                line = raw.split(";")[0].split("#")[0].strip()
                if not line or "=" not in line:
                    continue
                key, val = (s.strip() for s in line.split("=", 1))
                if key.lower() == "default":
                    cfg.default = parse_level(val)
                else:
                    cfg.thresholds[key] = parse_level(val)
    env = os.environ.get("SPADES_TPU_LOG", "")
    for part in filter(None, (p.strip() for p in env.split(","))):
        if "=" in part:
            key, val = (s.strip() for s in part.split("=", 1))
            cfg.thresholds[key] = parse_level(val)
        else:
            cfg.default = parse_level(part)
    if writers is not None:
        cfg.writers = list(writers)
    global _config
    _config = cfg


@contextlib.contextmanager
def configured(**kwargs):
    """``configure(**kwargs)`` for the length of a ``with`` block: the
    configuration found at its start comes back at its end, so a writer
    on a file the block closes does not outlive the file."""
    global _config
    saved = _config
    configure(**kwargs)
    try:
        yield
    finally:
        _config = saved


def add_writer(writer) -> None:
    _config.writers.append(writer)


class Logger:
    """Per-component logger handle (DECL_LOGGER equivalent)."""

    def __init__(self, component: str):
        self.component = component

    def enabled(self, level: int) -> bool:
        return level >= _config.threshold(self.component)

    def log(self, level: int, msg: str) -> None:
        if not self.enabled(level):
            return
        line = (f"{time.strftime('%H:%M:%S')} {_LABELS[level]:>5} "
                f"[{self.component}] {msg}")
        for w in _config.writers:
            w(line)

    def trace(self, msg: str) -> None:
        self.log(TRACE, msg)

    def debug(self, msg: str) -> None:
        self.log(DEBUG, msg)

    def info(self, msg: str) -> None:
        self.log(INFO, msg)

    def warn(self, msg: str) -> None:
        self.log(WARN, msg)

    def error(self, msg: str) -> None:
        self.log(ERROR, msg)


def get_logger(component: str) -> Logger:
    return Logger(component)
