"""Global leveled logger (reference tools/Logger.hpp:11-35, levels
SILENT..DEBUG3, stream-style global)."""

from __future__ import annotations

import sys

LEVELS = ["SILENT", "DISCRETE", "WARNING", "INFO", "DEBUG", "DEBUG2", "DEBUG3"]


class Logger:
    level: str = "SILENT"

    @classmethod
    def set_level(cls, level: str):
        if level not in LEVELS:
            raise ValueError(f"unknown log level {level!r}; choose from {LEVELS}")
        cls.level = level

    @classmethod
    def enabled(cls, level: str) -> bool:
        return LEVELS.index(cls.level) >= LEVELS.index(level)

    @classmethod
    def log(cls, level: str, *args, **kwargs):
        if cls.enabled(level):
            print(*args, **kwargs, file=sys.stdout)


def discrete(*args, **kw):
    Logger.log("DISCRETE", *args, **kw)


def warning(*args, **kw):
    Logger.log("WARNING", *args, **kw)


def info(*args, **kw):
    Logger.log("INFO", *args, **kw)


def debug(*args, **kw):
    Logger.log("DEBUG", *args, **kw)
