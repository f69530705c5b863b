"""Iteration statistics table (reference tools/Statistics.cpp): ordered
registered columns rendered with unicode box art, one line per iteration."""

from __future__ import annotations

from typing import Optional


class Statistics:
    INT_WIDTH = 8
    DOUBLE_WIDTH = 17
    STRING_WIDTH = 26

    def __init__(self, print_header_every: int = 15):
        self._columns: list[tuple[int, str, int]] = []  # (order, name, width)
        self._current: dict = {}
        self._lines_since_header = 0
        self._print_header_every = print_header_every

    def add_column(self, name: str, width: int, order: int):
        if all(c[1] != name for c in self._columns):
            self._columns.append((order, name, width))
            self._columns.sort(key=lambda c: c[0])

    def start_new_line(self):
        self._current = {}

    def set(self, name: str, value):
        self._current[name] = value

    def _fmt(self, name, width):
        v = self._current.get(name, "")
        if isinstance(v, float):
            s = f"{v:.4e}"
        else:
            s = str(v)
        if len(s) > width - 1:
            s = s[: width - 1]
        return " " + s.ljust(width - 1)

    def header(self) -> str:
        names = [name for _, name, _ in self._columns]
        widths = [w for _, _, w in self._columns]
        top = "┌" + "┬".join("─" * w for w in widths) + "┐"
        mid = "│" + "│".join(" " + n.ljust(w - 1)[: w - 1] for n, w in zip(names, widths)) + "│"
        bot = "├" + "┼".join("─" * w for w in widths) + "┤"
        return "\n".join([top, mid, bot])

    def line(self) -> str:
        return "│" + "│".join(self._fmt(name, w) for _, name, w in self._columns) + "│"

    def footer(self) -> str:
        widths = [w for _, _, w in self._columns]
        return "└" + "┴".join("─" * w for w in widths) + "┘"

    def print_current_line(self, printer=print):
        if self._lines_since_header % self._print_header_every == 0:
            printer(self.header())
        printer(self.line())
        self._lines_since_header += 1

    def print_footer(self, printer=print):
        printer(self.footer())
