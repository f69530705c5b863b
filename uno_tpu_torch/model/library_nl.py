"""The AMPL `.nl` fixtures of tests/fixtures/nl as problems of the
registry: `nl_<stem>` for each text-format `<stem>.nl` (the `.bin.nl`
twins hold the same models), read with io/nl.read_nl.

Counterpart of uno_tpu/model/library_nl.py: a fixture that mirrors an
analytic problem or a family instance inherits its registered optimum.
"""

from __future__ import annotations

import re
from pathlib import Path

from uno_tpu_torch.model import library_cutest
from uno_tpu_torch.model.library import _REGISTRY, register

FIXTURE_DIR = Path(__file__).resolve().parent.parent.parent / "tests" / "fixtures" / "nl"


def _fixture_f_star(stem: str):
    if stem in _REGISTRY:
        return _REGISTRY[stem][1]
    m = re.match(r"(.+)_n(\d+)$", stem)
    if m and m.group(1) in library_cutest._FAMILIES:
        fs = library_cutest._FAMILIES[m.group(1)][1]
        return fs(int(m.group(2))) if callable(fs) else fs
    return None


def _register_fixtures():
    for path in sorted(FIXTURE_DIR.glob("*.nl")):
        if path.name.endswith(".bin.nl"):
            continue
        stem = path.name[:-3]

        def build(path=path, stem=stem):
            from uno_tpu_torch.io.nl import read_nl
            return read_nl(path, name=f"nl_{stem}")

        register(f"nl_{stem}", f_star=_fixture_f_star(stem))(build)


# (nothing registers where the fixtures are not checked out)
_register_fixtures()
