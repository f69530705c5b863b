"""The AMPL `.nl` fixtures of tests/fixtures/nl as problems of the port's
`get_problem`: `nl_<stem>` for each text-format `<stem>.nl` (the `.bin.nl`
twins hold the same models), read with io/nl.read_nl.

Counterpart of uno_tpu/model/library_nl.py, without the known optima.
"""

from __future__ import annotations

from functools import partial
from pathlib import Path

FIXTURE_DIR = Path(__file__).resolve().parent.parent.parent / "tests" / "fixtures" / "nl"


def _read(path: Path, name: str):
    from uno_tpu_torch.io.nl import read_nl
    return read_nl(path, name=name)


# name -> reader (an empty table where the fixtures are not checked out)
NL_FIXTURES = {
    f"nl_{path.name[:-3]}": partial(_read, path, f"nl_{path.name[:-3]}")
    for path in sorted(FIXTURE_DIR.glob("*.nl")) if not path.name.endswith(".bin.nl")
}
