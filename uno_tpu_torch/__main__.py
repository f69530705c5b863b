"""Command-line driver: the reference's `uno_ampl` equivalent
(bindings/AMPL/uno_ampl.cpp:81-141); counterpart of uno_tpu/__main__.py.

    python -m uno_tpu_torch model.nl [-AMPL] [preset=ipopt] [option_file=FILE]
                             [device=cuda|cpu] [key=value ...]

Options are applied in the reference's layering order: defaults <- option
file <- preset <- command-line key=value overrides.  `device` (default
cuda) is where the solve runs; it is not an option of the solver.  Writes
`model.sol` next to the input (AMPL solution-file convention).  Exits 0 on
a solved model, 1 otherwise, 2 on an unknown option.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path


def _parse_value(field_type, raw):
    if field_type is bool:
        return raw.lower() in ("yes", "true", "1")
    return field_type(raw)


def write_sol(path: Path, message: str, x, y):
    """Minimal AMPL .sol writer (text format)."""
    with open(path, "w") as f:
        f.write(message + "\n\n")
        f.write("Options\n3\n1\n1\n0\n")
        f.write(f"{len(y)}\n{len(y)}\n{len(x)}\n{len(x)}\n")
        for v in y:
            f.write(f"{v:.17g}\n")
        for v in x:
            f.write(f"{v:.17g}\n")


def layered_options(kv: dict):
    """The Options of the command line's key=value pairs `kv` (without the
    model and `device`), layered as the reference layers them
    (uno_ampl.cpp:110-131, Options.cpp:92-113): defaults <- option file <-
    preset <- command line.  Returns (options, the layered values).  An
    unknown option name exits with code 2."""
    from uno_tpu_torch.options import Options, preset_overrides

    kv = dict(kv)
    fields = {f.name for f in dataclasses.fields(Options)}
    defaults = Options()

    def typed(k, v):
        if k not in fields:
            print(f"unknown option {k!r}", file=sys.stderr)
            raise SystemExit(2)
        return _parse_value(type(getattr(defaults, k)), v)

    layered = {}
    option_file = kv.pop("option_file", None)
    if option_file:
        # whitespace-separated "name value" lines, '#' comment lines
        for line in Path(option_file).read_text().splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) >= 2:
                layered[parts[0]] = typed(parts[0], parts[1])
    preset_name = kv.pop("preset", None)
    if preset_name:
        layered.update(preset_overrides(preset_name))
    for k, v in kv.items():
        layered[k] = typed(k, v)
    opts = defaults.replace(**layered)
    if opts.logger == "SILENT":
        opts = opts.replace(logger="INFO")
    return opts, layered


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        from uno_tpu_torch.options import available_presets
        print("presets:", ", ".join(available_presets()))
        return 0

    nl_path = Path(argv[0])
    kv = {}
    for arg in argv[1:]:
        if arg == "-AMPL":
            continue
        if "=" not in arg:
            print(f"ignoring argument {arg!r} (expected key=value)", file=sys.stderr)
            continue
        k, v = arg.split("=", 1)
        kv[k] = v
    device = kv.pop("device", "cuda")

    import uno_tpu_torch
    from uno_tpu_torch.io import read_nl
    from uno_tpu_torch.options import Options

    opts, layered = layered_options(kv)
    nlp = read_nl(nl_path)
    res = uno_tpu_torch.solve(nlp, options=opts, device=device)

    # reference Options::print_used (Options.cpp:122-134)
    defaults = Options()
    overwritten = {k: v for k, v in layered.items() if getattr(defaults, k) != v}
    if overwritten:
        print("\nUsed overwritten options:")
        for k, v in sorted(overwritten.items()):
            print(f"- {k} = {v}")

    print(f"\nuno_tpu_torch {uno_tpu_torch.__version__} on {device}")
    print("─" * 40)
    print(f"status:           {res.status}")
    print(f"objective:        {res.objective:.12g}")
    print(f"iterations:       {res.iterations}")
    print(f"primal feas:      {res.primal_feasibility:.2e}")
    print(f"stationarity:     {res.stationarity:.2e}")
    print(f"complementarity:  {res.complementarity:.2e}")
    print(f"cpu time:         {res.cpu_time:.3f}s")
    if opts.print_solution:
        print("primal solution: ", res.x)
        print("constraint duals:", res.y)

    sol_path = nl_path.with_suffix(".sol")
    write_sol(sol_path, f"uno_tpu_torch {uno_tpu_torch.__version__}: {res.status}",
              res.x, res.y)
    print(f"solution written to {sol_path}")
    return 0 if res.success else 1


if __name__ == "__main__":
    raise SystemExit(main())
