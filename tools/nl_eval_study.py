#!/usr/bin/env python3
"""What one evaluation of a large AMPL model costs the port: registry keys
transcribed by tools/torch_to_nl.py, then read with uno_tpu_torch.io.read_nl
and evaluated once each, f, c, the gradient, the constraint Jacobian and
the Lagrangian's Hessian, at x0.

    python3 tools/nl_eval_study.py [--device cuda|cpu] [--keys a,b] [--out F]

The port replays a file's postfix program as eager torch operations on
every evaluation (io/nl.py), so the times grow with the file.  Each
evaluation is timed once, f after one untimed call, the others as the
first of their kind (after f's): between CUDA events on the card, by the
host's clock on the CPU; one that takes more than --cap seconds (120) is
stopped and left unmeasured.  The transcription and the read are timed by
the host's clock.  The default keys are chandheq_ls_n100 (606 KB) and
trigmgh_n300 (1.6 MB).  Prints the card's name and power limit first, then
one JSON object per key.  Imports torch, numpy and uno_tpu_torch only.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
KEYS = ("chandheq_ls_n100", "trigmgh_n300")


class _Over(Exception):
    pass


def _alarm(signum, frame):
    raise _Over()


def _timed(fn, device, warm):
    """(ms of one call, its result), after one untimed call if `warm`."""
    if warm:
        fn()
    if device == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), out
    t0 = time.perf_counter()
    out = fn()
    return (time.perf_counter() - t0) * 1e3, out


def study(key, device, tmp, t2n, cap):
    from uno_tpu_torch.io import read_nl
    t0 = time.perf_counter()
    manifest = t2n.transcribe([key], tmp, resume=False, log=None)
    transcribe_s = time.perf_counter() - t0
    if manifest["problems"][key]["status"] != "ok":
        raise RuntimeError(f"{key}: {manifest['problems'][key]}")
    path = Path(tmp) / f"{key}.nl"
    t0 = time.perf_counter()
    nlp = read_nl(path)
    read_s = time.perf_counter() - t0
    x = torch.as_tensor(nlp.x0, dtype=torch.float64, device=device)[None]
    y = torch.ones((1, nlp.m), dtype=torch.float64, device=device)
    s = torch.ones(1, dtype=torch.float64, device=device)
    row = {"key": key, "device": device, "n": nlp.n, "m": nlp.m,
           "file_bytes": path.stat().st_size, "transcribe_s": transcribe_s,
           "read_s": read_s}
    calls = {"f": lambda: nlp.objective(x), "c": lambda: nlp.constraints(x),
             "gradient": lambda: nlp.objective_gradient(x),
             "jacobian": lambda: nlp.constraint_jacobian(x),
             "hessian": lambda: nlp.lagrangian_hessian(x, y, s)}
    old = signal.signal(signal.SIGALRM, _alarm)
    try:
        for name, fn in calls.items():
            signal.alarm(cap)
            try:
                ms, out = _timed(fn, device, warm=name == "f")
                row[f"{name}_ms"] = ms
                row[f"{name}_finite"] = bool(torch.isfinite(out).all())
            except _Over:
                row[f"{name}_ms"] = None
                row[f"{name}_over_s"] = cap
                if device == "cuda":
                    torch.cuda.synchronize()
            finally:
                signal.alarm(0)
    finally:
        signal.signal(signal.SIGALRM, old)
    print(json.dumps(row), flush=True)
    return row


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--keys", default=",".join(KEYS))
    parser.add_argument("--cap", type=int, default=120,
                        help="seconds an evaluation may take before it is left unmeasured")
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    out = {}
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu")
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30, check=True).stdout.strip().splitlines()[0]
        print(card, flush=True)
        out["card"] = card
    spec = importlib.util.spec_from_file_location("torch_to_nl", REPO / "tools" / "torch_to_nl.py")
    t2n = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(t2n)
    with tempfile.TemporaryDirectory() as tmp:
        out["rows"] = [study(k, args.device, tmp, t2n, args.cap)
                       for k in args.keys.split(",")]
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
