"""uno_tpu's readings and ipopt solves of a sample of the committed AMPL
corpus (tests/fixtures/nl_corpus), for chip_smoke.py's `nl_corpus` phase
and tests/test_torch_nl_transcribe.py to hold the port's transcripts
against on a machine without JAX or the corpus.

The sample: the manifest's keys with status "ok" and n + m <= 30, sorted,
every fifth (48 keys, 84 KB of files).  For each key the committed file is
read with uno_tpu.io.read_nl; the row records the file's sha256, f and c
at x0 and three seeded points (tools/torch_to_nl.py's check_points with
numpy's default_rng(0) for the key), and uno_tpu.solve(preset="ipopt",
max_iterations=2000) of the file's model: status, iterations, objective.

    JAX_PLATFORMS=cpu python3 tools/nl_corpus_reference.py [--jobs 4] \
        [--out tests/fixtures/torch_nl_corpus_ref.json]

`--time-jit KEY[,KEY] [--cap 300]` instead times uno_tpu's first
jax.jit(nlp.objective)(x0) of each committed nl_corpus/<KEY>.nl (trace,
compile and run, in a fresh process each), stopped at --cap seconds, and
prints one JSON object per key.
"""

import argparse
import hashlib
import json
import multiprocessing as mp
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

CORPUS = REPO / "tests" / "fixtures" / "nl_corpus"
DEFAULT_OUT = REPO / "tests" / "fixtures" / "torch_nl_corpus_ref.json"


def sample_keys(max_nm=30, every=5):
    """The manifest's "ok" keys with n + m <= max_nm, sorted, every fifth."""
    with open(CORPUS / "manifest.json") as fh:
        problems = json.load(fh)["problems"]
    ok = sorted(k for k, v in problems.items()
                if v["status"] == "ok" and v["n"] + v["m"] <= max_nm)
    return ok[::every]


def points(x0):
    """x0 and three seeded points: torch_to_nl.check_points for one key."""
    rng = np.random.default_rng(0)
    x0 = np.asarray(x0, dtype=np.float64)
    return [x0] + [x0 + 0.1 * rng.standard_normal(x0.shape[0]) for _ in range(3)]


def _setup_jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, str(REPO / "tests"))
    from conftest import _cpu_fingerprint
    jax.config.update("jax_compilation_cache_dir",
                      str(REPO / f".jax_cache_cpu_{_cpu_fingerprint()}"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def reference_one(key):
    _setup_jax()
    import jax.numpy as jnp

    import uno_tpu
    from uno_tpu.io import read_nl
    path = CORPUS / f"{key}.nl"
    nlp = read_nl(str(path))
    pts = points(nlp.x0)
    fs, cs = [], []
    for x in pts:
        xj = jnp.asarray(x)
        fs.append(float(nlp.objective(xj)))
        cs.append([float(v) for v in np.asarray(nlp.constraints(xj)).reshape(-1)] if nlp.m else [])
    res = uno_tpu.solve(nlp, preset="ipopt", max_iterations=2000)
    return key, {
        "sha256": hashlib.sha256(path.read_bytes()).hexdigest(),
        "n": int(nlp.n), "m": int(nlp.m),
        "points": [[float(v) for v in x] for x in pts],
        "f": fs, "c": cs,
        "status": str(res.status), "iterations": int(res.iterations),
        "objective": float(res.objective),
    }


_JIT_ONCE = """
import sys, time
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
sys.path.insert(0, sys.argv[2])
from uno_tpu.io import read_nl
nlp = read_nl(sys.argv[1])
t0 = time.perf_counter()
f = jax.jit(nlp.objective)(jnp.asarray(nlp.x0)).block_until_ready()
print(time.perf_counter() - t0, float(f))
"""


def time_jit(key, cap):
    """uno_tpu's first jitted objective of the committed file, in seconds,
    or None when it has not returned within `cap` seconds."""
    import subprocess
    path = CORPUS / f"{key}.nl"
    row = {"key": key, "file_bytes": path.stat().st_size, "cap_s": cap}
    try:
        run = subprocess.run([sys.executable, "-c", _JIT_ONCE, str(path), str(REPO)],
                             capture_output=True, text=True, timeout=cap, check=True)
        seconds, f = run.stdout.split()[-2:]
        row.update(jit_s=float(seconds), f=float(f))
    except subprocess.TimeoutExpired:
        row.update(jit_s=None, returned=False)
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--time-jit", default=None)
    ap.add_argument("--cap", type=float, default=300.0)
    args = ap.parse_args()
    if args.time_jit:
        for key in args.time_jit.split(","):
            print(json.dumps(time_jit(key, args.cap)), flush=True)
        return
    keys = sample_keys()
    print(f"{len(keys)} keys", flush=True)
    rows = {}
    with mp.get_context("spawn").Pool(args.jobs, maxtasksperchild=12) as pool:
        for k, (key, row) in enumerate(pool.imap_unordered(reference_one, keys)):
            rows[key] = row
            print(f"[{k + 1}/{len(keys)}] {key} {row['status']} {row['iterations']} "
                  f"{row['objective']:.10g}", flush=True)
    out = {"source": "uno_tpu.io.read_nl of tests/fixtures/nl_corpus/<key>.nl and "
                     "uno_tpu.solve(preset='ipopt', max_iterations=2000), JAX on the "
                     "CPU, tools/nl_corpus_reference.py",
           "keys": keys, "rows": rows}
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(f"wrote {args.out}: {len(rows)} keys")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main()
