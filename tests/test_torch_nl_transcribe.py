"""The port's AMPL transcriber (tools/torch_to_nl.py) and fixture generator
(tools/gen_nl_fixtures_torch.py) against uno_tpu's: transcripts of registry
keys read by the port equal the committed corpus files read by uno_tpu,
their non-expression sections are the same text, the generator writes a
committed fixture byte for byte, and tests/fixtures/torch_nl_corpus_ref.json
(what chip_smoke.py's nl_corpus phase holds the card to) is uno_tpu's
reading of the committed files."""

import hashlib
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
CORPUS = REPO / "tests" / "fixtures" / "nl_corpus"
REF = REPO / "tests" / "fixtures" / "torch_nl_corpus_ref.json"
# of the 48 keys of the reference: some whose transcript is the committed
# file byte for byte, some whose expression trees differ (elec_n9, gulf,
# hs026, hs072: products and sums written in another order, clamp)
KEYS = ("beale", "brownal_n30", "elec_n9", "gulf", "hs026", "hs072",
        "polak5", "structqp_n10")


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sections(path):
    """The file's lines outside the C and O expression segments, in order."""
    keep, skip = [], False
    for line in Path(path).read_text().splitlines():
        if line[:1] in ("C", "O"):
            skip = True
            continue
        if line[:1] in ("x", "r", "b", "k", "J", "G", "d", "V"):
            skip = False
        if not skip:
            keep.append(line)
    return keep


@pytest.fixture(scope="module")
def ref():
    with open(REF) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def transcripts(tmp_path_factory):
    t2n = _tool("torch_to_nl")
    out = tmp_path_factory.mktemp("t2n")
    manifest = t2n.transcribe(list(KEYS), str(out), resume=False, log=None)
    return out, manifest


@pytest.mark.parametrize("key", KEYS)
def test_transcript_reads_as_the_committed_file(key, transcripts):
    from uno_tpu.io import read_nl as j_read_nl
    from uno_tpu_torch.io import read_nl as t_read_nl
    out, manifest = transcripts
    assert manifest["problems"][key]["status"] == "ok"
    path = out / f"{key}.nl"
    assert _sections(path) == _sections(CORPUS / f"{key}.nl")
    mine, theirs = t_read_nl(path), j_read_nl(str(CORPUS / f"{key}.nl"))
    rng = np.random.default_rng(0)
    x0 = np.asarray(theirs.x0, dtype=np.float64)
    for x in [x0] + [x0 + 0.1 * rng.standard_normal(x0.shape[0]) for _ in range(3)]:
        xt = torch.as_tensor(x)[None]
        f_t, f_j = float(mine.objective(xt)[0]), float(theirs.objective(jnp.asarray(x)))
        assert abs(f_t - f_j) <= 1e-12 * max(1.0, abs(f_j))
        if mine.m:
            c_t = mine.constraints(xt)[0].numpy()
            c_j = np.asarray(theirs.constraints(jnp.asarray(x)))
            assert np.all(np.abs(c_t - c_j) <= 1e-12 * np.maximum(1.0, np.abs(c_j)))


def test_manifest_schema(transcripts):
    out, manifest = transcripts
    on_disk = json.loads((out / "manifest.json").read_text())
    assert on_disk == json.loads(json.dumps(manifest))
    assert (on_disk["emitted"], on_disk["total"]) == (len(KEYS), len(KEYS))
    committed = json.loads((CORPUS / "manifest.json").read_text())["problems"]
    for key in KEYS:
        assert on_disk["problems"][key] == committed[key]


def test_unsupported_operator_is_reported(tmp_path):
    t2n = _tool("torch_to_nl")
    from uno_tpu_torch.model.nlp import nlp_from_functions
    nlp = nlp_from_functions("erf_key", lambda x: torch.special.erf(x[0]) + x[1] ** 2,
                             None, x0=[0.5, 0.5])
    with pytest.raises(t2n.Unsupported):
        t2n.nlp_to_nl(nlp, tmp_path / "erf_key.nl")


def test_fixture_generator_writes_a_committed_fixture(tmp_path):
    gen = _tool("gen_nl_fixtures_torch")
    stem = gen.write_fixture(str(tmp_path), "srosenbr", 10)
    for suffix in (".nl", ".bin.nl"):
        assert (tmp_path / f"{stem}{suffix}").read_bytes() == \
            (REPO / "tests" / "fixtures" / "nl" / f"{stem}{suffix}").read_bytes()


def test_reference_is_uno_tpus_reading_of_the_sample(ref):
    sample = _tool("nl_corpus_reference").sample_keys()
    assert ref["keys"] == sample and len(sample) == 48
    for key in sample:
        row = ref["rows"][key]
        assert row["sha256"] == hashlib.sha256((CORPUS / f"{key}.nl").read_bytes()).hexdigest()
        assert len(row["points"]) == len(row["f"]) == len(row["c"]) == 4
    from uno_tpu.io import read_nl
    for key in ("hs072", "woods_n28"):
        nlp = read_nl(str(CORPUS / f"{key}.nl"))
        row = ref["rows"][key]
        for x, f in zip(row["points"], row["f"]):
            assert float(nlp.objective(jnp.asarray(x))) == f
