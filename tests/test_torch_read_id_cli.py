"""The port's read classifier CLI (colorid_tpu_torch.cli.main read_id /
batch_id / read_filter, --device cpu) against the JAX package's: the
_reads.txt and _counts.txt files, batch_id's per-sample files and
read_filter's fastq.gz outputs must be byte-identical.

The read mix (tests/torch_support.py::read_mix) holds junk, chimeras,
absent k-mers early and late in a read, N and low-quality bases, first
mates shorter than k, lowercase stretches and exact duplicates; genome 3
carries a copy of a stretch of genome 0, so reads from there tie. Indexes:
classic, --blocked (v4) and a minimizer .mxi (the host kmer_set route).
Flags and routes: the defaults, -d 2, -B 0, -c 200 (several batches), -p
1.0, and COLORID_RID_SAFE=0 / COLORID_RID_READS=0 / COLORID_FNV_ORDER=0."""

import contextlib
import gzip
import io
import os

import pytest

from colorid_tpu.cli import main as jmain
from colorid_tpu_torch.cli import main as tmain
from tests import torch_support as ts

K = 27
N_PAIRS = 600


def _quiet(main, argv):
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        main(argv)


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """A 4-genome panel whose genome 3 shares 20 kbp with genome 0, the
    read mix as paired and single-end files, and one index per layout
    built by the JAX CLI (both packages read the same files)."""
    d = tmp_path_factory.mktemp("rid")
    gs = ts.genomes(4, 50_000, seed=21)
    gs[3][5000:25000] = gs[0][5000:25000]
    man, _refs = ts.write_panel(d, gs)
    r1, r2 = ts.write_pairs(d, ts.read_mix(gs, N_PAIRS, seed=22))
    idx = {}
    for name, extra in (("classic", []), ("blocked", ["--blocked"]), ("mini", ["-m"])):
        prefix = str(d / name)
        _quiet(jmain, ["build", "-k", str(K), "-n", "4", "-s", "375000",
                       "-b", prefix, "-r", man] + extra)
        idx[name] = prefix + (".mxi" if name == "mini" else ".bxi")
    return {"dir": d, "r1": r1, "r2": r2, "idx": idx, "man": man}


def _read_id_bytes(main, argv, prefix):
    _quiet(main, argv + ["-n", prefix])
    with open(prefix + "_reads.txt", "rb") as f, open(prefix + "_counts.txt", "rb") as g:
        return f.read(), g.read()


def _both(panel, tag, argv, env, monkeypatch):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    d = panel["dir"]
    want = _read_id_bytes(jmain, argv, str(d / f"j_{tag}"))
    got = _read_id_bytes(tmain, argv + ["--device", "cpu"], str(d / f"t_{tag}"))
    return want, got


CASES = [
    # (index, paired, flags, env)
    ("classic", True, [], {}),
    ("classic", False, [], {}),
    ("classic", True, ["-d", "2"], {}),
    ("classic", True, ["-B", "0"], {}),
    ("classic", True, ["-c", "200"], {}),
    ("classic", True, ["-p", "1.0"], {}),
    ("classic", True, [], {"COLORID_RID_SAFE": "0"}),
    ("classic", True, [], {"COLORID_RID_READS": "0"}),
    ("classic", True, ["-B", "0"], {"COLORID_RID_READS": "0"}),
    ("classic", True, [], {"COLORID_FNV_ORDER": "0"}),
    ("blocked", True, [], {}),
    ("blocked", False, ["-B", "0"], {}),
    ("blocked", True, ["-c", "200"], {"COLORID_RID_SAFE": "0"}),
    ("blocked", True, [], {"COLORID_RID_READS": "0"}),
    ("mini", True, [], {}),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    [c[0], "pe" if c[1] else "se"] + c[2] + [f"{k[8:]}={v}" for k, v in c[3].items()]))
def test_read_id_files_match_jax(panel, monkeypatch, case):
    name, paired, flags, env = case
    files = [panel["r1"], panel["r2"]] if paired else [panel["r1"]]
    argv = ["read_id", "-b", panel["idx"][name], "-q", *files, "-t", "2"] + flags
    tag = f"{name}{int(paired)}{''.join(flags)}{''.join(env)}"
    (want_reads, want_counts), (reads, counts) = _both(panel, tag, argv, env, monkeypatch)
    assert reads == want_reads
    assert counts == want_counts
    rows = want_reads.decode().splitlines()
    assert len(rows) == N_PAIRS
    calls = [r.split("\t")[1] for r in rows]
    assert "too_short" in calls and "no_significant_hits" in calls
    if not flags and not env and name != "mini":
        # the mix reaches the tie fixup: reads from the shared stretch
        assert any("," in c for c in calls)


def test_batch_id_matches_jax(panel, tmp_path):
    man = tmp_path / "samples.txt"
    man.write_text(f"s1\t{panel['r1']}\t{panel['r2']}\ns2\t{panel['r1']}\n")
    outs = {}
    for who, main, extra in (("j", jmain, []), ("t", tmain, ["--device", "cpu"])):
        run = tmp_path / who
        run.mkdir()
        cwd = os.getcwd()
        os.chdir(run)
        try:
            _quiet(main, ["batch_id", "-b", panel["idx"]["classic"], "-q", str(man),
                          "-T", "tag", "-c", "250"] + extra)
        finally:
            os.chdir(cwd)
        outs[who] = {p.name: p.read_bytes() for p in sorted(run.iterdir())}
    assert sorted(outs["t"]) == ["s1_tag_counts.txt", "s1_tag_reads.txt",
                                 "s2_tag_counts.txt", "s2_tag_reads.txt"]
    assert outs["t"] == outs["j"]


def _records(path):
    with gzip.open(path, "rt") as f:
        lines = f.read().splitlines()
    return [lines[i : i + 4] for i in range(0, len(lines), 4)]


@pytest.mark.parametrize("paired", [True, False])
@pytest.mark.parametrize("exclude", [False, True])
def test_read_filter_matches_jax(panel, tmp_path, paired, exclude):
    reads = panel["dir"] / "filter_src"
    if not os.path.exists(str(reads) + "_reads.txt"):
        _quiet(tmain, ["read_id", "-b", panel["idx"]["classic"], "-q", panel["r1"],
                       panel["r2"], "-n", str(reads), "--device", "cpu"])
    files = [panel["r1"], panel["r2"]] if paired else [panel["r1"]]
    argv = ["read_filter", "-c", str(reads) + "_reads.txt", "-f", *files,
            "-t", "genome1"] + (["-e"] if exclude else []) + ["-p"]
    _quiet(jmain, argv + [str(tmp_path / "j")])
    _quiet(tmain, argv + [str(tmp_path / "t")])
    names = ["_genome1_R1.fq.gz", "_genome1_R2.fq.gz"] if paired else ["_genome1.fq.gz"]
    for suffix in names:
        want = _records(str(tmp_path / "j") + suffix)
        assert _records(str(tmp_path / "t") + suffix) == want
    # the records written are the _reads.txt rows that name genome1
    with open(str(reads) + "_reads.txt") as f:
        hit = {l.split("\t")[0].split(" ")[0] for l in f if "genome1" in l.split("\t")[1]}
    ids = {r[0].split(" ")[0] for r in _records(str(tmp_path / "t") + names[0])}
    assert ids == ({f"@pair{j}" for j in range(N_PAIRS)} - hit if exclude else hit)
    assert hit
