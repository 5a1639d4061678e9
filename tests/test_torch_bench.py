"""The port's bench (colorid_tpu_torch/bench.py) on the CPU, at a tiny cell.

A cold-cache subprocess run of ``python -m colorid_tpu_torch.bench --device
cpu`` must keep bench.py's JSON contract (one line, every rate measured,
the in-bench parity checks held); its stream, generic and classic
SearchResults must equal the JAX engine's on the same k-mers and index
files; chip_smoke.py must write its cell, and its cold-built indexes must
be the port CLI's; a cached index of another cell is refused; a fused
capacity trip must time the synchronous span; a parity mismatch or a failed phase exits 1 after the line, without
the rate at fault; without a card and without ``--device cpu`` it exits 2
with no number.
"""

import gzip
import json
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke as cs
from colorid_tpu.engine import QueryEngine as JEngine
from colorid_tpu.index.bigsi import BigsiIndex as JIndex
from colorid_tpu_torch import bench
from colorid_tpu_torch.engine import QueryEngine, SearchResult
from colorid_tpu_torch.index.bigsi import BigsiIndex
from colorid_tpu_torch.ops.stream_query import EPC_CL
from tests import torch_support as ts

# the tiny cell: 3 x 30 kbp genomes hold ~90k distinct 31-mers; a bloom of
# 3,906 blocks keeps ~23 probes a block, dense enough for both streams
CELL = dict(
    BENCH_MAX_GENOMES="3",
    BENCH_GENOME_LEN="30000",
    BENCH_BLOOM="499968",
    BENCH_N_READS="8000",
    BENCH_RID_READS="200",
    BENCH_FUSED_READS="4000",  # below BENCH_N_READS: the prefix cross-check runs
    BENCH_STREAM_DISPATCHES="1",
    BENCH_FUSED_DISPATCHES="2",
)
RATES = ("stream", "generic", "fused", "classic")


@pytest.fixture(scope="module")
def bench_run(tmp_path_factory):
    """One cold-cache run of the bench module on the CPU: (process, cache)."""
    cache = tmp_path_factory.mktemp("bench") / "cache"
    env = dict(os.environ, BENCH_CACHE_DIR=str(cache), OMP_NUM_THREADS="1", **CELL)
    proc = subprocess.run(
        [sys.executable, "-m", "colorid_tpu_torch.bench", "--device", "cpu"],
        cwd=ts.ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    return proc, cache


@pytest.fixture
def cell_env(monkeypatch, bench_run):
    for name, value in CELL.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setenv("BENCH_CACHE_DIR", str(bench_run[1]))


def _cell():
    genomes, reads = bench.synth_cell(bench.SEED, 3, 30_000, bench.N_SOURCES, 8000)
    return genomes, reads, *bench.make_query_kmers(reads)


def test_bench_cold_cache_cpu(bench_run):
    proc, cache = bench_run
    err = proc.stderr[-3000:]
    assert proc.returncode == 0, f"rc={proc.returncode}\n{proc.stdout}\n{err}"
    lines = [l for l in proc.stdout.splitlines() if l.strip()]
    assert len(lines) == 1, lines
    rec = json.loads(lines[0])
    assert rec["metric"] == "queried_kmers_per_s_1chip" and rec["unit"] == "kmers/s"
    assert rec["device"] == "cpu"
    assert "parity" not in rec
    assert all(rec[f"{k}_kmers_per_s"] > 0 for k in RATES), rec
    assert rec["read_id_pairs_per_s"] > 0
    assert rec["value"] == max(rec[f"{k}_kmers_per_s"] for k in RATES)
    assert rec["vs_baseline"] == round(rec["value"] / 4e6, 3)
    assert "parity check: stream and generic SearchResults identical" in proc.stderr, err
    assert "parity check: fused prefix SearchResult matches the stream path" in proc.stderr, err
    assert "parity check: classic stream and generic SearchResults identical" in proc.stderr, err
    assert "PARITY MISMATCH" not in proc.stderr
    # the classic generic gather pads to classic_P, its stream only to EPC_CL
    n = int(re.search(r"query: (\d+) filtered k-mers", proc.stderr).group(1))
    classic = [l for l in proc.stderr.splitlines() if l.startswith("[classic] ")]
    assert f"k-mers ({bench.classic_P(n, 1 << 20)} slots)" in classic[0], classic
    assert f"k-mers ({-(-n // EPC_CL) * EPC_CL} slots)" in classic[1], classic
    assert "fused route timed: queued single fused dispatches" in proc.stderr
    assert "[launches] " in proc.stderr
    assert sorted(os.listdir(cache)) == sorted([
        "bench50M.bxi", "bench50M.bxi.cell.json", "bench50M_blocked.bxi",
        "bench50M_blocked.bxi.cell.json", "genomes", "rid_out_counts.txt",
        "rid_out_reads.txt", "rid_r1.fq.gz", "rid_r2.fq.gz",
    ])
    for name, blocked in (("bench50M.bxi", False), ("bench50M_blocked.bxi", True)):
        stamp = json.loads((cache / (name + ".cell.json")).read_text())
        assert stamp == bench.cell_stamp(blocked, 3, 30_000, 499_968)


def _same(a, b) -> bool:
    return (
        np.array_equal(np.asarray(a.counts), np.asarray(b.counts))
        and bool(a.all_valid) == bool(b.all_valid)
        and np.array_equal(np.asarray(a.and_all), np.asarray(b.and_all))
        and a.freq_stats() == b.freq_stats()
    )


def test_bench_results_equal_the_jax_engine(cell_env, monkeypatch, bench_run):
    """stream, generic and classic SearchResults of the bench's phases
    against the JAX engine's search_keys (generic gather) on the same
    k-mers and the same index files; integers compared exactly."""
    monkeypatch.setattr(bench, "_trials", lambda name, fn, n, budget: 1.0)
    genomes, _reads, keys, qcounts, packed, _rp = _cell()
    assert keys.shape[0] == packed.shape[0] == qcounts.shape[0] > 50_000
    cache = bench_run[1]
    blocked = QueryEngine(BigsiIndex.load(str(cache / "bench50M_blocked.bxi")),
                          chunk=1 << 21, device="cpu")
    _, stream = bench.phase_stream(blocked, keys, qcounts, packed)
    _, generic = bench.phase_generic(blocked, keys, qcounts, packed)
    _, classic, same = bench.phase_classic(keys, qcounts, packed, genomes, "cpu")
    assert same
    for name, ours in (("bench50M_blocked.bxi", (stream, generic)),
                       ("bench50M.bxi", (classic["generic"], classic["stream"]))):
        jeng = JEngine(JIndex.load(str(cache / name)))
        jeng._stream = jeng._stream_classic = False  # no Pallas interpret compile
        want = jeng.search_keys(keys, qcounts=qcounts, packed_all=packed, k=bench.K)
        assert int(np.asarray(want.counts).sum()) > 0
        for res in ours:
            assert _same(res, want), name


@pytest.mark.parametrize("genome_len", [4000, 4001])
def test_synth_cell_is_chip_smokes_cell(tmp_path, monkeypatch, genome_len):
    """chip_smoke.synth_inputs writes bench.synth_cell's cell: each fasta
    reads back as its genome (4001: a last line shorter than 80), the
    manifest names them in order, the FASTQ holds the reads in order."""
    for name, value in (("N_GENOMES", 4), ("GENOME_LEN", genome_len), ("N_SOURCES", 2),
                        ("N_READS", 300)):
        monkeypatch.setattr(cs, name, value)
    man, fq, sources = cs.synth_inputs(str(tmp_path))
    genomes, reads = bench.synth_cell(cs.SEED, 4, genome_len, 2, 300)
    with open(man) as f:
        rows = [line.rstrip("\n").split("\t") for line in f]
    assert [r[0] for r in rows] == [f"genome{i:02d}" for i in range(4)]
    for (_name, path), g in zip(rows, genomes):
        assert np.array_equal(cs._genome(path), g)
    with gzip.open(fq, "rt") as f:
        seqs = f.read().splitlines()[1::4]
    assert [s.encode() for s in seqs] == [r.tobytes() for r in reads]
    assert sources == ["genome00", "genome01"]


@pytest.mark.parametrize("other", ["genome_len", "n_genomes", "bloom", "no_stamp"])
def test_cached_index_of_another_cell_is_refused(tmp_path, monkeypatch, bench_run, other):
    """A cached index loads only beside a stamp of this very cell."""
    for name in ("bench50M.bxi", "bench50M.bxi.cell.json"):
        (tmp_path / name).write_bytes((bench_run[1] / name).read_bytes())
    if other == "no_stamp":
        (tmp_path / "bench50M.bxi.cell.json").unlink()
    monkeypatch.setenv("BENCH_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("BENCH_BLOOM", "500000" if other == "bloom" else CELL["BENCH_BLOOM"])
    n, L = {"genome_len": (3, 29_999), "n_genomes": (4, 30_000)}.get(other, (3, 30_000))
    with pytest.raises(ValueError, match="not this cell"):
        bench.build_or_load_index(False, [np.zeros(L, dtype=np.uint8)] * n)
    monkeypatch.setenv("BENCH_BLOOM", CELL["BENCH_BLOOM"])
    if other != "no_stamp":  # the right cell loads from the same cache
        index = bench.build_or_load_index(False, [np.zeros(30_000, dtype=np.uint8)] * 3)
        assert index.bloom_size == 499_968 and index.n_colors == 3


def test_bench_index_is_the_cli_build(tmp_path, monkeypatch, bench_run):
    """The bench's cold-built .bxi files equal CLI build's of chip_smoke's
    cell, run as its [main] phase runs it (so chip_smoke can hand over its
    indexes)."""
    for name, value in (("N_GENOMES", 3), ("GENOME_LEN", 30_000), ("N_READS", 8000),
                        ("BLOOM", 499_968)):
        monkeypatch.setattr(cs, name, value)
    man, _fq, _src = cs.synth_inputs(str(tmp_path))
    for flags, name in (([], "bench50M.bxi"), (["--blocked"], "bench50M_blocked.bxi")):
        prefix = str(tmp_path / name.split(".")[0])
        cs.cli(["build", *flags, "-k", str(cs.K), "-n", str(cs.HASHES), "-s", str(cs.BLOOM),
                "-b", prefix, "-r", man, "-t", "8"])
        assert (bench_run[1] / name).read_bytes() == open(prefix + ".bxi", "rb").read(), name


def test_fused_capacity_trip_times_the_synchronous_span(cell_env, monkeypatch, bench_run,
                                                        capsys):
    monkeypatch.setattr(QueryEngine, "search_reads_fused_finish", lambda self, *a: None)
    _genomes, _reads, keys, _qc, _packed, reads_packed = _cell()
    engine = QueryEngine(BigsiIndex.load(str(bench_run[1] / "bench50M_blocked.bxi")),
                         chunk=1 << 21, device="cpu")
    value, full, prefix_same = bench.phase_fused(engine, keys, reads_packed, 0)
    err = capsys.readouterr().err
    assert value > 0 and full is None and prefix_same, err
    assert "fused route timed: synchronous search_reads" in err
    assert "route: synchronous search_reads" in err and "reads trial 0" in err


def _stub_result(hits: int) -> SearchResult:
    none = np.zeros(0, dtype=np.int32)
    return SearchResult(np.array([hits, 0, 0]), True, np.zeros(1, dtype=np.uint32),
                        np.zeros((3, 4), dtype=np.int64), none, none)


def _raise(*_a):
    raise RuntimeError("phase broke")


@pytest.mark.parametrize("case", ["clean", "stream", "classic", "fused_mismatch", "fused_full",
                                  "raises"])
def test_main_reports_parity_and_failed_phases(cell_env, monkeypatch, capsys, case):
    """No fallback: a parity mismatch names itself under parity and leaves
    the mismatched rate out; a phase that raises leaves its rate out; both
    exit 1 after the one line. The phases are stubs here (the glue only)."""
    stubs = {
        "phase_stream": lambda *a: (4e6, _stub_result(1)),
        "phase_generic": lambda *a: (1e6, _stub_result(1)),
        "phase_fused": lambda *a: (3e6, None, True),
        "phase_classic": lambda *a: (2e6, {}, True),
        "phase_read_id": lambda *a: 500.0,
    }
    if case == "stream":
        stubs["phase_generic"] = lambda *a: (1e6, _stub_result(2))
    elif case == "classic":
        stubs["phase_classic"] = lambda *a: (2e6, {}, False)
    elif case == "fused_mismatch":
        stubs["phase_fused"] = lambda *a: (3e6, None, False)
    elif case == "fused_full":
        stubs["phase_fused"] = lambda *a: (3e6, _stub_result(2), None)
    elif case == "raises":
        stubs["phase_generic"] = _raise
    for name, fn in stubs.items():
        monkeypatch.setattr(bench, name, fn)
    rc = bench.main(["--device", "cpu"])
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1, out
    rec = json.loads(lines[0])
    assert rc == (0 if case == "clean" else 1), err
    assert rec["value"] == (3_000_000 if case == "stream" else 4_000_000)
    assert rec["device"] == "cpu"
    assert rec.get("parity") == (None if case in ("clean", "raises") else case)
    assert ("stream_kmers_per_s" in rec) == (case != "stream")
    assert ("fused_kmers_per_s" in rec) == (not case.startswith("fused"))
    assert ("generic_kmers_per_s" in rec) == (case != "raises")
    assert rec["classic_kmers_per_s"] == 2_000_000  # the generic gather's rate stays
    if case == "raises":
        assert "generic phase failed" in err and "phase broke" in err


@pytest.mark.parametrize("chunk", [1000, EPC_CL // 2, EPC_CL, 3 * EPC_CL, 1 << 20])
def test_classic_P_is_a_multiple_of_chunk_and_EPC_CL(chunk):
    for n in (1, 90_256, EPC_CL, 8_558_315):
        P = bench.classic_P(n, chunk)
        assert P % EPC_CL == 0 and P % chunk == 0 and n <= P < n + math.lcm(chunk, EPC_CL)


def test_no_card_exits_2_without_a_number(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the default run is the full bench")
    proc = subprocess.run(
        [sys.executable, "-m", "colorid_tpu_torch.bench"], cwd=ts.ROOT,
        env=dict(os.environ, BENCH_CACHE_DIR=str(tmp_path)), capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "no CUDA card" in proc.stderr
    assert os.listdir(tmp_path) == []
