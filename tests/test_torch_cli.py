"""The port's CLI (colorid_tpu_torch.cli.main, --device cpu) against the JAX
package's (colorid_tpu.cli.main): byte-identical stdout for build, inexact
search on a .fastq.gz (the JAX side both through its device k-mer counting
and, with COLORID_SEARCH_READS=0, through host counting), paired-end search,
perfect search (-s, -s -m), gene search (-g), info, and the read_id counts
file's row order (FnvHashMap emulation). Each package reads
the other's index files (CXI and reference bincode), and convert.py carries
an index and a JAX engine's block matrix across."""

import contextlib
import io
import os

import numpy as np
import pytest

from colorid_tpu.cli import main as jmain
from colorid_tpu.engine import QueryEngine as JEngine
from colorid_tpu.index.bigsi import BigsiIndex as JIndex
from colorid_tpu.index.bigsi import write_bxi as jwrite_bxi
from colorid_tpu.pipelines import reports as jreports
from colorid_tpu_torch import convert
from colorid_tpu_torch.cli import main as tmain
from colorid_tpu_torch.index.bigsi import BigsiIndex as TIndex
from colorid_tpu_torch.index.bigsi import write_bxi as twrite_bxi
from colorid_tpu_torch.pipelines import reports as treports
from tests import torch_support as ts

K = 27
BUILD = ["-k", str(K), "-n", "4", "-s", "375000"]


def _run(main, argv, capsys) -> str:
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """Four 50 kbp genomes, reads from two of them (single and paired
    end), one index built by each CLI."""
    d = tmp_path_factory.mktemp("cli")
    gs = ts.genomes(4, 50_000, seed=3)
    man, refs = ts.write_panel(d, gs)
    rs = ts.reads(gs[:2], 1200, 150, seed=4, sub_rate=0.005)
    files = {
        "dir": d,
        "man": man,
        "refs": refs,
        "fq": ts.write_fastq_gz(d / "reads.fastq.gz", rs),
        "r1": ts.write_fastq_gz(d / "r1.fastq.gz", rs[:600]),
        "r2": ts.write_fastq_gz(d / "r2.fastq.gz", rs[600:]),
        "genes": ts.write_fasta(d / "gene.fasta", "gene", gs[2][1000:4000]),
    }
    mf = d / "multi.fasta"
    with open(mf, "wb") as f:
        for i, (name, seq) in enumerate(
            (("a", gs[0][:3000]), ("short", gs[1][:20]), ("b", gs[3][5000:9000]))
        ):
            f.write(f">{name} record {i}\n".encode() + seq.tobytes() + b"\n")
    files["multi"] = str(mf)
    return files


@pytest.fixture(scope="module")
def built(panel):
    """Build through both CLIs; stdout and the CXI files must be identical."""
    d = panel["dir"]
    outs = []
    for name, main in (("jax", jmain), ("torch", tmain)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["build", *BUILD, "-b", str(d / name), "-r", panel["man"]])
        outs.append(buf.getvalue())
    return {"stdout": outs, "jax": str(d / "jax.bxi"), "torch": str(d / "torch.bxi")}


def test_build_output_and_index_identical(built):
    jout, tout = built["stdout"]
    assert tout.replace("torch", "jax") == jout
    with open(built["jax"], "rb") as fj, open(built["torch"], "rb") as ft:
        assert fj.read() == ft.read()


@pytest.mark.parametrize("search_reads", ["1", "0"])
@pytest.mark.parametrize("filt", [["-f", "1"], []])
def test_search_fastq_matches_jax(panel, built, capsys, monkeypatch, search_reads, filt):
    monkeypatch.setenv("COLORID_SEARCH_READS", search_reads)
    want = _run(jmain, ["search", "-b", built["jax"], "-q", panel["fq"], *filt], capsys)
    got = _run(
        tmain,
        ["search", "-b", built["torch"], "-q", panel["fq"], *filt, "--device", "cpu"],
        capsys,
    )
    assert got == want
    rows = [l.split("\t") for l in got.splitlines()]
    assert {r[2] for r in rows[:2]} == {"genome0", "genome1"}


@pytest.mark.parametrize(
    "case",
    ["paired_end", "perfect", "perfect_multi_fasta", "gene_search", "p_shared"],
)
def test_search_modes_match_jax(panel, built, capsys, case):
    q = {
        "paired_end": ["-q", panel["r1"], "-r", panel["r2"], "-f", "1"],
        "perfect": ["-s", "-q", panel["refs"]["genome3"][0]],
        "perfect_multi_fasta": ["-s", "-m", "-q", panel["multi"]],
        "gene_search": ["-g", "-q", panel["genes"]],
        "p_shared": ["-p", "0.05", "-q", panel["fq"], "-f", "2"],
    }[case]
    want = _run(jmain, ["search", "-b", built["jax"], *q], capsys)
    got = _run(tmain, ["search", "-b", built["torch"], *q, "--device", "cpu"], capsys)
    assert got == want
    assert got.strip()


def test_info_matches_jax(built, capsys):
    want = _run(jmain, ["info", "-b", built["jax"]], capsys)
    got = _run(tmain, ["info", "-b", built["torch"]], capsys)
    assert got == want
    assert "Number of accessions in index: 4" in got


def test_each_package_reads_the_others_files(built, tmp_path):
    j = JIndex.load(built["jax"])
    t = TIndex.load(built["torch"])
    for path, idx in ((built["jax"], t), (built["torch"], j)):
        other = (TIndex if idx is t else JIndex).load(path)
        np.testing.assert_array_equal(np.asarray(other.matrix), np.asarray(idx.matrix))
    # reference bincode, written by one package and read by the other
    jwrite_bxi(j, str(tmp_path / "j_ref.bxi"))
    twrite_bxi(t, str(tmp_path / "t_ref.bxi"))
    with open(tmp_path / "j_ref.bxi", "rb") as a, open(tmp_path / "t_ref.bxi", "rb") as b:
        assert a.read() == b.read()
    for a, b in ((TIndex.load(str(tmp_path / "j_ref.bxi")), j),
                 (JIndex.load(str(tmp_path / "t_ref.bxi")), t)):
        np.testing.assert_array_equal(np.asarray(a.matrix), np.asarray(b.matrix))
        assert (a.colors, a.n_ref_kmers, a.bloom_size, a.num_hash, a.k_size) == (
            b.colors, b.n_ref_kmers, b.bloom_size, b.num_hash, b.k_size
        )


def test_convert_round_trip(panel, built):
    j = JIndex.load(built["jax"])
    t = convert.index_from_arrays(
        np.asarray(j.matrix), bloom_size=j.bloom_size, num_hash=j.num_hash,
        k_size=j.k_size, colors=j.colors, n_ref_kmers=j.n_ref_kmers,
    )
    path = os.path.join(panel["dir"], "converted.bxi")
    t.save(path)
    with open(path, "rb") as a, open(built["jax"], "rb") as b:
        assert a.read() == b.read()
    jeng = JEngine(j)
    teng = convert.engine_from_jax_state(
        np.asarray(jeng.blocks2).view(np.uint32), jeng.wpad, j, device="cpu"
    )
    np.testing.assert_array_equal(
        teng.blocks2.numpy(), np.asarray(jeng.blocks2).view(np.int32)
    )
    # the converted engine answers as the JAX engine does
    from colorid_tpu.core.kmers import count_kmers

    keys, _ = count_kmers([ts.genomes(4, 50_000, seed=3)[1][:5000]], K,
                          skip_n=True, uppercase=True)
    want, got = jeng.search_keys(keys), teng.search_keys(keys)
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.and_all, want.and_all)
    assert got.all_valid == want.all_valid
    with pytest.raises(ValueError, match="uint32"):
        convert.index_from_arrays(
            np.asarray(j.matrix).astype(np.int64), bloom_size=j.bloom_size,
            num_hash=j.num_hash, k_size=j.k_size, colors=j.colors,
            n_ref_kmers=j.n_ref_kmers,
        )


@pytest.mark.parametrize("fnv_order", ["1", "0"])
def test_counts_file_matches_jax(tmp_path, monkeypatch, fnv_order):
    """read_counts_five_fields (the read_id counts file, rows in the
    reference's FnvHashMap order) writes the JAX package's bytes."""
    monkeypatch.setenv("COLORID_FNV_ORDER", fnv_order)
    rng = np.random.default_rng(5)
    reads = tmp_path / "x_reads.txt"
    with open(reads, "w") as f:
        for j in range(300):
            hit = f"genome{rng.integers(0, 9)}"
            status = "accept" if rng.random() < 0.8 else "reject"
            f.write(f"read{j}\t{hit}\t12\t0.9\t{status}\n")
    jreports.read_counts_five_fields(str(reads), str(tmp_path / "j"))
    treports.read_counts_five_fields(str(reads), str(tmp_path / "t"))
    want = (tmp_path / "j_counts.txt").read_bytes()
    assert (tmp_path / "t_counts.txt").read_bytes() == want
    assert want.count(b"\n") == 10
