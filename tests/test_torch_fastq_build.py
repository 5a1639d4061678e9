"""Index construction from FASTQ accessions: the port's CLI build
(colorid_tpu_torch.cli.main) against the JAX package's, on a manifest with
a single-end .fastq.gz line, a paired line and a fasta line, at the auto
cutoff (-f -1, the default) and two quality thresholds (-Q). The .bxi files
must be byte-identical, through the native counter
(pipelines/build.py::_native_kmers and _finish_native) and through the
numpy counter, and the auto cutoff must filter (a cutoff of at least
1: singletons dropped)."""

import gzip
import os

import numpy as np
import pytest

from colorid_tpu.cli import main as jmain
from colorid_tpu.pipelines import build as jbuild
from colorid_tpu_torch import native
from colorid_tpu_torch.cli import main as tmain
from colorid_tpu_torch.pipelines import build as tbuild
from tests import torch_support as ts


def _write_fastq(path, rs: np.ndarray, rng, prefix: str) -> str:
    """Reads of quality 'I' (Phred 40) but for 3 % of the bases, which
    draw one from '#' (2) to '5' (20): -Q 15 and -Q 30 mask different
    bases."""
    qual = np.full(rs.shape, ord("I"), dtype=np.uint8)
    low = rng.random(rs.shape) < 0.03
    qual[low] = rng.integers(ord("#"), ord("5") + 1, int(low.sum()))
    with gzip.open(path, "wt") as f:
        for j, (r, q) in enumerate(zip(rs, qual)):
            f.write(f"@{prefix}{j} x\n{r.tobytes().decode()}\n+\n{q.tobytes().decode()}\n")
    return str(path)


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    d = tmp_path_factory.mktemp("fqbuild")
    gs = ts.genomes(3, 20_000, seed=21)
    rng = np.random.default_rng(22)
    se = ts.reads(gs[:1], 2_000, 150, seed=23, sub_rate=0.01)
    pe = ts.reads(gs[1:2], 2_000, 150, seed=24, sub_rate=0.01)
    fq = _write_fastq(d / "se.fastq.gz", se, rng, "se")
    r1 = _write_fastq(d / "pe_R1.fastq.gz", pe[:1_000], rng, "pe")
    r2 = _write_fastq(d / "pe_R2.fastq.gz", pe[1_000:], rng, "pe")
    fa = ts.write_fasta(d / "ref.fasta", "ref", gs[2])
    man = d / "refs.txt"
    man.write_text(f"single\t{fq}\npaired\t{r1}\t{r2}\nref\t{fa}\n")
    return d, str(man)


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("quality", [15, 30])
def test_fastq_build_bxi_identical(manifest, monkeypatch, route, quality):
    d, man = manifest
    if route == "numpy":
        monkeypatch.setattr(jbuild, "_native_kmers", lambda *a, **kw: None)
        monkeypatch.setattr(tbuild, "_native_kmers", lambda *a, **kw: None)
    else:
        assert native.available(), "the port's native counter did not build"
    cutoffs, finished = [], []
    real_cut, real_fin = tbuild.auto_cutoff, tbuild._finish_native
    monkeypatch.setattr(tbuild, "auto_cutoff",
                        lambda c: cutoffs.append(real_cut(c)) or cutoffs[-1])
    monkeypatch.setattr(tbuild, "_finish_native",
                        lambda *a: finished.append(a[1:]) or real_fin(*a))
    argv = ["build", "-k", "21", "-n", "3", "-s", "300000", "-Q", str(quality)]
    out = {}
    for name, main in (("jax", jmain), ("torch", tmain)):
        prefix = str(d / f"{name}_{route}_{quality}")
        main(argv + ["-b", prefix, "-r", man])
        with open(prefix + ".bxi", "rb") as f:
            out[name] = f.read()
    assert out["torch"] == out["jax"]
    assert len(cutoffs) == 2 and min(cutoffs) >= 1  # the two FASTQ accessions
    if route == "native":  # one per accession; fasta unfiltered at -1
        assert sorted(finished) == [(-1, False), (-1, False), (-1, True)]
    else:
        assert finished == []
