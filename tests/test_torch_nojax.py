"""The port stands alone: no module of colorid_tpu_torch, nor
chip_smoke.py, nor the process-mesh worker of the tests, imports jax or the
JAX package colorid_tpu (checked on the source, and in a fresh interpreter
that builds (on the host and with --device-build), searches and classifies
reads through the port's CLI, runs a sharded search on a logical mesh (also
over a matrix born sharded), classifies reads and counts their k-mers on
that mesh, runs the process-mesh collectives and mesh over a process group
of one, and answers a /search through the port's HTTP server; its
placement and window-key wrappers take their twins there), its
native library is its own, and its entry points default to the CUDA card
and refuse to fall back to the CPU when there is none."""

import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from colorid_tpu_torch.engine import QueryEngine
from colorid_tpu_torch.index.bigsi import BigsiIndex
from colorid_tpu_torch.runtime import resolve_device
from tests import torch_support as ts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "colorid_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "colorid_tpu"}


def _imported_modules(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = [
        os.path.join(d, f)
        for d, _dirs, fs in os.walk(PKG)
        for f in fs
        if f.endswith(".py")
    ]
    assert len(files) > 20
    files += [os.path.join(ROOT, "chip_smoke.py"),
              os.path.join(ROOT, "tests", "torch_process_mesh_worker.py")]
    bad = {
        (os.path.relpath(p, ROOT), m)
        for p in files
        for m in _imported_modules(p)
        if m.split(".")[0] in FORBIDDEN  # the exact name, not a prefix
    }
    assert not bad


_SCRIPT = textwrap.dedent("""
    import contextlib, importlib.abc, io, sys

    class NoJax(importlib.abc.MetaPathFinder):
        # jax, jaxlib and the JAX package cannot be imported here
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "colorid_tpu"):
                raise ModuleNotFoundError(f"{name} is not importable here", name=name)
            return None

    sys.meta_path.insert(0, NoJax())
    try:
        import jax  # noqa: F401
        raise AssertionError("jax is importable")
    except ModuleNotFoundError:
        pass
    from colorid_tpu_torch.cli import main
    from colorid_tpu_torch import native
    d, man, fq = sys.argv[1:4]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(["build", "-k", "27", "-n", "4", "-s", "375000", "-b", d + "/idx", "-r", man])
        main(["search", "-b", d + "/idx.bxi", "-q", fq, "-f", "1", "--device", "cpu"])
        main(["build", "--blocked", "-k", "27", "-n", "4", "-s", "375000",
              "-b", d + "/turbo", "-r", man])
        main(["search", "-b", d + "/turbo.bxi", "-q", fq, "-f", "1", "--device", "cpu"])
        main(["build", "--blocked", "--color-shards", "2", "-k", "27", "-n", "4",
              "-s", "375000", "-b", d + "/placed", "-r", man])
        main(["search", "-b", d + "/placed.bxi", "-q", fq, "-f", "1", "--device", "cpu"])
        main(["read_id", "-b", d + "/idx.bxi", "-q", fq, "-n", d + "/rid", "--device", "cpu"])
        main(["build", "--device-build", "--device", "cpu", "-k", "27", "-n", "4",
              "-s", "375000", "-b", d + "/dev", "-r", man])
    assert open(d + "/dev.bxi", "rb").read() == open(d + "/idx.bxi", "rb").read()
    assert "colorid_tpu_torch.ops.build_ops" in sys.modules
    rows = [l for l in out.getvalue().splitlines() if "\\t" in l]
    assert len(rows) >= 6 and rows[0].split("\\t")[2] in ("genome0", "genome1"), rows
    assert "colorid_tpu_torch.ops.blocked" in sys.modules
    calls = [l.split("\\t")[1] for l in open(d + "/rid_reads.txt")]
    assert len(calls) == 2000 and calls.count("genome0") + calls.count("genome1") > 1500
    assert "colorid_tpu_torch.pipelines.read_id" in sys.modules
    # a sharded search on a logical mesh: the same answers as one device
    import numpy as np
    from colorid_tpu_torch import BigsiIndex, QueryEngine, ShardedQueryEngine
    from colorid_tpu_torch.parallel import sharded
    index = BigsiIndex.load(d + "/turbo.bxi")
    keys = np.frombuffer(b"ACGT", dtype=np.uint8)[
        np.random.default_rng(0).integers(0, 4, (3000, 27))]
    want = QueryEngine(index, device="cpu").search_keys(keys)
    for axis in ("color", "row"):
        eng = ShardedQueryEngine(
            index, layout=axis, mesh=sharded.make_mesh(1, 2, axis, devices=["cpu"]))
        got = eng.search_keys(keys)
        assert (got.counts == want.counts).all() and got.all_valid == want.all_valid
    from colorid_tpu_torch.ops import build_ops
    classic = BigsiIndex.load(d + "/idx.bxi")
    mesh = sharded.make_mesh(1, 2, "row", devices=["cpu"])
    cols = [np.nonzero(classic.matrix[:, 0] >> np.uint32(c) & 1)[0] for c in range(3)]
    shards, Rl = build_ops.build_matrix_rowshard(
        cols, classic.bloom_size, mesh,
        row_multiple=ShardedQueryEngine.row_multiple(classic))
    blocks = build_ops.pack_blocks_rowshard(shards, mesh=mesh, Rl=Rl, W=1)
    import dataclasses
    born = ShardedQueryEngine(
        dataclasses.replace(classic, matrix=None), layout="row", mesh=mesh,
        sharded_matrix=(blocks, 1, Rl)).search_keys(keys)
    want = QueryEngine(classic, device="cpu").search_keys(keys)
    assert (born.counts == want.counts).all() and born.all_valid == want.all_valid
    assert "colorid_tpu_torch.parallel.engine" in sys.modules
    # the sharded read classifier and device k-mer counting on a (2, 2)
    # row mesh: the single-device engine's answers
    from colorid_tpu_torch.core.fastx import stream_fastq
    from colorid_tpu_torch.core.kmers import kmer_set
    from colorid_tpu_torch.ops.extract import pack_reads
    from colorid_tpu_torch.pipelines.read_id import _fnv_order_keys
    seqs = np.stack([s for _id, s in stream_fastq(fq, 15)][:300])
    sets = [_fnv_order_keys(kmer_set([s], 27)) for s in seqs[:60]]
    single = QueryEngine(index, device="cpu")
    shr = ShardedQueryEngine(index, layout="row",
                             mesh=sharded.make_mesh(2, 2, "row", devices=["cpu"]))
    rep = shr.readid_counts(sets, 3)
    assert (rep == single.readid_counts(sets, 3)).all() and rep[:, :-1].max() > 0
    lens = np.full(seqs.shape[0], seqs.shape[1], dtype=np.int32)
    got, n_u = shr.search_reads(pack_reads(seqs), lens, k=27, L=seqs.shape[1])
    want, want_n = single.search_reads(pack_reads(seqs), lens, k=27, L=seqs.shape[1])
    assert n_u == want_n > 0 and (got.counts == want.counts).all()
    assert got.freq_stats() == want.freq_stats()
    assert "colorid_tpu_torch.ops.extract" in sys.modules
    # the process-mesh collectives and a mesh made inside a process group
    # (of one process: the mesh stays in-process)
    import socket
    import torch
    import torch.distributed as dist
    from colorid_tpu_torch.parallel import distributed
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    distributed.initialize(f"127.0.0.1:{port}", 1, 0, backend="gloo")
    x = torch.tensor([[6, 3], [-1, 9]])
    assert distributed.global_devices(["cpu"]) == [(0, "cpu")]
    for fn in (distributed.all_sum, distributed.all_min, distributed.all_and,
               distributed.all_cat):
        assert torch.equal(fn(x), x)
    assert not sharded.make_mesh(1, 2, "row", devices=["cpu"]).spans_processes
    dist.destroy_process_group()
    # the HTTP server on the v4 index: /search counts on the device through
    # the fused reads path
    import json, threading, urllib.request
    from colorid_tpu_torch import serve
    srv = serve.make_server(d + "/turbo.bxi", 0, device="cpu")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    body = json.dumps({"sequences": ["ACGT" * 40], "filter": 0}).encode()
    url = "http://127.0.0.1:%d/search" % srv.server_address[1]
    with urllib.request.urlopen(urllib.request.Request(url, body), timeout=60) as r:
        assert json.loads(r.read())["num_kmers"] > 0
    srv.shutdown()
    assert "colorid_tpu_torch.ops.fused_reads" in sys.modules
    # the placement and window-key wrappers ran on the CPU through their
    # twins: no kernel was built or launched without a card
    from colorid_tpu_torch.ops import extract, hash_torch, kernels
    assert hash_torch.placement.launches == extract.window_keys.launches == 0
    assert not kernels._libs and {"placement.cu", "window_keys.cu"} <= set(kernels.SOURCES)
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "colorid_tpu"))
    assert not leaked, leaked
    lib = native._lib._name if native._lib is not None else None
    print("NATIVE", lib)
""")


def test_cpu_build_and_search_load_no_jax(tmp_path):
    gs = ts.genomes(3, 30_000, seed=7)
    man, _refs = ts.write_panel(tmp_path, gs)
    fq = ts.write_fastq_gz(tmp_path / "q.fastq.gz", ts.reads(gs[:2], 2000, 150, seed=8))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    r = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(tmp_path), man, fq],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    lib = r.stdout.split("NATIVE ", 1)[1].strip()
    if lib != "None":  # g++ present: the port's own library, never the JAX one
        assert os.path.dirname(lib) == os.path.join(PKG, "native")


def test_default_device_is_cuda_and_never_falls_back():
    index = BigsiIndex(1000, 4, 27, 0, ["a"], {"a": 1},
                       np.zeros((1000, 1), dtype=np.uint32))
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        assert QueryEngine(index).blocks2.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA card"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        QueryEngine(index)
    assert QueryEngine(index, device="cpu").blocks2.device.type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("mps")
