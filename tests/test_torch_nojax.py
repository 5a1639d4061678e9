"""The port stands alone: no module of colorid_tpu_torch imports jax or the
JAX package colorid_tpu (checked on the source, and in a fresh interpreter
that builds and searches through the port's CLI), its native library is its
own, and its entry points default to the CUDA card and refuse to fall back
to the CPU when there is none."""

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
    bad = {
        (os.path.relpath(p, ROOT), m)
        for p in files
        for m in _imported_modules(p)
        if m.split(".")[0] in FORBIDDEN  # the exact name, not a prefix
    }
    assert not bad


_SCRIPT = textwrap.dedent("""
    import contextlib, io, sys
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
    rows = [l for l in out.getvalue().splitlines() if "\\t" in l]
    assert len(rows) >= 4 and rows[0].split("\\t")[2] in ("genome0", "genome1"), rows
    assert "colorid_tpu_torch.ops.blocked" in sys.modules
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
