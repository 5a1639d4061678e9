"""One rank of a ShardedQueryEngine whose row mesh spans two processes
(colorid_tpu_torch/parallel/distributed.py + sharded.py), for
tests/test_torch_process_mesh.py (gloo on the CPU) and tests/test_torch_cuda.py
(the card):

    python tests/torch_process_mesh_worker.py HOST:PORT RANK IN_DIR OUT_DIR DEVICE BACKEND

IN_DIR holds classic.bxi, blocked.bxi and inputs.npz (tests/
test_torch_process_mesh.py::write_inputs). On a (1, 4) row mesh (two
shards per rank: each rank names its device twice, as each JAX process of
two local devices does) and a (1, 2) one, over each index, the rank runs
search_keys, the four readid_* methods, search_reads, classify_batch and
the born-sharded build and its search, and saves every output to
OUT_DIR/rank<RANK>.npz. It also records the collectives on known tensors,
a collective over tensors of other shapes, the refusals of the color
layout and of n_data > 1, whether a v4 index streams, and every loaded
module of jax, jaxlib or the JAX package (there must be none)."""

import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from colorid_tpu_torch import BigsiIndex, ShardedQueryEngine
from colorid_tpu_torch.engine import flatten_keys
from colorid_tpu_torch.ops import build_ops
from colorid_tpu_torch.parallel import distributed
from colorid_tpu_torch.parallel.sharded import make_mesh
from colorid_tpu_torch.pipelines import read_id as rid

MESHES = {"m14": 4, "m12": 2}
KINDS = ("classic", "blocked")
B = 3  # readid start sample (-B)


def result_arrays(prefix: str, res) -> dict:
    return {f"{prefix}.counts": res.counts, f"{prefix}.all_valid": np.array(res.all_valid),
            f"{prefix}.and_all": res.and_all, f"{prefix}.freq_hist": res.freq_hist,
            f"{prefix}.over_colors": res.over_colors, f"{prefix}.over_freqs": res.over_freqs}


def keysets(inp) -> list[np.ndarray]:
    cuts = np.cumsum(inp["set_lens"])[:-1]
    return np.split(inp["set_keys"], cuts)


def columns(index) -> list[np.ndarray]:
    m = np.asarray(index.matrix)
    return [np.nonzero((m[:, c // 32] >> np.uint32(c % 32)) & np.uint32(1))[0]
            for c in range(index.n_colors)]


def run_engine(out: dict, tag: str, eng, inp, sets, batch) -> None:
    k, L = int(inp["k"]), int(inp["L"])
    out.update(result_arrays(f"{tag}.search_keys",
                             eng.search_keys(inp["keys"], qcounts=inp["qcounts"])))
    out[f"{tag}.readid_counts"] = eng.readid_counts(sets, B)
    rows, seg, pos = flatten_keys(sets, eng._rows)
    out[f"{tag}.readid_counts_arrays"] = eng.readid_counts_arrays(rows, seg, pos, len(sets), B)
    out[f"{tag}.readid_counts_packed"] = eng.readid_counts_packed(
        inp["packed"], seg, pos, len(sets), B, k)
    out[f"{tag}.readid_firsthit"] = eng.readid_firsthit(sets, B)
    res, n_u = eng.search_reads(inp["words"], inp["lens"], k=k, L=L, filter_t=1)
    out.update(result_arrays(f"{tag}.search_reads", res))
    out[f"{tag}.search_reads.n_u"] = np.array(n_u)
    out[f"{tag}.classify_batch"] = np.array(
        json.dumps(rid.classify_batch(batch, eng, 1, 1e-3, B)))


def main() -> int:
    coord, rank, in_dir, out_dir, device, backend = sys.argv[1:7]
    rank = int(rank)
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    distributed.initialize(coord, num_processes=2, process_id=rank, backend=backend)
    out: dict = {}
    try:
        inp = dict(np.load(os.path.join(in_dir, "inputs.npz")))
        sets = keysets(inp)
        reads = np.split(inp["batch_reads"], np.cumsum(inp["batch_lens"])[:-1])
        batch = [(f"r{i}", [r]) for i, r in enumerate(reads)]
        # the collectives on known tensors, and a collective whose ranks
        # pass other shapes
        x = torch.tensor([[rank + 1, -1 - 2 * rank], [0x0F0F << rank, 7]], device=device)
        out["coll.sum"] = distributed.all_sum(x).cpu().numpy()
        out["coll.min"] = distributed.all_min(x).cpu().numpy()
        out["coll.cat"] = distributed.all_cat(x).cpu().numpy()
        out["coll.and"] = distributed.all_and(x).cpu().numpy()
        try:
            distributed.all_sum(torch.zeros(rank + 1, device=device))
            out["coll.mismatch"] = np.array("no error")
        except RuntimeError as e:
            out["coll.mismatch"] = np.array(str(e))
        for kind in KINDS:
            index = BigsiIndex.load(os.path.join(in_dir, f"{kind}.bxi"))
            for name, nm in MESHES.items():
                mesh = make_mesh(1, nm, "row", devices=[device] * (nm // 2))
                eng = ShardedQueryEngine(index, mesh=mesh, layout="row")
                out[f"{name}.{kind}.held"] = np.array([m is not None for m in eng.mat])
                out[f"{name}.{kind}.stream"] = np.array(eng._stream)
                run_engine(out, f"{name}.{kind}", eng, inp, sets, batch)
                meta = dataclasses.replace(index, matrix=None)
                shards, Rl = build_ops.build_matrix_rowshard(
                    columns(index), index.bloom_size, mesh,
                    row_multiple=ShardedQueryEngine.row_multiple(meta))
                blocks = build_ops.pack_blocks_rowshard(
                    shards, mesh=mesh, Rl=Rl, W=index.words_per_row)
                born = ShardedQueryEngine(meta, mesh=mesh, layout="row",
                                          sharded_matrix=(blocks, eng.wpad, Rl))
                out.update(result_arrays(f"{name}.{kind}.born",
                                         born.search_keys(inp["keys"], qcounts=inp["qcounts"])))
                out[f"{name}.{kind}.born.equal_blocks"] = np.array(all(
                    (a is None) == (b is None) and (a is None or torch.equal(a, b))
                    for a, b in zip(blocks, eng.mat)))
        index = BigsiIndex.load(os.path.join(in_dir, "classic.bxi"))
        for what, kw in (("color", dict(layout="color")), ("n_data", dict(layout="row", n_data=2))):
            try:
                ShardedQueryEngine(index, device=device, **kw)
                out[f"refuse.{what}"] = np.array("no error")
            except ValueError as e:
                out[f"refuse.{what}"] = np.array(str(e))
        default = ShardedQueryEngine(index, layout="row", device=device)
        out["default.shape"] = np.array([default.mesh.n_data, default.mesh.n_model])
        out["default.home"] = np.array(str(default.mesh.home))
    finally:
        dist.destroy_process_group()
    out["leaked"] = np.array(sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("jax", "jaxlib", "colorid_tpu")),
                             dtype=str)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    print(f"rank{rank} OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
