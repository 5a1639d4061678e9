"""colorid-tpu ported to PyTorch and CUDA (NVIDIA Hopper).

A BIGSI engine for taxonomic identification: the same index formats, CLI
and outputs as the JAX package ``colorid_tpu``, with the device work in
PyTorch and hand-written CUDA kernels (``csrc/``).

Public API:

    from colorid_tpu_torch import BigsiIndex, QueryEngine, build_index

    index = build_index({"acc": ["genome.fasta"]}, 50_000_000, 4, 31)
    index.save("panel.bxi")
    engine = QueryEngine(BigsiIndex.load("panel.bxi"), device="cuda")
    result = engine.search_keys(keys, qcounts=counts)

Wide indexes shard over a logical mesh (``parallel/``): color or row
shards, all on the one card unless the mesh names more devices, with
batches split over the data axis. The sharded engine searches k-mers,
classifies reads and counts k-mers of reads on the devices:

    from colorid_tpu_torch import ShardedQueryEngine
    from colorid_tpu_torch.parallel.sharded import make_mesh

    engine = ShardedQueryEngine(index, mesh=make_mesh(2, 4, "color"))
    result = engine.search_keys(keys, qcounts=counts)
    report = engine.readid_counts(keys_per_read, start_sample=3)
    result, n_unique = engine.search_reads(words, lens, k=31, L=160, filter_t=1)

and is a drop-in engine for ``pipelines.read_id.read_id`` and
``classify_batch``. ``parallel/distributed.py`` starts a
``torch.distributed`` process group (NCCL by default).

Reads go to the card as 2-bit words: ``engine.search_reads`` counts their
k-mers there (on a v3/v4 index through the fused reads path,
``ops/fused_reads.py``), and ``pipelines/read_id.py`` classifies read by
read.

CLI: ``python -m colorid_tpu_torch.cli
{build,search,info,read_id,batch_id,read_filter}``; HTTP server:
``python -m colorid_tpu_torch.serve -b panel.bxi --port 8750``.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy: importing the package must not pull torch into light-weight users
    if name == "BigsiIndex":
        from .index.bigsi import BigsiIndex

        return BigsiIndex
    if name == "QueryEngine":
        from .engine import QueryEngine

        return QueryEngine
    if name == "ShardedQueryEngine":
        from .parallel.engine import ShardedQueryEngine

        return ShardedQueryEngine
    if name == "build_index":
        from .pipelines.build import build_index

        return build_index
    raise AttributeError(name)
