"""colorid-compatible CLI of the PyTorch port (reference: src/main.rs clap
tree, :27-465).

Subcommands and flags mirror the reference binary:

  build        -b/--bigsi -r/--refs -k/--kmer -n/--num_hashes -s/--bloom
               [-m/--minimizer] [-v/--value N] [-t/--threads] [-Q/--quality]
               [-f/--filter] [--device-build [--device]]
  search       -b/--bigsi -q/--query... [-r/--reverse...] [-f/--filter]
               [-p/--p_shared] [-g/--gene_search] [-s/--perfect_search]
               [-m/--multi_fasta] [-Q/--quality]
  info         -b/--bigsi
  read_id      -b/--bigsi -q/--query... -n/--prefix [-c/--batch]
               [-t/--threads] [-d/--down_sample] [-H/--high_mem_load]
               [-p/--fp_correct] [-Q/--quality] [-B/--bitvector_sample]
  batch_id     -b/--bigsi -q/--query -T/--tag [same knobs as read_id]
  read_filter  -c/--classification -f/--files... -t/--taxon -p/--prefix
               [-e/--exclude]

Index files keep the reference extensions: `<prefix>.bxi` (k-mer) /
`<prefix>.mxi` (minimizer). Content is the CXI dense format by default
(`--ref-format` writes reference bincode); the loader autodetects either.
Both formats are shared with the JAX package.

`search`, `read_id` and `batch_id` run on `--device cuda` (the default;
raises without a card) or `--device cpu`, and so does the scatter-OR of
`build --device-build` (a plain `build` scatters on the host, as does any
build past 2^31 Bloom rows). read_filter is host-only.
"""

from __future__ import annotations

import argparse
import sys


def _build(args: argparse.Namespace) -> None:
    from .index.bigsi import write_bxi
    from .pipelines.build import build_index, tab_to_map

    print(f" Ref_file : {args.ref_file}")
    print(f" Bigsi file : {args.bigsi}")
    print(f"K-mer size: {args.kmer}")
    print(
        f"Bloom filter parameters: num hashes {args.num_hashes}, "
        f"filter size {args.bloom}"
    )
    if args.minimizer:
        print(f"Build with minimizers, minimizer size: {args.value}")
    ref_map = tab_to_map(args.ref_file)
    m_size = args.value if args.minimizer else 0
    index = build_index(
        ref_map,
        bloom_size=args.bloom,
        num_hash=args.num_hashes,
        k_size=args.kmer,
        m_size=m_size,
        quality=args.quality,
        cutoff=args.filter,
        checkpoint_dir=args.checkpoint,
        device=args.device if args.device_build else False,
        blocked=args.blocked,
        threads=max(args.threads, 1),
        color_shards=args.color_shards,
    )
    print("Saving BIGSI to file.")
    ext = ".mxi" if args.minimizer else ".bxi"
    path = args.bigsi + ext
    if args.ref_format:
        if args.blocked:
            raise SystemExit("--ref-format and --blocked are incompatible")
        write_bxi(index, path)
    else:
        index.save(path)


def _load_engine(path: str, device: str, high_mem: bool = False):
    from .engine import QueryEngine
    from .index.bigsi import BigsiIndex

    # -H loads the whole file into RAM (the reference's read_bigsi_highmem,
    # bigsi.rs:65-68); default memory-maps
    return QueryEngine(BigsiIndex.load(path, mmap=not high_mem), device=device)


def _search(args: argparse.Namespace) -> None:
    import time

    from .pipelines.search import batch_search, perfect_search

    if args.bigsi.endswith(".mxi"):
        print(
            "Error: An index with minimizers (.mxi) is used, but not "
            "available for this function",
            file=sys.stderr,
        )
        return
    t0 = time.time()
    print("Loading index", file=sys.stderr)
    engine = _load_engine(args.bigsi, args.device)
    print(f"Index loaded in {int(time.time() - t0)} seconds", file=sys.stderr)
    if args.perfect_search:
        lines = perfect_search(args.query, engine, multi_fasta=args.multi_fasta)
    else:
        files2 = [] if args.reverse == ["none"] else args.reverse
        lines = batch_search(
            args.query,
            files2,
            engine,
            filter_t=args.filter,
            cov=args.p_shared,
            gene_search=args.gene_search,
            qual_offset=args.quality,
        )
    for l in lines:
        print(l)


def _info(args: argparse.Namespace) -> None:
    from .index.bigsi import BigsiIndex
    from .pipelines.info import info_lines

    print("Loading index", file=sys.stderr)
    index = BigsiIndex.load(args.bigsi)
    for l in info_lines(index):
        print(l)


def _read_id(args: argparse.Namespace) -> None:
    import time

    from .pipelines.read_id import read_id

    t0 = time.time()
    engine = _load_engine(args.bigsi, args.device, args.high_mem_load)
    print(f"Index loaded in {int(time.time() - t0)} seconds", file=sys.stderr)
    read_id(
        args.query,
        engine,
        prefix=args.prefix,
        d=args.down_sample,
        fp_correct=10.0 ** (-args.fp_correct),
        b=args.batch,
        qual_offset=args.quality,
        start_sample=args.bitvector_sample,
        threads=args.threads,
    )


def _batch_id(args: argparse.Namespace) -> None:
    from .pipelines.build import tab_to_map
    from .pipelines.read_id import read_id

    samples = tab_to_map(args.query)
    engine = _load_engine(args.bigsi, args.device, args.high_mem_load)
    for accession, files in samples.items():
        print(f"Classifying {accession}", file=sys.stderr)
        read_id(
            files,
            engine,
            prefix=f"{accession}_{args.tag}",
            d=args.down_sample,
            fp_correct=10.0 ** (-args.fp_correct),
            b=args.batch,
            qual_offset=args.quality,
            start_sample=args.bitvector_sample,
            threads=args.threads,
        )


def _read_filter(args: argparse.Namespace) -> None:
    from .pipelines.read_filter import read_filter_pe, read_filter_se, tab_to_map

    class_map = tab_to_map(args.classification, args.taxon)
    if len(args.files) == 1:
        read_filter_se(class_map, args.files, args.taxon, args.prefix, args.exclude)
    else:
        read_filter_pe(class_map, args.files, args.taxon, args.prefix, args.exclude)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="colorid-tpu-torch",
        description="BIGSI based taxonomic ID of sequence data (PyTorch/CUDA)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="builds a bigsi")
    b.add_argument("-b", "--bigsi", required=True)
    b.add_argument("-r", "--refs", dest="ref_file", required=True)
    b.add_argument("-k", "--kmer", type=int, required=True)
    b.add_argument("-n", "--num_hashes", type=int, required=True)
    b.add_argument("-s", "--bloom", type=int, required=True)
    b.add_argument("-m", "--minimizer", action="store_true")
    b.add_argument("-v", "--value", type=int, default=15)
    b.add_argument("-t", "--threads", type=int, default=1)
    b.add_argument("-Q", "--quality", type=int, default=15)
    b.add_argument("-f", "--filter", type=int, default=-1)
    b.add_argument("--ref-format", action="store_true",
                   help="write reference-compatible bincode .bxi/.mxi")
    b.add_argument("--checkpoint", default=None,
                   help="directory for per-accession build checkpoints (resume)")
    b.add_argument("--device-build", action="store_true",
                   help="run the scatter-OR index construction on --device")
    b.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device of --device-build's scatter-OR")
    b.add_argument("--blocked", action="store_true",
                   help="turbo layout: all hashes of a k-mer in one 512B block "
                        "(one HBM fetch per k-mer; not reference-bit-compatible)")
    b.add_argument("--color-shards", type=int, default=0,
                   help="with --blocked: size the placement to N color "
                        "shards so wide indexes (> 1024 colors) keep the "
                        "sorted-stream fast path on a (data, color) mesh")
    b.set_defaults(func=_build)

    s = sub.add_parser("search", help="bigsi search on fasta/fastq.gz files")
    s.add_argument("-b", "--bigsi", required=True)
    s.add_argument("-q", "--query", nargs="+", required=True)
    s.add_argument("-r", "--reverse", nargs="+", default=["none"])
    s.add_argument("-f", "--filter", type=int, default=-1)
    s.add_argument("-p", "--p_shared", type=float, default=0.35)
    s.add_argument("-g", "--gene_search", action="store_true")
    s.add_argument("-s", "--perfect_search", action="store_true")
    s.add_argument("-m", "--multi_fasta", action="store_true")
    s.add_argument("-Q", "--quality", type=int, default=15)
    s.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device that holds the index and runs the query")
    s.set_defaults(func=_search)

    i = sub.add_parser("info", help="dumps index parameters and accessions")
    i.add_argument("-b", "--bigsi", required=True)
    i.add_argument("-c", "--compressed", default="")  # declared, unused (parity)
    i.set_defaults(func=_info)

    r = sub.add_parser("read_id", help="id's reads")
    r.add_argument("-b", "--bigsi", required=True)
    r.add_argument("-q", "--query", nargs="+", required=True)
    r.add_argument("-c", "--batch", type=int, default=50000)
    r.add_argument("-t", "--threads", type=int, default=0)
    r.add_argument("-n", "--prefix", required=True)
    r.add_argument("-d", "--down_sample", type=int, default=1)
    r.add_argument("-H", "--high_mem_load", action="store_true")
    r.add_argument("-p", "--fp_correct", type=float, default=3.0)
    r.add_argument("-Q", "--quality", type=int, default=15)
    r.add_argument("-B", "--bitvector_sample", type=int, default=3)
    r.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device that holds the index and runs the query")
    r.set_defaults(func=_read_id)

    bi = sub.add_parser("batch_id", help="classifies batch of samples reads")
    bi.add_argument("-b", "--bigsi", required=True)
    bi.add_argument("-q", "--query", required=True)
    bi.add_argument("-T", "--tag", required=True)
    bi.add_argument("-c", "--batch", type=int, default=50000)
    bi.add_argument("-t", "--threads", type=int, default=0)
    bi.add_argument("-d", "--down_sample", type=int, default=1)
    bi.add_argument("-H", "--high_mem_load", action="store_true")
    bi.add_argument("-p", "--fp_correct", type=float, default=3.0)
    bi.add_argument("-Q", "--quality", type=int, default=15)
    bi.add_argument("-B", "--bitvector_sample", type=int, default=3)
    bi.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device that holds the index and runs the query")
    bi.set_defaults(func=_batch_id)

    rf = sub.add_parser("read_filter", help="filters reads")
    rf.add_argument("-c", "--classification", required=True)
    rf.add_argument("-f", "--files", nargs="+", required=True)
    rf.add_argument("-t", "--taxon", required=True)
    rf.add_argument("-p", "--prefix", required=True)
    rf.add_argument("-e", "--exclude", action="store_true")
    rf.set_defaults(func=_read_filter)
    return p


def main(argv: list[str] | None = None) -> None:
    args = make_parser().parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
