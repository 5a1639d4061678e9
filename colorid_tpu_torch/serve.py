"""Persistent query server: load the index onto the card once, answer
search/classify requests over HTTP.

The reference is a batch CLI; for serving, the expensive state (the
bit-slice matrix on the card, the built CUDA kernels) must outlive a single
query.

    python -m colorid_tpu_torch.serve -b panel.bxi --port 8750 [--device cpu]

Endpoints (JSON):
  GET  /healthz            {"ok": true, ...index params}
  GET  /info               info-subcommand content, structured
  POST /search             {"sequences": [...], "filter": -1, "gene": false,
                            "p_shared": 0.35}
                           -> rows of the search TSV, structured
  POST /classify           {"reads": [{"id": ..., "seqs": [...]}, ...],
                            "down_sample": 1, "fp_correct": 3.0,
                            "bitvector_sample": 3}
                           -> read_id rows, structured

Device work runs under one lock (/search in the handler thread, /classify
in the micro-batcher's one worker thread), each on the engine's explicit
device, never on whatever device a thread happens to have current.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class _State:
    engine = None
    lock = None
    batcher = None


def _on_device():
    """The engine's card as the current CUDA device of the calling thread
    (a no-op on the CPU)."""
    import torch

    dev = _State.engine.device
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


class _ClassifyBatcher:
    """Micro-batching for /classify: a 1-read request costs about the same
    dispatches as thousands of reads, so concurrent small requests are
    coalesced into one device batch (grouped by identical classify params)
    instead of serializing one dispatch each behind the lock."""

    def __init__(self, max_reads: int = 8192, max_wait_ms: float = 8.0):
        self.q: queue.Queue = queue.Queue()
        self.max_reads = max_reads
        self.max_wait = max_wait_ms / 1000.0
        threading.Thread(target=self._worker, daemon=True).start()

    def submit(self, batch: list, params: tuple) -> list:
        ev = threading.Event()
        slot: dict = {}
        self.q.put((batch, params, ev, slot))
        ev.wait()
        if "err" in slot:
            raise slot["err"]
        return slot["rows"]

    def _worker(self):
        from .pipelines.read_id import classify_batch

        while True:
            pend = [self.q.get()]
            deadline = time.monotonic() + self.max_wait
            total = len(pend[0][0])
            while total < self.max_reads:
                tmo = deadline - time.monotonic()
                if tmo <= 0:
                    break
                try:
                    nxt = self.q.get(timeout=tmo)
                except queue.Empty:
                    break
                pend.append(nxt)
                total += len(nxt[0])
            groups: dict[tuple, list[int]] = {}
            for i, (_b, p, _ev, _s) in enumerate(pend):
                groups.setdefault(p, []).append(i)
            for p, idxs in groups.items():
                d, fp_correct, start_sample = p
                cat: list = []
                bounds = []
                for i in idxs:
                    b = pend[i][0]
                    bounds.append((len(cat), len(cat) + len(b)))
                    cat.extend(b)
                try:
                    with _State.lock, _on_device():
                        rows = classify_batch(
                            cat,
                            _State.engine,
                            d=d,
                            fp_correct=fp_correct,
                            start_sample=start_sample,
                        )
                except Exception as e:  # deliver the failure to every waiter
                    for i in idxs:
                        pend[i][3]["err"] = e
                        pend[i][2].set()
                    continue
                for i, (lo, hi) in zip(idxs, bounds):
                    pend[i][3]["rows"] = rows[lo:hi]
                    pend[i][2].set()


def _search_payload(payload: dict) -> dict:
    import numpy as np

    from .core.cutoff import auto_cutoff, clean_counts
    from .core.dna import to_bytes
    from .core.kmers import count_kmers
    from .pipelines.reports import generate_report, generate_report_gene
    from .pipelines.search import device_count_search_seqs

    engine = _State.engine
    index = engine.index
    seqs = [to_bytes(s) for s in payload["sequences"]]
    filter_t = int(payload.get("filter", -1))
    gene = bool(payload.get("gene", False))
    cov = float(payload.get("p_shared", 0.35))
    # k-mers counted on the card (QueryEngine.search_reads: the fused reads
    # pipeline on a v3/v4 index), the flow the CLI search uses; host
    # counting for lowercase or oversized bodies. Uppercase first: bodies
    # follow the CLI's fasta semantics.
    up = [np.frombuffer(bytes(s).upper(), dtype=np.uint8) for s in seqs]
    got = device_count_search_seqs(up, engine, 0 if gene else filter_t)
    if got is not None:
        res, n_kmers = got
    else:
        keys, counts = count_kmers(
            iter(seqs), index.k_size, skip_n=True, uppercase=True
        )
        if gene:
            keys, counts = clean_counts(keys, counts, 0)
        elif filter_t < 0:
            keys, counts = clean_counts(keys, counts, auto_cutoff(counts))
        else:
            keys, counts = clean_counts(keys, counts, filter_t)
        res = engine.search_keys(keys, qcounts=counts.astype(np.int32))
        n_kmers = int(keys.shape[0])
    report = {
        index.colors[c]: int(res.counts[c])
        for c in range(index.n_colors)
        if res.counts[c] > 0
    }
    if gene:
        lines = generate_report_gene("query", report, n_kmers, cov)
    else:
        uniq_stats = {index.colors[c]: s for c, s in res.freq_stats().items()}
        lines = generate_report(
            "query", report, uniq_stats, index.n_ref_kmers, n_kmers, cov
        )
    return {
        "num_kmers": int(n_kmers),
        "rows": [l.split("\t") for l in lines],
    }


def _classify_payload(payload: dict) -> dict:
    from .core.dna import to_bytes

    batch = [
        (r.get("id", f"read{i}"), [to_bytes(s) for s in r["seqs"]])
        for i, r in enumerate(payload["reads"])
    ]
    params = (
        int(payload.get("down_sample", 1)),
        10.0 ** (-float(payload.get("fp_correct", 3.0))),
        int(payload.get("bitvector_sample", 3)),
    )
    rows = _State.batcher.submit(batch, params)
    return {
        "rows": [
            {
                "id": r[0],
                "classification": r[1],
                "support": r[2],
                "total": r[3],
                "status": r[4],
                "n_top": r[5],
            }
            for r in rows
        ]
    }


class Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # quiet
        pass

    def _send(self, code: int, obj: dict) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        index = _State.engine.index
        if self.path == "/healthz":
            self._send(
                200,
                {
                    "ok": True,
                    "bloom_size": index.bloom_size,
                    "num_hash": index.num_hash,
                    "k_size": index.k_size,
                    "m_size": index.m_size,
                    "n_colors": index.n_colors,
                },
            )
        elif self.path == "/info":
            from .core.stats import false_prob

            accs = [
                {
                    "accession": a,
                    "n_kmers": index.n_ref_kmers.get(a, 0),
                    "false_prob": false_prob(
                        float(index.bloom_size),
                        float(index.num_hash),
                        float(index.n_ref_kmers.get(a, 0)),
                    ),
                }
                for a in sorted(index.colors)
            ]
            self._send(200, {"accessions": accs})
        else:
            self._send(404, {"error": "not found"})

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        try:
            payload = json.loads(self.rfile.read(n))
        except json.JSONDecodeError:
            self._send(400, {"error": "bad json"})
            return
        try:
            if self.path == "/search":
                with _State.lock, _on_device():
                    out = _search_payload(payload)
                self._send(200, out)
            elif self.path == "/classify":
                # device work runs in the batcher's worker; concurrent
                # requests coalesce into one batch
                self._send(200, _classify_payload(payload))
            else:
                self._send(404, {"error": "not found"})
        except Exception as e:  # surface errors to the client
            self._send(500, {"error": str(e)})


class _Server(ThreadingHTTPServer):
    # bursts of concurrent clients beyond the default listen backlog (5)
    # would get connection resets before the accept loop drains them
    request_queue_size = 128
    daemon_threads = True


def _warmup(engine) -> None:
    """Build the CUDA kernels and run the hot paths once on the MAIN thread
    before serving, so that no request thread pays nvcc's seconds or a
    first call's set-up."""
    import numpy as np

    from .pipelines.read_id import classify_batch

    t0 = time.time()
    if engine.device.type == "cuda":
        from .ops import kernels

        kernels.build_all()
    idx = engine.index
    k = idx.k_size
    g = np.frombuffer(b"ACGT" * ((k + 150) // 4 + 40), dtype=np.uint8)
    batch = [(f"w{i}", [g[i : i + 150].copy()]) for i in range(3)]
    classify_batch(batch, engine, d=1, fp_correct=1e-3, start_sample=3)
    width = idx.m_size or idx.k_size
    keys = np.tile(g[:width], (3, 1)).copy()
    keys[1, 0] = ord("C")
    keys[2, 0] = ord("G")
    engine.search_keys(keys)
    engine.readid_firsthit([keys], 3)  # the tie-order fixup's dispatch
    print(f"kernels warmed in {time.time() - t0:.1f}s", file=sys.stderr)


def make_server(
    bigsi_path: str, port: int, host: str = "127.0.0.1", warmup: bool = True,
    device: str = "cuda",
):
    """A server over the index at bigsi_path, on ``device`` (the card by
    default; raises without one unless device="cpu"). Call serve_forever()
    on the result."""
    import torch

    from .engine import QueryEngine
    from .index.bigsi import BigsiIndex
    from .runtime import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    _State.engine = QueryEngine(BigsiIndex.load(bigsi_path), device=dev)
    _State.lock = threading.Lock()
    if warmup:
        _warmup(_State.engine)
    _State.batcher = _ClassifyBatcher()
    return _Server((host, port), Handler)


def main(argv=None):
    p = argparse.ArgumentParser(prog="colorid_tpu_torch serve")
    p.add_argument("-b", "--bigsi", required=True)
    p.add_argument("--port", type=int, default=8750)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device that holds the index and runs the queries")
    args = p.parse_args(argv)
    srv = make_server(args.bigsi, args.port, args.host, device=args.device)
    print(
        f"serving {args.bigsi} on {args.host}:{srv.server_address[1]} "
        f"({_State.engine.device})",
        file=sys.stderr,
    )
    srv.serve_forever()


if __name__ == "__main__":
    main()
