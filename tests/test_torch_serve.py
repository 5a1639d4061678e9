"""The port's HTTP server (colorid_tpu_torch/serve.py, device="cpu") against
the JAX package's (colorid_tpu/serve.py) on one synthetic index, classic
and v4: identical JSON bodies on every endpoint, /search by device
counting equal to host counting, concurrent /classify requests equal to a
sequential run and coalesced into fewer classify_batch calls than
requests."""

import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import pytest

from colorid_tpu import serve as jserve
from colorid_tpu.pipelines.build import build_index as jbuild
from colorid_tpu_torch import serve as tserve
from colorid_tpu_torch.pipelines import read_id as trid
from tests import torch_support as ts

K = 27


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """Four random genomes and a classic and a v4 index over them, built
    by the JAX package and saved once."""
    tmp = tmp_path_factory.mktemp("serve")
    gs = ts.genomes(4, 50_000, seed=61)
    _man, refs = ts.write_panel(tmp, gs)
    paths = {}
    for kind in ("classic", "v4"):
        paths[kind] = str(tmp / f"{kind}.bxi")
        jbuild(refs, 375_000, 4, K, verbose=False, blocked=kind == "v4").save(paths[kind])
    return gs, paths


def _start(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module", params=["classic", "v4"])
def servers(request, panel):
    """(JAX server URL, port server URL, genomes) over one index; one pair
    at a time (each package keeps its server state in its module)."""
    gs, paths = panel
    jsrv = jserve.make_server(paths[request.param], 0, warmup=False)
    tsrv = tserve.make_server(paths[request.param], 0, device="cpu")
    assert tserve._State.engine.bv == (4 if request.param == "v4" else 0)
    yield _start(jsrv), _start(tsrv), gs
    for srv in (jsrv, tsrv):
        srv.shutdown()
        srv.server_close()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def _post(url, payload, raw: bytes | None = None):
    req = urllib.request.Request(
        url, raw if raw is not None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _sequences(gs):
    """Reads of 150 bp from two genomes (1 % substitutions), a few with N
    bases, one shorter than k and one repeated: search bodies."""
    rs = ts.reads(gs[:2], 400, 150, seed=62, sub_rate=0.01)
    seqs = [r.tobytes().decode() for r in rs]
    seqs[3] = seqs[3][:40] + "N" + seqs[3][41:]
    seqs[7] = seqs[7][: K - 2]
    seqs += [seqs[10]] * 3
    return seqs


def _pairs(gs, n: int, seed: int):
    """/classify reads: read_mix pairs (junk, chimeras, N bases, short and
    lowercase mates) as JSON strings."""
    return [
        {"id": f"p{i}", "seqs": [p[0].decode(), p[2].decode()]}
        for i, p in enumerate(ts.read_mix(gs, n, seed=seed))
    ]


def test_get_endpoints_and_errors_match_jax(servers):
    jurl, turl, _gs = servers
    for path in ("/healthz", "/info"):
        assert _get(turl + path) == _get(jurl + path)
    assert _get(turl + "/healthz")["n_colors"] == 4
    for url in (jurl, turl):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(url + "/nowhere")
        assert e.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url + "/search", None, raw=b"{not json")
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url + "/nowhere", {})
        assert e.value.code == 404


@pytest.mark.parametrize("body", [
    {"filter": -1}, {"filter": 0}, {"filter": 1, "p_shared": 0.01}, {"gene": True},
])
def test_search_matches_jax(servers, body):
    jurl, turl, gs = servers
    payload = dict(body, sequences=_sequences(gs))
    got = _post(turl + "/search", payload)
    assert got == _post(jurl + "/search", payload)
    assert got["num_kmers"] > 1000 and got["rows"]


def test_search_device_counting_equals_host_counting(servers, monkeypatch):
    """COLORID_SEARCH_READS=0 counts on the host and searches through
    search_keys: the same rows, N-containing and short sequences
    included."""
    _jurl, turl, gs = servers
    for body in ({"filter": -1}, {"filter": 1}, {"gene": True}):
        payload = dict(body, sequences=_sequences(gs))
        device = _post(turl + "/search", payload)
        monkeypatch.setenv("COLORID_SEARCH_READS", "0")
        host = _post(turl + "/search", payload)
        monkeypatch.delenv("COLORID_SEARCH_READS")
        assert device == host


def test_classify_matches_jax(servers):
    jurl, turl, gs = servers
    payload = {"reads": _pairs(gs, 60, seed=63), "fp_correct": 3.0}
    got = _post(turl + "/classify", payload)
    assert got == _post(jurl + "/classify", payload)
    calls = [r["classification"] for r in got["rows"]]
    assert len(calls) == 60 and sum(c.startswith("genome") for c in calls) > 20


def test_classify_concurrent_requests_coalesce(servers, monkeypatch):
    """24 concurrent 1-pair requests return the rows of a sequential run, in
    fewer classify_batch calls than requests."""
    _jurl, turl, gs = servers
    payloads = [{"reads": [p]} for p in _pairs(gs, 24, seed=64)]
    sequential = [_post(turl + "/classify", p)["rows"] for p in payloads]
    calls = []
    real = trid.classify_batch

    def counting(batch, *a, **kw):
        calls.append(len(batch))
        return real(batch, *a, **kw)

    # the batcher's worker binds classify_batch when it starts
    monkeypatch.setattr(trid, "classify_batch", counting)
    monkeypatch.setattr(tserve._State, "batcher", tserve._ClassifyBatcher())
    with ThreadPoolExecutor(max_workers=len(payloads)) as ex:
        concurrent = list(ex.map(lambda p: _post(turl + "/classify", p)["rows"], payloads))
    assert concurrent == sequential
    assert sum(calls) == len(payloads) and len(calls) < len(payloads), calls


def test_server_refuses_the_card_without_one(panel):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tserve.make_server(panel[1]["classic"], 0)
