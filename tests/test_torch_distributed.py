"""Two-process bring-up of the port's process group
(colorid_tpu_torch/parallel/distributed.py) on the CPU with the gloo
backend: both processes join over TCP, see a group of two, and one
all_reduce of ones sums over both (tests/test_distributed.py's check for
the JAX package). The workers import neither jax nor the JAX package."""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent(
    """
    import sys
    import torch
    import torch.distributed as dist
    from colorid_tpu_torch.parallel import distributed
    coord, pid = sys.argv[1], int(sys.argv[2])
    assert not distributed.is_multi_process()
    distributed.initialize(coord, num_processes=2, process_id=pid, backend="gloo")
    assert distributed.is_multi_process()
    assert dist.get_world_size() == 2 and dist.get_rank() == pid
    x = torch.ones(4, 2)
    dist.all_reduce(x)
    assert torch.equal(x, torch.full((4, 2), 2.0)), x
    dist.destroy_process_group()
    assert not distributed.is_multi_process()
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "colorid_tpu"))
    assert not leaked, leaked
    print(f"proc{pid} OK", flush=True)
    """
)


def test_two_process_all_reduce(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), coord, str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=ROOT, env=env,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("process group bring-up timed out")
        outs.append((p.returncode, out, err))
    for rc, _out, err in outs:
        assert rc == 0, err[-2000:]
    assert "proc0 OK" in outs[0][1]
    assert "proc1 OK" in outs[1][1]


def test_env_driven_single_process_group():
    """initialize() with no arguments reads MASTER_ADDR / MASTER_PORT /
    WORLD_SIZE / RANK; a group of one process is not multi-process."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = textwrap.dedent(
        """
        import torch, torch.distributed as dist
        from colorid_tpu_torch.parallel import distributed
        distributed.initialize(backend="gloo")
        assert dist.get_world_size() == 1 and not distributed.is_multi_process()
        x = torch.arange(3.0)
        dist.all_reduce(x)
        assert x.tolist() == [0.0, 1.0, 2.0]
        dist.destroy_process_group()
        print("OK")
        """
    )
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), WORLD_SIZE="1", RANK="0")
    r = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-2000:]
