"""trace.enabled() and span() of the port (colorid_tpu_torch/trace.py)
against the JAX package's (colorid_tpu/trace.py), with COLORID_TRACE unset,
empty, "0" and set: both read the variable once, at import, so each case
runs in a fresh interpreter."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = """
import sys
from colorid_tpu import trace as jt
from colorid_tpu_torch import trace as tt
print(jt.enabled(), tt.enabled())
with tt.span("port"):
    pass
with jt.span("jax"):
    pass
"""


@pytest.mark.parametrize("value,on", [(None, False), ("", False), ("0", False),
                                      ("1", True), ("yes", True)])
def test_enabled_matches_jax(value, on):
    env = {k: v for k, v in os.environ.items() if k != "COLORID_TRACE"}
    if value is not None:
        env["COLORID_TRACE"] = value
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    r = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == [str(on), str(on)]
    spans = [l.split(":")[0] for l in r.stderr.splitlines() if l.startswith("[trace]")]
    assert spans == (["[trace] port", "[trace] jax"] if on else [])
