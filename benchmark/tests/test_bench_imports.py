"""What a run loads: nothing whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``skelsplat_tpu`` (the JAX package; compared whole, so the
port ``skelsplat_tpu_torch`` passes), and the reference nothing of the
port."""

from __future__ import annotations

import json
import subprocess
import sys
import types

from conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "skelsplat_tpu"}


def _fresh(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=REPO, timeout=600)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_neither_jax_nor_the_jax_package(tiny_root):
    code = f"""
import contextlib, io, json, sys
sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'benchmark')!r}]
import run
with contextlib.redirect_stdout(io.StringIO()):
    rc = run.main(["--workload", "tiny.online", "--seed", "3", "--seconds",
                   "0.5"], root=__import__("pathlib").Path({str(tiny_root)!r}),
                  device="cpu")
print(json.dumps({{"rc": rc, "top": sorted({{m.split(".")[0]
                                           for m in sys.modules}})}}))
"""
    got = _fresh(code)
    assert got["rc"] == 0
    assert "skelsplat_tpu_torch" in got["top"]
    assert not FORBIDDEN & set(got["top"])


def test_the_reference_loads_nothing_of_the_program():
    code = f"""
import json, sys
sys.path[:0] = [{str(REPO / 'benchmark')!r}]
import reference.fit, skbench.inputs, skbench.check, skbench.k1work
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    top = set(_fresh(code))
    assert "torch" in top
    assert not (FORBIDDEN | {"skelsplat_tpu_torch", "skbench.program"}) & top


def test_run_refuses_when_the_jax_package_is_loaded(monkeypatch, capsys):
    import run

    monkeypatch.setitem(sys.modules, "skelsplat_tpu.engine",
                        types.ModuleType("skelsplat_tpu.engine"))
    rc = run.main(["--workload", "h36m.online", "--seed", "1", "--seconds",
                   "1"], device="cpu")
    cap = capsys.readouterr()
    assert rc == 3 and cap.out == ""
    assert "skelsplat_tpu.engine" in cap.err
