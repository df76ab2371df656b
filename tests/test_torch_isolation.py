"""The port stands alone: none of its modules, and not ``chip_smoke.py``,
loads JAX or the JAX package.

Each check runs in a fresh interpreter (this test process has JAX loaded
already, through the repo's conftest).
"""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WALK = """
import importlib, pkgutil, sys
import hybrid_fem_lssvr_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "hybrid_fem_lssvr_tpu"))
print(len(names), " ".join(bad))
"""


def run(code_or_args, cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    args = (["-c", code_or_args] if isinstance(code_or_args, str)
            else code_or_args)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_and_chip_smoke_import_no_jax():
    out = run(WALK)
    assert out.returncode == 0, out.stderr
    count, *bad = out.stdout.split()
    assert bad == [], f"loaded: {bad}"
    # Every module of the package was walked (models, ops, utils, ...).
    assert int(count) >= 20


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_without_a_card_prints_no_result(where, tmp_path):
    """Without a CUDA device (this machine), or in a directory that holds
    chip_smoke.py and nothing else of the repo, the script exits non-zero
    before printing anything to its standard output."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; chip_smoke.py would run")
    cwd = ROOT
    if where == "alone":
        with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
            (tmp_path / "chip_smoke.py").write_text(fh.read())
        cwd = str(tmp_path)
    out = run(["chip_smoke.py"], cwd=cwd)
    assert out.returncode != 0
    assert out.stdout == ""


def test_spawned_rank_of_the_distributed_tests_loads_no_jax(tmp_path):
    """A rank of the distributed tests (``_torch_ranks.py``), spawned from
    this process that has JAX loaded, imports the port's distributed
    modules and loads no ``jax``, ``jaxlib`` or ``hybrid_fem_lssvr_tpu``
    module."""
    import _torch_ranks

    res = _torch_ranks.run_ranks(1, "_torch_ranks", ["isolation"], tmp_path)
    assert "error" not in res["isolation"], res["isolation"]["error"]
    assert list(res["isolation"]["modules"]) == []
    assert res["_modules"] == []
