"""The PyTorch port stands alone: it imports neither JAX nor the reference
package, runs on the CPU only when asked, and keeps float32 strict."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch  # noqa: F401  (sets the precision flags)
from repro_torch.api import DataSource, ExperimentSpec, PlanError, plan

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_execute_on_cpu_leaves_jax_unimported(tmp_path):
    code = f"""
import sys
import numpy as np
import torch
from repro_torch.api import DataSource, ExperimentSpec, execute, plan
from repro_torch.data import dataset, sparse
from repro_torch.kernels import sparse_erm
p = {str(tmp_path / 'c.bin')!r}
dataset.synth_erm_corpus(p, rows=300, features=5, seed=0)
for placement, kernel in (("streamed", "auto"), ("resident", "fused")):
    r = execute(plan(ExperimentSpec(DataSource.corpus(p), solver="saga",
                                    batch_size=50, epochs=1,
                                    placement=placement, kernel=kernel),
                     device="cpu"))
    assert np.isfinite(r.objective)
c = {str(tmp_path / 'c.csr')!r}
sparse.synth_sparse_classification(c, rows=300, features=40, density=0.1)
r = execute(plan(ExperimentSpec(DataSource.corpus(c), solver="svrg",
                                batch_size=50, epochs=1), device="cpu"))
assert r.plan.backend == "sparse-csr" and np.isfinite(r.objective)
dev = sparse_erm.csr_to_device(sparse.open_csr_corpus(c), device="cpu")
sparse_erm.sparse_batch_grad(r.plan.spec.problem, dev,
                             torch.zeros(40), start=0, batch_size=50)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_plan_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = ExperimentSpec(DataSource.arrays(np.zeros((10, 3), np.float32),
                                            np.ones(10, np.float32)),
                          batch_size=5)
    with pytest.raises(PlanError, match='device="cpu"'):
        plan(spec)
    assert plan(spec, device="cpu").device == "cpu"


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
