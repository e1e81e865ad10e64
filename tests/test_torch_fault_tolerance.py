"""Fault tolerance of the port: a checkpointed ``execute()`` SIGKILLed
mid-run in a child process resumes, in a fresh process, from its newest
committed checkpoint with ``resume_from(dir, device="cpu")`` — no spec
handed over, the plan rebuilt from the checkpoint's fingerprint — and
finishes BIT-identical to an uninterrupted run: weights and the whole
cumulative objective trace.  The port's counterpart of
``tests/test_fault_tolerance.py::test_sigkill_mid_execute_resumes_bit_identical``
and of ``benchmarks/fault_injection.py`` mode ``basic``, on the CPU.

Each child runs under its own timeout; the parent kills the victim as soon
as the first ``LATEST`` pointer is committed (the kill may land after the
victim finished, and the survivor must land on the same trajectory
either way).
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from tests.util import REPO, run_py

CASE = """
import numpy as np
from pathlib import Path
from repro_torch.api import (CheckpointPolicy, DataSource, ExperimentSpec,
                             execute, plan, resume_from)
from repro_torch.core import schemes
from repro_torch.data import dataset

work = Path(r"{work}")
corpus = work.parent / "corpus.bin"
if not corpus.exists():
    dataset.synth_erm_corpus(corpus, rows=3000, features=24, seed=9)
p = plan(ExperimentSpec(data=DataSource.corpus(corpus), solver="saga",
                        scheme={scheme}, step_size=0.05, batch_size=200,
                        epochs={epochs}, placement="{placement}",
                        checkpoint=CheckpointPolicy(work / "ckpt", every=1)),
         device="cpu")
try:
    res = resume_from(work / "ckpt", device="cpu")
    print("RESUMED", res.epochs_done, flush=True)
    p = res.plan
except FileNotFoundError:
    res = None
remaining = {epochs} - (res.epochs_done if res else 0)
r = execute(p, resume=res, epochs=remaining) if remaining else res
np.save(work / "w.npy", np.asarray(r.w))
np.save(work / "hist.npy", np.asarray(r.history))
print("DONE", r.epochs_done, flush=True)
"""

CASES = [("streamed", "'systematic'"), ("resident", "'cyclic'"),
         ("streamed", "schemes.ChunkImportance()")]
EPOCHS = 10
TIMEOUT = 120


def _kill_after_first_checkpoint(code: str, ckpt) -> None:
    proc = subprocess.Popen([sys.executable, "-c", code],
                            env=dict(os.environ,
                                     PYTHONPATH=str(REPO / "src")),
                            cwd=REPO, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    deadline = time.time() + TIMEOUT
    try:
        while time.time() < deadline:
            if (ckpt / "LATEST").exists() or proc.poll() is not None:
                break
            time.sleep(0.02)
    finally:
        proc.kill()
        proc.wait(timeout=TIMEOUT)


@pytest.mark.parametrize("placement,scheme", CASES,
                         ids=["streamed-systematic", "resident-cyclic",
                              "streamed-chunk_importance"])
def test_sigkill_mid_execute_resumes_bit_identical(tmp_path, placement,
                                                   scheme):
    fmt = dict(scheme=scheme, placement=placement, epochs=EPOCHS)
    ref = tmp_path / "ref"
    ref.mkdir()
    r = run_py(CASE.format(work=ref, **fmt), timeout=TIMEOUT)
    assert f"DONE {EPOCHS}" in r.stdout, r.stdout + r.stderr
    assert "RESUMED" not in r.stdout

    crash = tmp_path / "crash"
    crash.mkdir()
    _kill_after_first_checkpoint(CASE.format(work=crash, **fmt),
                                 crash / "ckpt")
    assert (crash / "ckpt" / "LATEST").exists()
    r2 = run_py(CASE.format(work=crash, **fmt), timeout=TIMEOUT)
    assert f"DONE {EPOCHS}" in r2.stdout, r2.stdout + r2.stderr
    assert "RESUMED" in r2.stdout, "the survivor did not resume"
    np.testing.assert_array_equal(np.load(ref / "w.npy"),
                                  np.load(crash / "w.npy"))
    np.testing.assert_array_equal(np.load(ref / "hist.npy"),
                                  np.load(crash / "hist.npy"))
