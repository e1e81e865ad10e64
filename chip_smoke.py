#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py --quick    # small sizes: a build-and-check run

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, all at once)
   and print the build time and ``ptxas`` lines; generate the CSR corpus
   (100,000 x 65,536 at density 0.002, seed 0: the sparse benchmark default
   of ``benchmarks/erm_timing.py``) and a 1,000,000 x 18 dense corpus for
   phases 5 and 5b, and print how long that took;
2. each fused kernel against its plain PyTorch version on the card — the
   main-path shape (a 5,000,000 x 18 SUSY-shaped corpus resident, b = 500)
   and a wide case (l = 20,000, n = 4,096 and a ragged n = 1,000), three
   losses, starts of -5, l-b+7 and 0, row ids with duplicates — then each
   kernel's median time from CUDA events beside its bound, its plain
   version's and (where one PyTorch call computes the same) the library's;
2b. the CSR corpus staged with ``csr_to_device``; the sparse kernels' path:
   one MBSGD epoch per scheme driven through ``sparse_batch_grad`` and
   ``sparse_batch_objective`` (launches counted around it), its w held
   against the ``sparse-csr`` backend's; then each sparse kernel against its
   plain version on every batch of one epoch of each scheme (three losses),
   at clamped starts, and on a small hand-written corpus (an empty row, a
   repeated column, a row of 5,000 nonzeros); two calls of each kernel give
   equal bits; then each kernel's times beside its bound;
2c. the gather kernels against their plain versions, bit for bit: float32,
   bfloat16 and int32 (block) and float32, bfloat16 (rows) at the
   reference tests' shapes, every block index and clamped ones, duplicate
   and out-of-range ids, and the resident SUSY corpus; then their times at
   the SUSY shape, ``benchmarks/access_time.py``'s device shape (200,000 x
   100, b = 1,000) and the wide shape (20,000 x 4,096, b = 500);
2d. access time per scheme, the paper's §1-2 measurement: the host tier
   through ``DataPipeline.read_batch`` on a memmapped 200,000 x 100 corpus,
   the device tier through ``ops.random_gather`` (RS) and
   ``ops.block_gather`` (CS/SS) — the gather kernels' path, launches counted
   around it — with the RS/SS speedup beside ``access_model``'s prediction
   for every tier, and the card's ``hbm_dma`` constants from this run;
3. the main path at full size through ``plan()``/``execute()``: three
   resident-fused cells of 2 epochs and one streamed-eager epoch on the
   synthetic corpus, with every kernel's launch count read around the run;
3b. the CSR path at full size: three ``sparse-csr`` cells of 2 epochs, and
   saga/systematic once more for bitwise-equal w;
4. the 45-cell matrix (5 solvers x RS/CS/SS x constant / vectorized /
   sequential line search) at l = 20,000: every kernel against its plain
   version at every step of the eager trajectory, and resident-fused
   against resident-eager on the final w;
4b. the 15 constant-step cells at l = 2,000, n = 4,096, density 0.01,
   b = 100: ``sparse-csr`` on the CSR corpus against ``streamed-eager`` on
   the same corpus densified, on the final w;
5. durable runs at full size — resident-fused and streamed-eager
   saga/systematic on the SUSY corpus, ``sparse-csr`` saga/systematic on
   the CSR corpus: 2 epochs with ``CheckpointPolicy(every=1)``, then 1
   epoch, ``resume_from(dir)`` with no plan and 1 more, bitwise equal; the
   seconds per save from the CHECKPOINT lane and the bytes per snapshot;
5b. ``chunk_importance`` and ``stochastic_batch`` streamed at n = 18 for 2
   epochs, objectives finite and below the value at w = 0;
5/5b. SIGKILL and resume in child processes (``benchmarks/
   fault_injection.py`` mode ``basic``): resident-fused saga/systematic and
   each adaptive scheme, the victims killed after their first ``LATEST``,
   each survivor bitwise equal to an uninterrupted run;
6. one JSON line of kernel records, the ``nvidia-smi`` line, and the
   device record as the last line.

Details go to ``chip_smoke.json`` in ``--out`` (default
``artifacts/chip_smoke/``).  Needs no network; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
SOURCE = "src/repro_torch/kernels/csrc/fused_erm.cu"
REPLACES = {"fused_grad_block": "src/repro/kernels/fused_erm.py:140",
            "fused_grad_rows": "src/repro/kernels/fused_erm.py:197",
            "fused_margins_block": "src/repro/kernels/fused_erm.py:254",
            "fused_margins_rows": "src/repro/kernels/fused_erm.py:290"}
SPARSE_SOURCE = "src/repro_torch/kernels/csrc/sparse_erm.cu"
GATHER_SOURCE = "src/repro_torch/kernels/csrc/sampled_gather.cu"
GATHER_REPLACES = {"block_gather": "src/repro/kernels/sampled_gather.py:34",
                   "random_gather": "src/repro/kernels/sampled_gather.py:58"}
SPARSE_REPLACES = {"sparse_grad_rows": "src/repro/kernels/sparse_erm.py:180",
                   "sparse_grad_block": "src/repro/kernels/sparse_erm.py:260",
                   "sparse_margins_rows": "src/repro/kernels/sparse_erm.py:339",
                   "sparse_margins_block":
                       "src/repro/kernels/sparse_erm.py:405"}
B = 500
CSR_FEATURES, CSR_DENSITY = 65_536, 0.002


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def device_ms(torch, fn, reps: int) -> float:
    """Median device time of ``fn(i)`` over ``reps`` runs after a warm-up.
    A spin kernel first lets the host queue every run ahead of the card, so
    each event pair brackets device work only, not host launch overhead."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for i, (a, b) in enumerate(ev):
        a.record()
        fn(i)
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def host_ms(torch, fn, reps: int) -> float:
    """Wall time per call of ``fn`` back to back, synchronised at the end:
    what a Python loop of such calls pays (host launch cost included)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(i)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def hold(torch, errs, name, k, p, tag, rel=1e-4):
    """Kernel output ``k`` against its plain version ``p``: max|k - p| <=
    rel max|p| + 1e-6, and ``k`` finite; the worst error goes into
    ``errs``.  The sparse kernels take rel = 1e-4: float32 sums of up to
    thousands of products in another order."""
    torch.cuda.synchronize()
    err = (k - p).abs().max().item()
    tol = rel * p.abs().max().item() + 1e-6
    errs[name] = max(errs.get(name, 0.0), err)
    if not (err <= tol and torch.isfinite(k).all().item()):
        raise AssertionError(f"{name} {tag}: max|k-p| = {err:.3e} > "
                             f"{tol:.3e}")


def check_kernels(torch, fe, X, y, tag, errs):
    """Every kernel against its plain version on (X, y); record max |k - p|
    per kernel in ``errs``.  Tolerance max|k - p| <= rel * max|p| + 1e-6,
    rel = 1e-5 at n = 18 and 1e-4 at n >= 1,000 (that many float32
    products summed in another order)."""
    l, n = X.shape
    rel = 1e-5 if n < 1000 else 1e-4
    g = torch.Generator(device="cuda").manual_seed(n)
    w = torch.randn(n, device="cuda", generator=g) / math.sqrt(n)
    idx = torch.randint(0, l, (B,), device="cuda", generator=g,
                        dtype=torch.int32)
    idx[1], idx[7], idx[8] = idx[0], 0, l - 1      # duplicates, both ends
    idx[9] = idx[8]
    starts = [-5, l - B + 7, 0, torch.tensor(l // 3, dtype=torch.int32,
                                             device="cuda")]

    def cmp(name, k, p):
        hold(torch, errs, name, k, p, tag, rel)

    for s in starts:
        cmp("fused_margins_block", fe.fused_margins_block(X, w, s,
                                                          batch_size=B),
            fe._margins_block_plain(X, w, s, B))
        for loss in fe.LOSSES:
            cmp("fused_grad_block",
                fe.fused_grad_block(X, y, w, s, loss=loss, batch_size=B),
                fe._grad_block_plain(X, y, w, s, B, loss))
    cmp("fused_margins_rows", fe.fused_margins_rows(X, w, idx),
        fe._margins_rows_plain(X, w, idx))
    for loss in fe.LOSSES:
        cmp("fused_grad_rows", fe.fused_grad_rows(X, y, w, idx, loss=loss),
            fe._grad_rows_plain(X, y, w, idx, loss))
    log(f"  {tag}: all kernels agree with their plain versions "
        f"(rel tol {rel:g})")


def time_kernels(torch, fe, X, y, reps):
    """Per kernel: device ms, host ms, plain ms, library ms, bound ms.
    Each run reads another block / row set, as the main path does."""
    l, n = X.shape
    g = torch.Generator(device="cuda").manual_seed(7)
    w = torch.randn(n, device="cuda", generator=g) / math.sqrt(n)
    nt = 64
    starts = torch.randint(0, l - B + 1, (nt,), device="cuda", generator=g,
                           dtype=torch.int32)
    starts_h = starts.tolist()
    idx = torch.randint(0, l, (nt, B), device="cuda", generator=g,
                        dtype=torch.int32)
    loss = "logistic"
    xb = B * n * 4
    bytes_ = {"fused_margins_block": xb + n * 4 + 4 + B * 4,
              "fused_margins_rows": xb + n * 4 + B * 4 + B * 4,
              "fused_grad_block": xb + B * 4 + n * 4 + 4 + n * 4,
              "fused_grad_rows": xb + B * 4 + n * 4 + B * 4 + n * 4}
    ops = {"fused_margins_block": 2 * B * n, "fused_margins_rows": 2 * B * n,
           "fused_grad_block": 4 * B * n + 8 * B,
           "fused_grad_rows": 4 * B * n + 8 * B}
    calls = {
        "fused_margins_block": (
            lambda i: fe.fused_margins_block(X, w, starts[i % nt],
                                             batch_size=B),
            lambda i: fe._margins_block_plain(X, w, starts[i % nt], B),
            lambda i: torch.mv(X.narrow(0, starts_h[i % nt], B), w)),
        "fused_margins_rows": (
            lambda i: fe.fused_margins_rows(X, w, idx[i % nt]),
            lambda i: fe._margins_rows_plain(X, w, idx[i % nt]), None),
        "fused_grad_block": (
            lambda i: fe.fused_grad_block(X, y, w, starts[i % nt], loss=loss,
                                          batch_size=B),
            lambda i: fe._grad_block_plain(X, y, w, starts[i % nt], B, loss),
            None),
        "fused_grad_rows": (
            lambda i: fe.fused_grad_rows(X, y, w, idx[i % nt], loss=loss),
            lambda i: fe._grad_rows_plain(X, y, w, idx[i % nt], loss),
            None)}
    out = {}
    for name, (kern, plain, lib) in calls.items():
        t_bytes = bytes_[name] / HBM_BYTES_PER_S * 1e3
        t_ops = ops[name] / F32_OPS_PER_S * 1e3
        out[name] = {
            "ms": device_ms(torch, kern, reps),
            "host_ms": host_ms(torch, kern, reps),
            "plain_ms": device_ms(torch, plain, reps),
            "library_ms": None if lib is None else device_ms(torch, lib,
                                                             reps),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_[name], "ops": ops[name], "shape": [l, n, B]}
    return out


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path
# ---------------------------------------------------------------------------

def run_cell(api, fe, path, solver, scheme, step_mode, f0):
    from repro_torch.obs import TracePolicy
    spec = api.ExperimentSpec(api.DataSource.corpus(path), solver=solver,
                              scheme=scheme, step_mode=step_mode,
                              batch_size=B, epochs=2, trace=TracePolicy())
    p = api.plan(spec)
    if p.backend != api.RESIDENT_FUSED:
        raise AssertionError(f"auto plan chose {p.backend}, not "
                             f"resident-fused:\n{p.describe()}")
    before = dict(fe.LAUNCHES)
    r = api.execute(p)
    launched = {k: fe.LAUNCHES[k] - before[k] for k in fe.LAUNCHES}
    hist = [float(h) for h in r.history]
    if not all(math.isfinite(h) and h < f0 for h in hist):
        raise AssertionError(f"{solver}/{scheme}/{step_mode}: objectives "
                             f"{hist} not finite and below {f0}")
    # SAGA at the constant step 1/L wanders above its best objective once
    # near it, the reference as much as the port (see
    # tests/test_torch_experiment.py::
    # test_saga_constant_step_history_matches_reference); every other cell
    # must descend from epoch to epoch
    wanders = solver == "saga" and step_mode == "constant"
    if not wanders and any(b >= a for a, b in zip(hist, hist[1:])):
        raise AssertionError(f"{solver}/{scheme}/{step_mode}: objective "
                             f"rose between epochs: {hist}")
    r.verify_timeline()
    bd = r.breakdown()
    log(f"  {solver}/{scheme}/{p.step_rule}: epoch_s "
        f"{bd['epoch_s']:.3f}, objective {r.objective:.6f} "
        f"(history {[round(h, 6) for h in hist]}), launches "
        f"{ {k: v for k, v in launched.items() if v} }")
    return {"solver": solver, "scheme": scheme, "step_rule": p.step_rule,
            "backend": p.backend, "epoch_s": bd["epoch_s"],
            "compute_s_per_epoch": bd["compute_s_per_epoch"],
            "h2d_s_per_epoch": bd["h2d_s_per_epoch"],
            "objective": r.objective,
            "history": hist,
            "launches": launched, "m": p.num_batches}


def main_path(api, fe, path, rows, n):
    f0 = math.log(2.0)          # logistic objective at w = 0
    cells = [("saga", "systematic", "constant"),
             ("svrg", "random", "line_search"),
             ("saag2", "cyclic", "line_search")]
    fe.reset_launches()
    out = [run_cell(api, fe, path, *c, f0) for c in cells]
    launches = dict(fe.LAUNCHES)
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name} was never launched on the main "
                                 f"path")
    for cell, want in zip(out, (("fused_grad_block",),
                                ("fused_grad_rows", "fused_margins_rows"),
                                ("fused_grad_block", "fused_margins_block"))):
        if not all(cell["launches"][k] > 0 for k in want):
            raise AssertionError(f"cell {cell['solver']}/{cell['scheme']} "
                                 f"did not launch {want}")

    # one streamed-eager epoch over the same corpus; prefetch=0 so the
    # producer reads exactly the consumed batches
    spec = api.ExperimentSpec(api.DataSource.corpus(path), solver="saga",
                              scheme="systematic", batch_size=B, epochs=1,
                              placement="streamed", prefetch=0)
    p = api.plan(spec)
    assert p.backend == api.STREAMED_EAGER, p.backend
    before = dict(fe.LAUNCHES)
    r = api.execute(p)
    m = -(-rows // B)
    want = m * B * (n + 1) * 4
    if r.stats.bytes_read != want:
        raise AssertionError(f"streamed bytes_read {r.stats.bytes_read} != "
                             f"{want}")
    if not (math.isfinite(r.objective) and r.objective < f0):
        raise AssertionError(f"streamed objective {r.objective}")
    if fe.LAUNCHES != before:
        raise AssertionError("the streamed-eager backend launched a fused "
                             "kernel")
    bd = r.breakdown()
    log(f"  streamed-eager saga/systematic: epoch_s {bd['epoch_s']:.3f}, "
        f"objective {r.objective:.6f}, bytes_read {r.stats.bytes_read}")
    streamed = {"epoch_s": bd["epoch_s"], "objective": r.objective,
                "bytes_read": r.stats.bytes_read,
                "access_s_per_epoch": bd["access_s_per_epoch"],
                "h2d_s_per_epoch": bd["h2d_s_per_epoch"],
                "compute_s_per_epoch": bd["compute_s_per_epoch"]}
    return out, launches, streamed


def lockstep(torch, fe, p, X, y):
    """Rerun plan ``p`` on the card as resident-fused and as resident-eager
    side by side, with the arithmetic of ``fused_batch_step`` and
    ``batch_step``, and at every step hold the fused kernels against their
    plain versions on the eager side's inputs: the data gradient at w (and
    at the snapshot), and under a line search the margins at w and along v.
    Returns the worst of max|k - q| / (1e-4 max|q| + 1e-6) over the run (at
    most 1 passes), and the number of steps at which the two sides' step
    rules picked different step sizes."""
    from repro_torch.core import samplers, solvers, step_rules
    from repro_torch.core.erm import block_rows
    prob, cfg, b = p.spec.problem, p.cfg, p.spec.batch_size
    rule = step_rules.from_config(cfg)
    snap = cfg.solver in ("svrg", "saag2")
    st = {fused: solvers.init_state(cfg.solver, torch.zeros(
        p.features, device="cuda"), p.num_batches) for fused in (True, False)}
    worst = torch.zeros((), device="cuda")
    splits = torch.zeros((), dtype=torch.int64, device="cuda")

    def hold(k, q):
        nonlocal worst
        r = (k - q).abs().max() / (1e-4 * q.abs().max() + 1e-6)
        worst = torch.maximum(worst, torch.where(torch.isfinite(k).all(), r,
                                                 torch.inf))

    for e in range(p.spec.epochs):
        st = {f: solvers.resident_epoch_begin(prob, cfg, s, X, y)
              for f, s in st.items()}
        sched = torch.from_numpy(samplers.epoch_schedule(
            p.scheme_obj, p.spec.seed, e, p.rows, b)).cuda()
        for j in range(sched.shape[0]):
            if sched.dim() == 1:
                kw = dict(start=sched[j], batch_size=b)
                rows = block_rows(sched[j], p.rows, b)
            else:
                kw, rows = dict(idx=sched[j]), sched[j]
            Xb, yb = X.index_select(0, rows), y.index_select(0, rows)
            kernel = lambda u: fe.fused_batch_grad_data(prob, X, y, u, **kw)
            alpha = {}
            for fused, s in st.items():
                if fused:
                    grad = kernel
                    probe = (step_rules.fused_probe(prob, X, y, **kw)
                             if rule.needs_probe else None)
                else:
                    grad = lambda u: prob.batch_grad_data(u, Xb, yb)
                    probe = step_rules.dense_probe(prob, Xb, yb)
                gd = grad(s.w)
                gs = grad(s.snapshot) if snap else None
                if not fused:
                    hold(kernel(s.w), gd)
                    if snap:
                        hold(kernel(s.snapshot), gs)
                v, g, new = solvers._solver_direction(prob, cfg, s, j, gd, gs)
                if rule.needs_probe and not fused:
                    hold(fe.fused_batch_margins(X, s.w, **kw), Xb @ s.w)
                    hold(fe.fused_batch_margins(X, v, **kw), Xb @ v)
                alpha[fused] = rule.pick(probe, s.w, v, g)
                st[fused] = new._replace(w=s.w - alpha[fused] * v)
            splits += alpha[True] != alpha[False]
    return worst.item(), int(splits.item())


def matrix(torch, api, fe, rows, n):
    """45 cells, resident-fused against resident-eager on the card.  In
    every cell :func:`lockstep` holds the fused kernels against their plain
    versions at every step (rtol 1e-4, no exemption).  The two backends'
    final w must then agree at rtol 1e-4 / atol 1e-6, unless the lockstep
    saw their line searches pick different rungs at some step: an Armijo
    test within float32 rounding of a tie, after which the two runs part by
    a step however accurate the kernels are."""
    rng = np.random.default_rng(1)
    X = rng.normal(size=(rows, n)).astype(np.float32)
    w_true = rng.normal(size=n) / math.sqrt(n)
    y = np.where(rng.uniform(size=rows) < 1 / (1 + np.exp(-2 * X @ w_true)),
                 1.0, -1.0).astype(np.float32)
    data = api.DataSource.arrays(X, y)
    Xd, yd = torch.from_numpy(X).cuda(), torch.from_numpy(y).cuda()
    out = []
    t0 = time.perf_counter()
    for solver in api.SOLVERS:
        for scheme in api.SCHEMES:
            for step_mode, ls_mode in (("constant", "auto"),
                                       ("line_search", "vectorized"),
                                       ("line_search", "sequential")):
                w, plans = {}, {}
                for kernel in ("fused", "eager"):
                    spec = api.ExperimentSpec(
                        data, solver=solver, scheme=scheme,
                        step_mode=step_mode, ls_mode=ls_mode, batch_size=B,
                        epochs=2, kernel=kernel, record_objective=False)
                    plans[kernel] = api.plan(spec)
                    w[kernel] = api.execute(plans[kernel]).w
                cell = f"{solver}/{scheme}/{plans['fused'].step_rule}"
                ratio, splits = lockstep(torch, fe, plans["fused"], Xd, yd)
                if not ratio <= 1.0:
                    raise AssertionError(
                        f"{cell}: a fused kernel differs from its plain "
                        f"version by {ratio:.3g}x the tolerance "
                        f"1e-4 max|p| + 1e-6 at some step")
                close = bool(np.allclose(w["fused"], w["eager"], rtol=1e-4,
                                         atol=1e-6))
                dw = np.abs(w["fused"] - w["eager"])
                if not close and splits == 0:
                    raise AssertionError(
                        f"{cell}: fused and eager w differ beyond rtol 1e-4 "
                        f"(max |dw| {dw.max():.3e}) with no split rung")
                out.append({"cell": cell, "kernel_ratio": ratio,
                            "split_steps": splits, "w_close": close,
                            "max_abs_dw": float(dw.max()),
                            "max_rel_dw": float(np.max(
                                dw / (np.abs(w["eager"]) + 1e-6)))})
                if not close:
                    log(f"  {cell}: the line search split at {splits} "
                        f"step(s); w parts by max |dw| {dw.max():.3e}")
    closed = [c for c in out if c["w_close"]]
    log(f"  45 cells: kernels within tolerance at every step (worst "
        f"{max(c['kernel_ratio'] for c in out):.3g} of it); "
        f"{len(closed)} cells' w within rtol 1e-4 (worst relative difference "
        f"{max((c['max_rel_dw'] for c in closed), default=0.0):.3e}); "
        f"{sum(c['split_steps'] > 0 for c in out)} cells with a split rung; "
        f"{time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 2b: the sparse kernels
# ---------------------------------------------------------------------------

def sparse_kernel_path(torch, api, se, dev, path, l, n):
    """The sparse kernels' own path, as a user reaches them: MBSGD at the
    planner's constant step 1/L for one epoch of each scheme, every step's
    gradient from ``sparse_batch_grad`` and every batch's objective from
    ``sparse_batch_objective`` on the staged corpus.  The launch counts are
    read around this run.  Each final w is then held against the
    ``sparse-csr`` backend's (the same cell through ``plan()``/
    ``execute()``, padded-ELL steps over the same batches) at rtol 1e-4 /
    atol 1e-6."""
    from repro_torch.core import samplers
    runs = {}
    se.reset_launches()
    for scheme in api.SCHEMES:
        p = api.plan(api.ExperimentSpec(
            api.DataSource.corpus(path), solver="mbsgd", scheme=scheme,
            batch_size=B, epochs=1, record_objective=False))
        prob, step = p.spec.problem, p.cfg.step_size
        sched = torch.from_numpy(samplers.epoch_schedule(scheme, 0, 0, l,
                                                         B)).cuda()
        w = torch.zeros(n, device="cuda")
        objs = torch.empty(sched.shape[0], device="cuda")
        for j in range(sched.shape[0]):
            kw = (dict(start=sched[j], batch_size=B) if sched.dim() == 1
                  else dict(idx=sched[j]))
            objs[j] = se.sparse_batch_objective(prob, dev, w, **kw)
            w = w - step * se.sparse_batch_grad(prob, dev, w, **kw)
        runs[scheme] = (p, w, objs)
    torch.cuda.synchronize()
    launches = dict(se.LAUNCHES)
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name} was never launched on the sparse "
                                 f"kernels' path")
    out = []
    f0 = math.log(2.0)
    for scheme, (p, w, objs) in runs.items():
        mean_obj = objs.mean().item()
        if not (torch.isfinite(objs).all().item() and mean_obj < f0):
            raise AssertionError(f"kernel path {scheme}: mean batch "
                                 f"objective {mean_obj} not finite and "
                                 f"below {f0}")
        ref = api.execute(p).w
        wk = w.cpu().numpy()
        dw = np.abs(wk - ref)
        if not np.allclose(wk, ref, rtol=1e-4, atol=1e-6):
            raise AssertionError(f"kernel path {scheme}: w differs from the "
                                 f"sparse-csr backend's by max |dw| "
                                 f"{dw.max():.3e}")
        out.append({"scheme": scheme, "mean_batch_objective": mean_obj,
                    "max_abs_dw": float(dw.max()),
                    "max_rel_dw": float(np.max(dw / (np.abs(ref) + 1e-6)))})
        log(f"  kernel path mbsgd/{scheme}: mean batch objective "
            f"{mean_obj:.6f}, w within rtol 1e-4 of sparse-csr (max |dw| "
            f"{dw.max():.3e})")
    log(f"  launches on the kernel path: {launches}")
    return launches, out


def check_sparse_batches(torch, se, dev, w, kw, tag, errs):
    """Every sparse kernel against its plain version on one batch: the
    margins, and the gradient under each loss."""
    from repro_torch.core.erm import LOSSES
    a = (dev.vals, dev.cols, dev.indptr)
    if "start" in kw:
        s, b = kw["start"], kw["batch_size"]
        hold(torch, errs, "sparse_margins_block",
             se.sparse_margins_block(*a, w, s, batch_size=b),
             se._margins_block_plain(*a, w, s, b), tag)
        for loss in LOSSES:
            hold(torch, errs, "sparse_grad_block",
                 se.sparse_grad_block(*a, dev.y, w, s, loss=loss,
                                      batch_size=b),
                 se._grad_block_plain(*a, dev.y, w, s, b, loss), tag)
    else:
        idx = kw["idx"]
        hold(torch, errs, "sparse_margins_rows",
             se.sparse_margins_rows(*a, w, idx),
             se._margins_rows_plain(*a, w, idx), tag)
        for loss in LOSSES:
            hold(torch, errs, "sparse_grad_rows",
                 se.sparse_grad_rows(*a, dev.y, w, idx, loss=loss),
                 se._grad_rows_plain(*a, dev.y, w, idx, loss), tag)


def hand_corpus(sparse, path):
    """16 rows over 8,192 features: an empty row, a row whose columns repeat
    (3, 3, 7, 7, 7), a row of 5,000 nonzeros, and 13 short rows."""
    rng = np.random.default_rng(2)
    n = 8192
    rows = [(np.zeros(0, np.int32), np.zeros(0)),
            (np.array([3, 3, 7, 7, 7, 100], np.int32), rng.normal(size=6)),
            (np.sort(rng.choice(n, 5000, replace=False)), rng.normal(size=5000))]
    for _ in range(13):
        k = int(rng.integers(1, 40))
        rows.append((np.sort(rng.choice(n, k, replace=False)),
                     rng.normal(size=k)))
    lens = [len(c) for c, _ in rows]
    sparse.write_csr_corpus(
        path, indptr=np.concatenate([[0], np.cumsum(lens)]),
        indices=np.concatenate([c for c, _ in rows]),
        values=np.concatenate([v for _, v in rows]),
        labels=np.where(rng.uniform(size=len(rows)) < 0.5, 1.0, -1.0),
        features=n)
    return sparse.open_csr_corpus(path)


def check_sparse_kernels(torch, se, sparse, dev, l, n, root, errs):
    """Phase 2b's card checks (the launches here do not count)."""
    from repro_torch.core import samplers
    g = torch.Generator(device="cuda").manual_seed(5)
    w = torch.randn(n, device="cuda", generator=g) * 0.1
    for scheme in ("random", "cyclic", "systematic"):
        sched = torch.from_numpy(samplers.epoch_schedule(scheme, 0, 0, l,
                                                         B)).cuda()
        for j in range(sched.shape[0]):
            kw = (dict(start=sched[j], batch_size=B) if sched.dim() == 1
                  else dict(idx=sched[j]))
            check_sparse_batches(torch, se, dev, w, kw, f"{scheme} batch {j}",
                                 errs)
    for s in (-5, 0, l - B, l - B + 7,
              torch.tensor(l // 3, dtype=torch.int32, device="cuda")):
        check_sparse_batches(torch, se, dev, w, dict(start=s, batch_size=B),
                             f"start {s}", errs)
    idx = torch.randint(0, l, (B,), device="cuda", generator=g,
                        dtype=torch.int32)
    idx[1], idx[7], idx[8], idx[9] = idx[0], 0, l - 1, l - 1
    check_sparse_batches(torch, se, dev, w, dict(idx=idx), "rows with "
                         "duplicates", errs)
    log(f"  every batch of one epoch of RS/CS/SS, clamped starts and "
        f"duplicate rows: all four kernels agree with their plain versions")

    hand = hand_corpus(sparse, root / "hand.csr")
    hd = se.csr_to_device(hand, batch_size=8)
    wh = torch.randn(hand.features, device="cuda", generator=g) * 0.1
    for s in (0, 1, 8, 20):
        check_sparse_batches(torch, se, hd, wh, dict(start=s, batch_size=8),
                             f"hand corpus start {s}", errs)
    check_sparse_batches(
        torch, se, hd, wh,
        dict(idx=torch.tensor([2, 0, 1, 1, 15, 2, 9, 0], dtype=torch.int32,
                              device="cuda")), "hand corpus rows", errs)
    z = se.sparse_margins_rows(hd.vals, hd.cols, hd.indptr, wh,
                               torch.zeros(1, dtype=torch.int32,
                                           device="cuda"))
    if z.item() != 0.0:
        raise AssertionError(f"the empty row's margin is {z.item()}, not 0")
    log("  hand corpus (empty row, repeated column, 5,000-nonzero row): "
        "agree")

    a = (dev.vals, dev.cols, dev.indptr)
    start = torch.tensor(l // 2, dtype=torch.int32, device="cuda")
    calls = {
        "sparse_grad_block": lambda: se.sparse_grad_block(
            *a, dev.y, w, start, loss="logistic", batch_size=B),
        "sparse_grad_rows": lambda: se.sparse_grad_rows(
            *a, dev.y, w, idx, loss="logistic"),
        "sparse_margins_block": lambda: se.sparse_margins_block(
            *a, w, start, batch_size=B),
        "sparse_margins_rows": lambda: se.sparse_margins_rows(*a, w, idx)}
    for name, call in calls.items():
        first, second = call(), call()
        torch.cuda.synchronize()
        if not torch.equal(first, second):
            raise AssertionError(f"{name}: two calls on the same inputs gave "
                                 f"different bits")
    log("  two calls of each sparse kernel give equal bits")


def time_sparse_kernels(torch, se, dev, csr, l, n, reps):
    """Per sparse kernel: device ms, host ms, plain ms, library ms (the
    margins block only: ``torch.mv`` on a sparse CSR view of the block,
    cuSPARSE), and the bound from the bytes this run's batches need — their
    nonzeros' vals and cols, the distinct w entries they touch, their
    indptr entries, labels, schedule entry and output, each once."""
    from repro_torch.core import samplers
    ss = samplers.epoch_schedule("systematic", 0, 0, l, B)[:64]
    rs = samplers.epoch_schedule("random", 0, 0, l, B)[:64]
    nt = len(ss)
    starts, idx = torch.from_numpy(ss).cuda(), torch.from_numpy(rs).cuda()
    ptr = np.asarray(csr.indptr)
    cols_h = np.asarray(csr.indices)
    g = torch.Generator(device="cuda").manual_seed(7)
    w = torch.randn(n, device="cuda", generator=g) * 0.1
    a = (dev.vals, dev.cols, dev.indptr)

    def need(rows):
        """(nonzeros, distinct columns) of a batch's rows."""
        segs = [cols_h[ptr[r]:ptr[r + 1]] for r in rows]
        return (int(sum(len(c) for c in segs)),
                len(np.unique(np.concatenate(segs))))

    blk = [need(range(s, s + B)) for s in ss]
    rws = [need(r) for r in rs]
    nnz_b = statistics.mean(x for x, _ in blk)
    nnz_r = statistics.mean(x for x, _ in rws)
    uniq_b = statistics.mean(u for _, u in blk)
    uniq_r = statistics.mean(u for _, u in rws)
    ptr_b, ptr_r = (B + 1) * 4 + 4, 2 * B * 4 + B * 4   # indptr + schedule
    bytes_ = {
        "sparse_margins_block": nnz_b * 8 + uniq_b * 4 + ptr_b + B * 4,
        "sparse_margins_rows": nnz_r * 8 + uniq_r * 4 + ptr_r + B * 4,
        "sparse_grad_block": nnz_b * 8 + uniq_b * 4 + ptr_b + B * 4 + n * 4,
        "sparse_grad_rows": nnz_r * 8 + uniq_r * 4 + ptr_r + B * 4 + n * 4}
    ops = {"sparse_margins_block": 2 * nnz_b, "sparse_margins_rows": 2 * nnz_r,
           "sparse_grad_block": 4 * nnz_b + 8 * B,
           "sparse_grad_rows": 4 * nnz_r + 8 * B}
    lib_a = []
    with warnings.catch_warnings():       # "sparse CSR support is beta"
        warnings.simplefilter("ignore", UserWarning)
        for s in ss:
            e0, e1 = int(ptr[s]), int(ptr[s + B])
            lib_a.append(torch.sparse_csr_tensor(
                dev.indptr[s:s + B + 1] - e0, dev.cols[e0:e1],
                dev.vals[e0:e1], size=(B, n), check_invariants=False))
    loss = "logistic"
    calls = {
        "sparse_margins_block": (
            lambda i: se.sparse_margins_block(*a, w, starts[i % nt],
                                              batch_size=B),
            lambda i: se._margins_block_plain(*a, w, starts[i % nt], B),
            lambda i: torch.mv(lib_a[i % nt], w)),
        "sparse_margins_rows": (
            lambda i: se.sparse_margins_rows(*a, w, idx[i % nt]),
            lambda i: se._margins_rows_plain(*a, w, idx[i % nt]), None),
        "sparse_grad_block": (
            lambda i: se.sparse_grad_block(*a, dev.y, w, starts[i % nt],
                                           loss=loss, batch_size=B),
            lambda i: se._grad_block_plain(*a, dev.y, w, starts[i % nt], B,
                                           loss), None),
        "sparse_grad_rows": (
            lambda i: se.sparse_grad_rows(*a, dev.y, w, idx[i % nt],
                                          loss=loss),
            lambda i: se._grad_rows_plain(*a, dev.y, w, idx[i % nt], loss),
            None)}
    for i in range(nt):      # the library's answer is the kernel's
        torch.testing.assert_close(calls["sparse_margins_block"][2](i),
                                   calls["sparse_margins_block"][0](i),
                                   rtol=1e-4, atol=1e-6)
    out = {}
    for name, (kern, plain, lib) in calls.items():
        t_bytes = bytes_[name] / HBM_BYTES_PER_S * 1e3
        t_ops = ops[name] / F32_OPS_PER_S * 1e3
        out[name] = {
            "ms": device_ms(torch, kern, reps),
            "host_ms": host_ms(torch, kern, reps),
            "plain_ms": device_ms(torch, plain, reps),
            "library_ms": None if lib is None else device_ms(torch, lib,
                                                             reps),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_[name], "ops": ops[name],
            "shape": [l, n, B], "nnz_per_batch": nnz_b if "block" in name
            else nnz_r}
    return out


# ---------------------------------------------------------------------------
# phases 3b and 4b: the CSR path
# ---------------------------------------------------------------------------

def csr_main_path(api, fe, se, path):
    """Three ``sparse-csr`` cells of 2 epochs at full size, then saga/SS
    again for bitwise-equal w.  The backend steps on padded-ELL batches, as
    the reference's does, and launches no kernel."""
    from repro_torch.obs import TracePolicy
    f0 = math.log(2.0)
    cells = [("saga", "systematic", "constant"),
             ("svrg", "random", "line_search"),
             ("saag2", "cyclic", "line_search")]
    before = {**fe.LAUNCHES, **se.LAUNCHES}
    out, ws = [], {}
    for solver, scheme, step_mode in cells + [cells[0]]:
        spec = api.ExperimentSpec(api.DataSource.corpus(path), solver=solver,
                                  scheme=scheme, step_mode=step_mode,
                                  batch_size=B, epochs=2, trace=TracePolicy())
        p = api.plan(spec)
        if p.backend != api.SPARSE_CSR:
            raise AssertionError(f"a CSR corpus planned to {p.backend}")
        r = api.execute(p)
        hist = [float(h) for h in r.history]
        cell = f"{solver}/{scheme}/{p.step_rule}"
        if not all(math.isfinite(h) and h < f0 for h in hist):
            raise AssertionError(f"csr {cell}: objectives {hist} not finite "
                                 f"and below {f0}")
        if step_mode == "line_search" and not hist[1] < hist[0]:
            raise AssertionError(f"csr {cell}: objective rose: {hist}")
        r.verify_timeline()
        if cell in ws:
            if not np.array_equal(ws[cell], r.w):
                raise AssertionError(f"csr {cell}: a second run gave other "
                                     f"bits in w (max |dw| "
                                     f"{np.abs(ws[cell] - r.w).max():.3e})")
            log(f"  csr {cell} again: bitwise-equal w")
            continue
        ws[cell] = r.w
        bd, st = r.breakdown(), r.stats
        log(f"  csr {cell}: epoch_s {bd['epoch_s']:.3f} (access "
            f"{bd['access_s_per_epoch']:.3f}, h2d {bd['h2d_s_per_epoch']:.3f},"
            f" compute {bd['compute_s_per_epoch']:.3f}), objective "
            f"{r.objective:.6f} (history {[round(h, 6) for h in hist]}), "
            f"bytes_read {st.bytes_read}, bytes_staged {st.bytes_staged}")
        out.append({"cell": cell, "backend": p.backend, "m": p.num_batches,
                    "chunk": p.chunk, "kmax": p.kmax, "nnz": p.nnz,
                    "step_size": p.cfg.step_size, "history": hist,
                    "objective": r.objective, "epoch_s": bd["epoch_s"],
                    "access_s_per_epoch": bd["access_s_per_epoch"],
                    "h2d_s_per_epoch": bd["h2d_s_per_epoch"],
                    "compute_s_per_epoch": bd["compute_s_per_epoch"],
                    "bytes_read": st.bytes_read,
                    "bytes_staged": st.bytes_staged})
    if {**fe.LAUNCHES, **se.LAUNCHES} != before:
        raise AssertionError("the sparse-csr backend launched a kernel")
    return out


def csr_matrix(api, sparse, dataset, root):
    """The 15 constant-step cells at l = 2,000, n = 4,096, density 0.01,
    b = 100: ``sparse-csr`` on the CSR corpus against ``streamed-eager`` on
    the same corpus densified (the generator's columns are distinct, so the
    densified rows are the CSR rows), both at the CSR plan's step; final w
    at rtol 1e-4 / atol 1e-6."""
    l, n, b = 2000, 4096, 100
    csr_p = root / f"csr_matrix_{l}x{n}.csr"
    dense_p = root / f"csr_matrix_{l}x{n}_dense.bin"
    sparse.synth_sparse_classification(csr_p, rows=l, features=n,
                                       density=0.01, seed=1)
    X, y = sparse.open_csr_corpus(csr_p).densify()
    dataset.write_corpus(dense_p, np.hstack([X, y[:, None]]), "rows")
    out = []
    t0 = time.perf_counter()
    for solver in api.SOLVERS:
        for scheme in api.SCHEMES:
            kw = dict(solver=solver, scheme=scheme, batch_size=b, epochs=2,
                      record_objective=False)
            ps = api.plan(api.ExperimentSpec(api.DataSource.corpus(csr_p),
                                             **kw))
            pd = api.plan(api.ExperimentSpec(
                api.DataSource.corpus(dense_p), placement="streamed",
                step_size=ps.cfg.step_size, **kw))
            if (ps.backend, pd.backend) != (api.SPARSE_CSR,
                                            api.STREAMED_EAGER):
                raise AssertionError(f"planned {ps.backend}, {pd.backend}")
            ws, wd = api.execute(ps).w, api.execute(pd).w
            dw = np.abs(ws - wd)
            cell = f"{solver}/{scheme}/constant"
            if not np.allclose(ws, wd, rtol=1e-4, atol=1e-6):
                raise AssertionError(f"csr {cell}: sparse-csr and densified "
                                     f"streamed-eager w differ by max |dw| "
                                     f"{dw.max():.3e}")
            out.append({"cell": cell, "max_abs_dw": float(dw.max()),
                        "max_rel_dw": float(np.max(dw / (np.abs(wd)
                                                         + 1e-6)))})
    log(f"  15 cells: sparse-csr w within rtol 1e-4 of densified "
        f"streamed-eager (worst relative difference "
        f"{max(c['max_rel_dw'] for c in out):.3e}); "
        f"{time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phases 2c and 2d: the gather kernels and the access time per scheme
# ---------------------------------------------------------------------------

GATHER_SHAPES = [(64, 128, 8), (256, 256, 32), (40, 512, 8), (512, 256, 16)]


def same_bits(torch, a, b) -> bool:
    """Equal raw words: a copy must move every bit, NaN payloads included."""
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
            torch.int32: torch.int32}
    return a.dtype == b.dtype and torch.equal(a.view(view[a.dtype]),
                                              b.view(view[b.dtype]))


def check_gather_kernels(torch, sg, Xm, errs):
    """Each gather kernel against its plain version, bit for bit: the
    reference tests' shapes and dtypes (float32, bfloat16, int32 for the
    block kernel; float32, bfloat16 for the rows kernel), every block index
    and two past the end (clamped), a negative one, row ids with duplicates
    and out-of-range ids; then the resident SUSY-shaped corpus at full size.
    These launches do not count."""
    g = torch.Generator(device="cuda").manual_seed(13)
    cases = 0

    def cmp(name, k, p, tag):
        nonlocal cases
        torch.cuda.synchronize()
        if not same_bits(torch, k, p):
            raise AssertionError(f"{name} {tag}: the kernel's bits differ "
                                 f"from its plain version's")
        errs[name] = max(errs.get(name, 0.0),
                         (k.float() - p.float()).abs().max().item())
        cases += 1

    def both(X, b, tag):
        l = X.shape[0]
        for bi in list(range(l // b + 2)) + [-1]:
            t = torch.tensor(bi, dtype=torch.int32, device="cuda")
            cmp("block_gather", sg.block_gather(X, t, batch_size=b),
                sg._block_gather_plain(X, t, b), f"{tag} block {bi}")
        if X.dtype != torch.int32:
            idx = torch.randint(0, l, (b,), device="cuda", generator=g,
                                dtype=torch.int32)
            idx[1], idx[-1] = idx[0], l - 1
            cmp("random_gather", sg.random_gather(X, idx),
                sg._random_gather_plain(X, idx), f"{tag} rows")
            bad = torch.tensor([-5, l, l + 9, 0], dtype=torch.int32,
                               device="cuda")
            cmp("random_gather", sg.random_gather(X, bad),
                sg._random_gather_plain(X, bad), f"{tag} out-of-range ids")

    for l, n, b in GATHER_SHAPES:
        base = torch.randn(l, n, device="cuda", generator=g) * 100
        for dt in (torch.float32, torch.bfloat16, torch.int32):
            both(base.to(dt), b, f"{l}x{n} b={b} {dt}")
    sched = torch.randint(0, Xm.shape[0] // B, (16,), device="cuda",
                          generator=g, dtype=torch.int32)
    for bi in sched:
        cmp("block_gather", sg.block_gather(Xm, bi, batch_size=B),
            sg._block_gather_plain(Xm, bi, B), "SUSY block")
    idx = torch.randint(0, Xm.shape[0], (B,), device="cuda", generator=g,
                        dtype=torch.int32)
    idx[3] = idx[2]
    cmp("random_gather", sg.random_gather(Xm, idx),
        sg._random_gather_plain(Xm, idx), "SUSY rows")
    log(f"  {cases} cases: both gather kernels equal their plain versions "
        f"bit for bit (float32, bfloat16, int32; clamped and negative "
        f"blocks, duplicate and out-of-range ids)")


def time_gather(torch, sg, X, b, reps):
    """Per gather kernel at (X, b): device ms, host ms, plain ms, library ms
    (one ``index_select`` for the rows, ``narrow(...).clone()`` with the
    start on the host for the block) and the bytes bound: the batch read
    once and written once, plus the block index or the row ids."""
    l, n = X.shape
    isz = X.element_size()
    g = torch.Generator(device="cuda").manual_seed(17)
    nt = 64
    blocks = torch.randint(0, l // b, (nt,), device="cuda", generator=g,
                           dtype=torch.int32)
    blocks_h = blocks.tolist()
    idx = torch.randint(0, l, (nt, b), device="cuda", generator=g,
                        dtype=torch.int32)
    bytes_ = {"block_gather": 2 * b * n * isz + 4,
              "random_gather": 2 * b * n * isz + 4 * b}
    calls = {
        "block_gather": (
            lambda i: sg.block_gather(X, blocks[i % nt], batch_size=b),
            lambda i: sg._block_gather_plain(X, blocks[i % nt], b),
            lambda i: X.narrow(0, blocks_h[i % nt] * b, b).clone()),
        "random_gather": (
            lambda i: sg.random_gather(X, idx[i % nt]),
            lambda i: sg._random_gather_plain(X, idx[i % nt]),
            lambda i: torch.index_select(X, 0, idx[i % nt]))}
    out = {}
    for name, (kern, plain, lib) in calls.items():
        out[name] = {
            "ms": device_ms(torch, kern, reps),
            "host_ms": host_ms(torch, kern, reps),
            "plain_ms": device_ms(torch, plain, reps),
            "library_ms": device_ms(torch, lib, reps),
            "bound_ms": bytes_[name] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "bytes": bytes_[name],
            "shape": [l, n, b], "dtype": str(X.dtype)}
    return out


def access_time(torch, sg, ops, pipemod, samplers, am, dataset, root, rows,
                reps_wide):
    """The paper's §1-2 measurement (``benchmarks/access_time.py``) with the
    port: the host tier reads 100 batches per scheme through
    ``DataPipeline.read_batch`` from a memmapped rows x 100 corpus; the
    device tier assembles one epoch of each scheme's batches on the card
    with ``ops.random_gather`` (RS) and ``ops.block_gather`` (CS/SS) — the
    gather kernels' path, with their launches counted around it.  Then the
    card's ``hbm_dma`` constants from this run, and the model's predicted
    RS/SS speedup for every tier."""
    b, width = 1000, 100
    corpus = root / f"access_{rows}x{width}.bin"
    if not corpus.exists():
        dataset.synth_erm_corpus(corpus, rows=rows, features=width - 1)
    row_bytes = width * 4
    host = {}
    for scheme in samplers.SCHEMES:
        p = pipemod.DataPipeline(pipemod.PipelineConfig(
            corpus=corpus, batch_size=b, sampling=scheme, prefetch=0))
        for _ in range(5):
            p.read_batch()
        p.stats = pipemod.AccessStats()
        for _ in range(100):
            p.read_batch()
        host[scheme] = p.stats.s_per_batch
    mm, _ = dataset.open_corpus(corpus)
    X = torch.from_numpy(np.array(mm[:, :width])).cuda()
    scheds = {s: torch.from_numpy(samplers.epoch_schedule(s, 0, 0, rows, b))
              .cuda() for s in samplers.SCHEMES}
    m = rows // b
    blocks = {s: scheds[s] // b for s in ("cyclic", "systematic")}
    calls = {"random": lambda i: ops.random_gather(X, scheds["random"][i % m]),
             "cyclic": lambda i: ops.block_gather(
                 X, blocks["cyclic"][i % m], batch_size=b),
             "systematic": lambda i: ops.block_gather(
                 X, blocks["systematic"][i % m], batch_size=b)}
    sg.reset_launches()
    device = {s: device_ms(torch, fn, m) * 1e-3 for s, fn in calls.items()}
    torch.cuda.synchronize()
    launches = dict(sg.LAUNCHES)
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name} was never launched on the access-"
                                 f"time path")
    for s in samplers.SCHEMES:      # the batches the path assembled
        ref = (X.index_select(0, scheds[s][0].long()) if s == "random" else
               X.narrow(0, int(scheds[s][0]), b))
        if not torch.equal(calls[s](0), ref):
            raise AssertionError(f"access-time {s}: wrong batch")
    del X
    # the card's tier from this run: bandwidth from the wide block copy,
    # the per-descriptor cost from rows against block at equal bytes
    Xw = torch.randn(20_000, 4096, device="cuda")
    wb = torch.randint(0, 20_000 // B, (64,), dtype=torch.int32,
                       device="cuda")
    bw_bytes = B * 4096 * 4
    t_wide = device_ms(torch, lambda i: sg.block_gather(
        Xw, wb[i % 64], batch_size=B), reps_wide) * 1e-3
    del Xw
    card = am.Tier("hbm_dma", seek_s=0.0,
                   latency_s=(device["random"] - device["systematic"])
                   / (b - 1),
                   bandwidth=bw_bytes / t_wide, block_bytes=32)
    pred = {name: am.predicted_speedup(t, rows, b, row_bytes)
            for name, t in am.TIERS.items()}
    pred_card = (am.predicted_speedup(card, rows, b, row_bytes)
                 if card.latency_s >= 0 else None)
    out = {"rows": rows, "features": width, "batch": b,
           "host_s_per_batch": host, "device_s_per_batch": device,
           "host_rs_over_ss": host["random"] / host["systematic"],
           "device_rs_over_ss": device["random"] / device["systematic"],
           "predicted_rs_over_ss": pred,
           "predicted_rs_over_ss_this_run_tier": pred_card,
           "hbm_dma_this_run": dataclasses.asdict(card),
           "hbm_dma_committed": dataclasses.asdict(am.HBM_DMA),
           "wide_block_s": t_wide, "launches": launches}
    for tier, d in (("host", host), ("device", device)):
        log(f"  {tier} tier s per batch: " + ", ".join(
            f"{s} {v:.6e}" for s, v in d.items())
            + f"; RS/SS {d['random'] / d['systematic']:.3f}")
    log("  predicted RS/SS (access_model): " + ", ".join(
        f"{k} {v:.3f}" for k, v in pred.items())
        + f"; hbm_dma from this run {pred_card}")
    log(f"  hbm_dma from this run: bandwidth {card.bandwidth:.6e} B/s "
        f"({bw_bytes} B in {t_wide * 1e3:.6f} ms), latency_s "
        f"{card.latency_s:.6e}; launches {launches}")
    return out, launches


# ---------------------------------------------------------------------------
# phases 5 and 5b: durable runs and adaptive schemes at full size
# ---------------------------------------------------------------------------

KILL_CASE = """
import sys
sys.path.insert(0, {src!r})
import numpy as np
from pathlib import Path
from repro_torch.api import (CheckpointPolicy, DataSource, ExperimentSpec,
                             execute, plan, resume_from)
from repro_torch.core import schemes

work = Path({work!r})
p = plan(ExperimentSpec(data=DataSource.corpus({corpus!r}), solver="saga",
                        scheme={scheme}, batch_size={b}, epochs={epochs},
                        placement={placement!r}, step_size={step!r},
                        checkpoint=CheckpointPolicy(work / "ckpt", every=1)))
try:
    res = resume_from(work / "ckpt")
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


def kill_and_resume(cases, root, timeout=600):
    """``benchmarks/fault_injection.py`` mode ``basic`` on the card: for
    each case a victim child process runs the checkpointed plan and is
    SIGKILLed as soon as its first ``LATEST`` is committed; then a survivor
    child resumes with ``resume_from(dir)`` (no spec: the plan is rebuilt
    from the fingerprint, on the card) and finishes the budget.  The victims
    start together, then the survivors.  Returns {name: (w, history,
    resumed_at)}."""
    procs, works = {}, {}
    for name, fmt in cases.items():
        work = root / f"kill_{name}"
        if work.exists():
            shutil.rmtree(work)
        work.mkdir(parents=True)
        works[name] = (work, KILL_CASE.format(src=str(ROOT / "src"),
                                              work=str(work), **fmt))
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", works[name][1]], cwd=ROOT,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    deadline = time.time() + timeout
    pending = set(procs)
    try:
        while pending and time.time() < deadline:
            for name in list(pending):
                if ((works[name][0] / "ckpt" / "LATEST").exists()
                        or procs[name].poll() is not None):
                    procs[name].kill()
                    pending.discard(name)
            time.sleep(0.02)
    finally:
        for name, pr in procs.items():
            pr.kill()
            _, err = pr.communicate(timeout=60)
            if not (works[name][0] / "ckpt" / "LATEST").exists():
                raise AssertionError(f"victim {name} committed no "
                                     f"checkpoint:\n{err}")
    survivors = {name: subprocess.Popen(
        [sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, (_, code) in works.items()}
    out = {}
    for name, pr in survivors.items():
        try:
            so, se = pr.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            pr.kill()
            pr.communicate()
            raise
        if pr.returncode != 0 or "DONE" not in so:
            raise AssertionError(f"survivor {name} failed:\n{so}\n{se}")
        at = [ln for ln in so.splitlines() if ln.startswith("RESUMED")]
        if not at:
            raise AssertionError(f"survivor {name} did not resume")
        work = works[name][0]
        out[name] = (np.load(work / "w.npy"), np.load(work / "hist.npy"),
                     int(at[0].split()[1]))
    return out


def checkpoint_costs(r, ckdir):
    """Seconds per save from the CHECKPOINT lane of a traced run (the
    synchronous host snapshot, and snapshot + serialize + commit), and the
    bytes of one snapshot on disk."""
    from repro_torch.obs import CHECKPOINT
    evs = [e for e in r.timeline.events if e.lane == CHECKPOINT]
    snaps = [e.dur for e in evs if e.name == "snapshot"]
    total = sum(e.dur for e in evs)
    step = sorted(p for p in ckdir.glob("step_*"))[-1]
    nbytes = sum(f.stat().st_size for f in step.glob("*.npy"))
    return {"saves": len(snaps),
            "snapshot_s_per_save": sum(snaps) / max(len(snaps), 1),
            "s_per_save": total / max(len(snaps), 1),
            "bytes_per_snapshot": nbytes,
            "files": sorted(f.name for f in step.iterdir())}


def durable_cell(api, name, spec_kw, root, f0):
    """2 epochs with ``CheckpointPolicy(every=1)``, traced; then 1 epoch, a
    ``resume_from(dir)`` with no plan (rebuilt on the card), and 1 more
    epoch: w and history must equal the 2-epoch run's bit for bit."""
    from repro_torch.obs import TracePolicy
    full_dir, split_dir = root / f"ck_{name}_full", root / f"ck_{name}_split"
    for d in (full_dir, split_dir):
        if d.exists():
            shutil.rmtree(d)
    src = api.DataSource.corpus(spec_kw.pop("corpus"))
    p = api.plan(api.ExperimentSpec(
        src, epochs=2, trace=TracePolicy(buffer=1 << 18),
        checkpoint=api.CheckpointPolicy(full_dir, every=1), **spec_kw))
    t0 = time.perf_counter()
    full = api.execute(p)
    full_s = time.perf_counter() - t0
    hist = [float(h) for h in full.history]
    if not all(math.isfinite(h) and h < f0 for h in hist):
        raise AssertionError(f"durable {name}: objectives {hist} not finite "
                             f"and below {f0}")
    costs = checkpoint_costs(full, full_dir)
    api.execute(api.plan(api.ExperimentSpec(
        src, epochs=2, checkpoint=api.CheckpointPolicy(split_dir, every=1),
        **spec_kw)), epochs=1)
    res = api.resume_from(split_dir)
    if res.plan.backend != p.backend or res.plan.device != p.device:
        raise AssertionError(f"durable {name}: resume_from rebuilt "
                             f"{res.plan.backend} on {res.plan.device}")
    r = api.execute(res.plan, resume=res, epochs=1)
    if not (np.array_equal(r.w, full.w)
            and np.array_equal(r.history, full.history)):
        raise AssertionError(f"durable {name}: the resumed run differs from "
                             f"the uninterrupted one (max |dw| "
                             f"{np.abs(r.w - full.w).max():.3e})")
    log(f"  {name} ({p.backend}): 1 + resumed 1 epoch == 2 epochs, bitwise; "
        f"{costs['saves']} saves, {costs['s_per_save']:.4f} s per save "
        f"({costs['snapshot_s_per_save']:.4f} s synchronous snapshot), "
        f"{costs['bytes_per_snapshot']} bytes per snapshot; history "
        f"{[round(h, 6) for h in hist]}; epoch_s "
        f"{full.breakdown()['epoch_s']:.3f}")
    return full, {"cell": name, "backend": p.backend, "history": hist,
                  "epoch_s": full.breakdown()["epoch_s"],
                  "run_s": full_s, **costs}


def durable_runs(api, path, csr_path, root):
    """Phase 5: the three durable cells at full size."""
    f0 = math.log(2.0)
    out = []
    cells = [("resident-fused", dict(corpus=path, solver="saga",
                                     scheme="systematic", batch_size=B,
                                     placement="resident", kernel="fused")),
             ("streamed-eager", dict(corpus=path, solver="saga",
                                     scheme="systematic", batch_size=B,
                                     placement="streamed")),
             ("sparse-csr", dict(corpus=csr_path, solver="saga",
                                 scheme="systematic", batch_size=B))]
    for name, kw in cells:
        _, rec = durable_cell(api, name, dict(kw), root, f0)
        if rec["backend"] != name:
            raise AssertionError(f"durable {name} planned {rec['backend']}")
        out.append(rec)
    return out


def kill_phase(api, kill_path, root, schemes_):
    """The SIGKILL cases: resident-fused saga/systematic (phase 5) and each
    adaptive scheme streamed (phase 5b), victims and survivors in child
    processes, each survivor held against an uninterrupted in-process run
    of the same plan, bit for bit."""
    epochs = 4
    cases = {"resident-fused": dict(corpus=str(kill_path), scheme="'systematic'",
                                    b=B, epochs=epochs, placement="resident",
                                    step=None)}
    for s in schemes_:
        cases[s] = dict(corpus=str(kill_path), scheme=f"schemes.resolve({s!r})",
                        b=B, epochs=2, placement="streamed", step=None)
    t0 = time.perf_counter()
    got = kill_and_resume(cases, root)
    kill_s = time.perf_counter() - t0
    out = {}
    for name, fmt in cases.items():
        p = api.plan(api.ExperimentSpec(
            api.DataSource.corpus(kill_path), solver="saga",
            scheme=(fmt["scheme"].strip("'") if name == "resident-fused"
                    else name), batch_size=B, epochs=fmt["epochs"],
            placement=fmt["placement"]))
        if name == "resident-fused" and p.backend != name:
            raise AssertionError(f"SIGKILL {name} planned {p.backend}")
        ref = api.execute(p)
        w, hist, at = got[name]
        if not (np.array_equal(w, ref.w) and np.array_equal(hist,
                                                            ref.history)):
            raise AssertionError(f"SIGKILL {name}: the survivor differs from "
                                 f"the uninterrupted run (max |dw| "
                                 f"{np.abs(w - ref.w).max():.3e})")
        log(f"  SIGKILL {name} ({p.backend}): survivor resumed at epoch "
            f"{at}/{fmt['epochs']}, bitwise equal to the uninterrupted run")
        out[name] = {"backend": p.backend, "resumed_at": at,
                     "epochs": fmt["epochs"],
                     "history": [float(h) for h in ref.history]}
    log(f"  victims and survivors: {kill_s:.1f} s")
    return out


def adaptive_runs(api, kill_path, f0):
    """Phase 5b: each adaptive scheme streamed at the SUSY width for 2
    epochs; finite objectives below the value at w = 0, weights applied
    (the planner forces streamed placement with read-ahead off)."""
    out = []
    for s in ("chunk_importance", "stochastic_batch"):
        p = api.plan(api.ExperimentSpec(
            api.DataSource.corpus(kill_path), solver="saga", scheme=s,
            batch_size=B, epochs=2))
        if p.backend != api.STREAMED_EAGER:
            raise AssertionError(f"adaptive {s} planned {p.backend}")
        r = api.execute(p)
        hist = [float(h) for h in r.history]
        if not all(math.isfinite(h) and h < f0 for h in hist):
            raise AssertionError(f"adaptive {s}: objectives {hist} not "
                                 f"finite and below {f0}")
        bd = r.breakdown()
        log(f"  {s} saga ({p.backend}, m={p.num_batches}): epoch_s "
            f"{bd['epoch_s']:.3f}, history {[round(h, 6) for h in hist]}, "
            f"sampler state keys {sorted(r.sampler_state)}")
        out.append({"scheme": s, "backend": p.backend, "history": hist,
                    "epoch_s": bd["epoch_s"],
                    "compute_s_per_epoch": bd["compute_s_per_epoch"],
                    "access_s_per_epoch": bd["access_s_per_epoch"]})
    return out


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="small corpora and matrix, few timing runs")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "artifacts" / "chip_smoke",
                    help="directory for chip_smoke.json (the details)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this script "
              "drives the port on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import api
    from repro_torch.core import access_model as am, samplers
    from repro_torch.data import dataset, pipeline as pipemod, sparse
    from repro_torch.kernels import (_build, fused_erm as fe, ops,
                                     sampled_gather as sg, sparse_erm as se)

    t_start = time.perf_counter()
    rows, n = (200_000, 18) if args.quick else (5_000_000, 18)
    csr_rows = 20_000 if args.quick else 100_000
    mrows = 2_000 if args.quick else 20_000
    arows = 20_000 if args.quick else 200_000     # access_time.py's corpus
    krows = 100_000 if args.quick else 1_000_000  # phases 5 and 5b
    reps = 10 if args.quick else 50
    smi = smi_line()
    log(f"[1] device: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.load_all("fused_erm", "sparse_erm", "sampled_gather")
    build_s = time.perf_counter() - t0
    log(f"  built fused_erm, sparse_erm and sampled_gather in "
        f"{build_s:.1f} s")
    for name in ("fused_erm", "sparse_erm", "sampled_gather"):
        for line in _build.BUILD_LOGS[name].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}:", line.strip())

    root = ROOT / "artifacts" / "chip_smoke"
    path = root / f"susy_synth_{rows}x{n}.bin"
    t0 = time.perf_counter()
    if not path.exists():
        dataset.synth_erm_corpus(path, rows=rows, features=n, seed=0)
    corpus_s = time.perf_counter() - t0
    log(f"  corpus {path.name}: {rows} x {n} f32 + labels in "
        f"{corpus_s:.1f} s")
    csr_path = root / f"csr_synth_{csr_rows}x{CSR_FEATURES}.csr"
    t0 = time.perf_counter()
    if not (csr_path / "meta.json").exists():
        sparse.synth_sparse_classification(
            csr_path, rows=csr_rows, features=CSR_FEATURES,
            density=CSR_DENSITY, seed=0)
    csr_s = time.perf_counter() - t0
    csr = sparse.open_csr_corpus(csr_path)
    log(f"  corpus {csr_path.name}: {csr.rows} x {csr.features}, nnz "
        f"{csr.nnz}, kmax {csr.kmax}, {csr.meta.nbytes / 1e6:.1f} MB in "
        f"{csr_s:.1f} s")
    kill_path = root / f"susy_synth_{krows}x{n}.bin"
    t0 = time.perf_counter()
    if not kill_path.exists():
        dataset.synth_erm_corpus(kill_path, rows=krows, features=n, seed=1)
    log(f"  corpus {kill_path.name} (phases 5 and 5b) in "
        f"{time.perf_counter() - t0:.1f} s")

    log("[2] kernels against their plain versions")
    mm, _ = dataset.open_corpus(path)
    Xm = torch.from_numpy(np.ascontiguousarray(mm[:, :n])).cuda()
    ym = torch.from_numpy(np.ascontiguousarray(mm[:, n])).cuda()
    errs = {}
    check_kernels(torch, fe, Xm, ym, f"main {rows}x{n}", errs)
    gw = torch.Generator(device="cuda").manual_seed(3)
    wide = {}
    for wn in (4096, 1000):
        Xw = torch.randn(20_000, wn, device="cuda", generator=gw)
        yw = torch.where(torch.rand(20_000, device="cuda", generator=gw)
                         < 0.5, 1.0, -1.0)
        check_kernels(torch, fe, Xw, yw, f"wide 20000x{wn}", errs)
        if wn == 4096:
            wide = time_kernels(torch, fe, Xw, yw, reps)
        del Xw, yw
    timing = time_kernels(torch, fe, Xm, ym, reps)
    for shape, tab in (("main", timing), ("wide n=4096", wide)):
        for name, t in tab.items():
            lib = ("-" if t["library_ms"] is None
                   else f"{t['library_ms']:.4f}")
            log(f"  {shape} {name}: {t['ms']:.4f} ms device, "
                f"{t['host_ms']:.4f} ms per call on the host, plain "
                f"{t['plain_ms']:.4f}, library {lib}, bound "
                f"{t['bound_ms']:.6f} ({t['bound_by']})")

    log("[2b] the sparse kernels on the CSR corpus")
    t0 = time.perf_counter()
    dev = se.csr_to_device(csr, batch_size=B)
    torch.cuda.synchronize()
    log(f"  csr_to_device: {time.perf_counter() - t0:.2f} s")
    sparse_launches, kernel_path = sparse_kernel_path(
        torch, api, se, dev, csr_path, csr.rows, csr.features)
    check_sparse_kernels(torch, se, sparse, dev, csr.rows, csr.features,
                         root, errs)
    sparse_timing = time_sparse_kernels(torch, se, dev, csr, csr.rows,
                                        csr.features, reps)
    for name, t in sparse_timing.items():
        lib = "-" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        log(f"  csr {name}: {t['ms']:.4f} ms device, {t['host_ms']:.4f} ms "
            f"per call on the host, plain {t['plain_ms']:.4f}, library "
            f"{lib}, bound {t['bound_ms']:.6f} ({t['bound_by']}), "
            f"{t['nnz_per_batch']:.0f} nonzeros a batch")
    del dev
    torch.cuda.empty_cache()

    log("[2c] the gather kernels on the card")
    check_gather_kernels(torch, sg, Xm, errs)
    Xa = torch.randn(arows, 100, device="cuda", generator=gw)
    Xw = torch.randn(20_000, 4096, device="cuda", generator=gw)
    gather_timing = {"susy": time_gather(torch, sg, Xm, B, reps),
                     "access": time_gather(torch, sg, Xa, 1000, reps),
                     "wide": time_gather(torch, sg, Xw, B, reps)}
    for shape, tab in gather_timing.items():
        for name, t in tab.items():
            log(f"  {shape} {t['shape']} {name}: {t['ms']:.4f} ms device, "
                f"{t['host_ms']:.4f} ms per call on the host, plain "
                f"{t['plain_ms']:.4f}, library {t['library_ms']:.4f}, bound "
                f"{t['bound_ms']:.6f} ({t['bound_by']})")
    del Xm, ym, Xa, Xw
    torch.cuda.empty_cache()

    log("[2d] access time per scheme (benchmarks/access_time.py, ported)")
    access, gather_launches = access_time(
        torch, sg, ops, pipemod, samplers, am, dataset, root, arows, reps)
    torch.cuda.empty_cache()
    fe.reset_launches()     # the comparisons above do not count
    se.reset_launches()

    log("[3] main path: plan() -> execute() at full size")
    cells, launches, streamed = main_path(api, fe, path, rows, n)

    log("[3b] the CSR path: plan() -> execute() on sparse-csr at full size")
    csr_cells = csr_main_path(api, fe, se, csr_path)

    log("[4] the 45-cell matrix, fused against eager")
    mcells = matrix(torch, api, fe, mrows, n)

    log("[4b] the 15 CSR cells, sparse-csr against densified streamed-eager")
    csr_mcells = csr_matrix(api, sparse, dataset, root)

    log("[5] durable runs at full size")
    durable = durable_runs(api, path, csr_path, root)

    log("[5b] adaptive schemes, streamed at the SUSY width")
    adaptive = adaptive_runs(api, kill_path, math.log(2.0))

    log("[5/5b] SIGKILL and resume, in child processes on the card")
    killed = kill_phase(api, kill_path, root,
                        ("chunk_importance", "stochastic_batch"))

    def record(name, source, replaces, count, t):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": count,
                "max_abs_err": errs[name], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]}

    kernels = ([record(k, SOURCE, r, launches[k], timing[k])
                for k, r in REPLACES.items()]
               + [record(k, SPARSE_SOURCE, r, sparse_launches[k],
                         sparse_timing[k])
                  for k, r in SPARSE_REPLACES.items()]
               + [record(k, GATHER_SOURCE, r, gather_launches[k],
                         gather_timing["access"][k])
                  for k, r in GATHER_REPLACES.items()])
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "chip_smoke.json").write_text(json.dumps({
        "device": smi, "torch": torch.__version__, "quick": args.quick,
        "build_s": build_s, "corpus": [rows, n], "corpus_s": corpus_s,
        "csr_corpus": {"rows": csr.rows, "features": csr.features,
                       "nnz": csr.nnz, "kmax": csr.kmax,
                       "nbytes": csr.meta.nbytes, "generate_s": csr_s},
        "timing_main": timing, "timing_wide_4096": wide,
        "timing_sparse": sparse_timing, "max_abs_err": errs,
        "cells": cells, "launches": launches, "streamed": streamed,
        "sparse_kernel_path": kernel_path,
        "sparse_launches": sparse_launches, "csr_cells": csr_cells,
        "matrix_rows": mrows, "matrix": mcells, "csr_matrix": csr_mcells,
        "timing_gather": gather_timing, "gather_launches": gather_launches,
        "access_time": access, "durable": durable, "adaptive": adaptive,
        "sigkill": killed,
        "total_s": time.perf_counter() - t_start}, indent=2) + "\n")
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
