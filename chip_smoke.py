#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py --quick    # small sizes: a build-and-check run

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` and print the build time;
2. each fused kernel against its plain PyTorch version on the card — the
   main-path shape (a 5,000,000 x 18 SUSY-shaped corpus resident, b = 500)
   and a wide case (l = 20,000, n = 4,096 and a ragged n = 1,000), three
   losses, starts of -5, l-b+7 and 0, row ids with duplicates — then each
   kernel's median time from CUDA events beside its bound, its plain
   version's and (where one PyTorch call computes the same) the library's;
3. the main path at full size through ``plan()``/``execute()``: three
   resident-fused cells of 2 epochs and one streamed-eager epoch on the
   synthetic corpus, with every kernel's launch count read around the run;
4. the 45-cell matrix (5 solvers x RS/CS/SS x constant / vectorized /
   sequential line search) at l = 20,000: every kernel against its plain
   version at every step of the eager trajectory, and resident-fused
   against resident-eager on the final w;
5. one JSON line of kernel records, the ``nvidia-smi`` line, and the
   device record as the last line.

Details go to ``chip_smoke.json`` in ``--out`` (default
``artifacts/chip_smoke/``).  Needs no network; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
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
B = 500


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
        torch.cuda.synchronize()
        err = (k - p).abs().max().item()
        tol = rel * p.abs().max().item() + 1e-6
        errs[name] = max(errs.get(name, 0.0), err)
        if not (err <= tol and torch.isfinite(k).all().item()):
            raise AssertionError(f"{name} {tag}: max|k-p| = {err:.3e} > "
                                 f"{tol:.3e}")

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

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="small corpus and matrix, few timing runs")
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
    from repro_torch.data import dataset
    from repro_torch.kernels import _build, fused_erm as fe

    t_start = time.perf_counter()
    rows, n = (200_000, 18) if args.quick else (5_000_000, 18)
    mrows = 2_000 if args.quick else 20_000
    reps = 10 if args.quick else 50
    smi = smi_line()
    log(f"[1] device: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.load("fused_erm")
    build_s = time.perf_counter() - t0
    log(f"  built fused_erm in {build_s:.1f} s")
    for line in _build.BUILD_LOGS["fused_erm"].splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())

    path = ROOT / "artifacts" / "chip_smoke" / f"susy_synth_{rows}x{n}.bin"
    t0 = time.perf_counter()
    if not path.exists():
        dataset.synth_erm_corpus(path, rows=rows, features=n, seed=0)
    corpus_s = time.perf_counter() - t0
    log(f"  corpus {path.name}: {rows} x {n} f32 + labels in "
        f"{corpus_s:.1f} s")

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
    del Xm, ym
    torch.cuda.empty_cache()
    fe.reset_launches()     # the comparisons above do not count

    log("[3] main path: plan() -> execute() at full size")
    cells, launches, streamed = main_path(api, fe, path, rows, n)

    log("[4] the 45-cell matrix, fused against eager")
    mcells = matrix(torch, api, fe, mrows, n)

    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": errs[name], "ms": timing[name]["ms"],
                "plain_ms": timing[name]["plain_ms"],
                "bound_ms": timing[name]["bound_ms"],
                "bound_by": timing[name]["bound_by"],
                "library_ms": timing[name]["library_ms"]}
               for name in REPLACES]
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "chip_smoke.json").write_text(json.dumps({
        "device": smi, "torch": torch.__version__, "quick": args.quick,
        "build_s": build_s, "corpus": [rows, n], "corpus_s": corpus_s,
        "timing_main": timing, "timing_wide_4096": wide, "max_abs_err": errs,
        "cells": cells, "launches": launches, "streamed": streamed,
        "matrix_rows": mrows, "matrix": mcells,
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
