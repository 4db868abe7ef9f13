"""A/B runs of the kernels (rows 1-13) on one CUDA card.

    python scripts/ab_torch_training.py gap [--root DIR]
    python scripts/ab_torch_training.py gaptrain [--root DIR]
    python scripts/ab_torch_training.py cell [--root DIR]
    python scripts/ab_torch_training.py bwd --other DIR [--root DIR]
    python scripts/ab_torch_training.py walkscan [--root DIR]
    python scripts/ab_torch_training.py epoch [--root DIR] [--launch]
    python scripts/ab_torch_training.py walk [--root DIR] [--bf16]
    python scripts/ab_torch_training.py step [--root DIR]
    python scripts/ab_torch_training.py recipe [--root DIR]
    python scripts/ab_torch_training.py steps K,H,METHOD,ACT,BATCH,G [--root DIR]

``epoch``: one epoch call of ``fused_train_run`` at the default recipe's
shape (H 32, two networks, N 10, 8 steps of 128, the last minibatch 104
rows valid), CUDA events around the wrapper, median of 20 after 3 of
warm-up, three times; checked against the plain version.  ``--launch`` adds
the bare launch on preallocated buffers and the kernel's own time from
torch.profiler (this tree's kernel interface only).  ``walk``: one epoch
call of ``fused_walk_train_run`` (row 13) at the production recipe's shape
(H 50, shared, N 10, M 100, 40 steps of 256, the last minibatch 16 rows
valid), timed the same way and checked normwise (losses, params, m and v
each within 1e-3 of its norm; chip_smoke.py's phase 13 holds 8 steps
entrywise, an epoch call here is 40); ``--bf16`` runs row 13b, the same call
with ``mxu_dtype="bfloat16"`` against its plain version with the same
rounding points.  ``step``: one call each of the
fused-step kernels, rows 9 and 10 (f32) and 9b and 10b (bf16), at the
scaled recipe's shape (H 256, N 2, two networks, L 1, relu/identity,
4,096 rows), timed the same way, each checked against its plain version
(the forward's largest abs err, the backward's largest error/norm over the
dW planes and dV rows).  ``recipe``: the
default recipe (200 epochs of 1,000 fresh trajectories) through
``Trainer.train`` on the kernel, twice; wall time, and val MSE and relative
loss against the closed-form moments.  ``--seed S`` sets the model's and
the data's seed of ``recipe`` (default 0 and 1); ``--plain`` runs the
kernel's plain version in its place (the same recipe in another summation
order).

``gap``: row 1 (``gap_substeps``, the serving path's kernel) at the
``predict_at`` shape of chip_smoke.py (the production model, 1,000 streams x 21
queries, 21,000 rows, d_h 50), at the filter's (256 rows, gap 0.02) and at d_h
256 (21,000 rows, random gaps), CUDA events around the wrapper, median of 30
after 5 of warm-up, three times each, every result checked against the plain
version (h_L at rtol 1e-4 / atol 1e-5, t_L bitwise); then ``predict_at``
itself, and the launches of one ``predict_at`` and one filter ``predict``: the
gap kernel's and all device launches (kernels and copies, torch.profiler).
``walkscan``: rows 7 and 8 (the grid walk's forward with residuals and its
backward through autograd) at the composed production step's shape (256 rows,
H 50, M 100, N 10), K_h 1 and 2, timed the same way and checked against the
plain version (the forward at rtol 1e-4 / atol 1e-5, every cotangent within
1e-3 of its norm), then each kernel's device time a forward and backward
(torch.profiler, 5 calls), and the forward kernel's device time over 5
forward calls alone (no backward between them).

``gaptrain``: the forced path's training pair at its main-path shapes, a
production minibatch of chip_smoke.py's ``forced_times_phase`` (256
trajectories x 9 gaps, 2,304 rows, K_h 1, d_h 50, relu/identity): rows 3 and
5 at dt 0.01 (n_sub 100, checkpoints every 8 substeps), rows 2 and 4 at dt
0.1 (n_sub 10, every state stored); CUDA events around each wrapper
(``_launch_train_fwd``, ``_launch_train_bwd``), median of 30 after 5 of
warm-up, three times each, every result checked against the plain versions
(t_L bitwise, the backward's six outputs' largest error/norm), then each
kernel's device time over 5 forward and backward calls (torch.profiler),
the forward's device time over 5 forward calls alone (no backward between
them; every kernel of the forward, by name), the backward's over 5
backward calls alone on the same residuals, and the minibatch's substep
counts (longest, mean).

``cell``: row 6 (the fused Euler cell) at the forced default path's shape, a
default minibatch (128 trajectories x 9 gaps, K_h 2, d_h 32, d_in 35,
relu/identity) as ``forced_times_phase`` builds it: the kernel's device time
(torch.profiler, 20 calls), the ``_launch`` wrapper (CUDA events, median of
30 after 5 of warm-up, three times), the model's step ``ode_euler_fused``
with its preparation under autograd (the input concatenation, the step
times, the weights turned to (in, out)) timed the same way, and the device
launches of one such step by name; out and pre checked against the plain
version at rtol 1e-4 / atol 1e-5.

``bwd``: this tree's and the ``--other`` tree's csrc/gap_train.cu, each
built as shipped and with nvcc's ``-fmad=false`` (no multiply and add
contracted into one fma), run the backward (rows 5 and 4) in one process
on the same inputs at the forced production minibatch (the residuals from
this tree's forward): the shipped builds' device ms (torch.profiler, 20
calls) in turns, this, other, other, this, twice, and whether each of the
six outputs of the ``-fmad=false`` builds is bitwise equal between the
trees, that is, whether the two sources do the same arithmetic in the same
order apart from nvcc's choice of which products to contract; then, for
each shipped build, each backward instance's registers and spill bytes
(ptxas) and its count of machine instructions (``cuobjdump -sass``).

``steps``: one case of chip_smoke.py's ``train_kernel_phase`` (its weights
and data; the activation's scaling from ``ACT_PAIRS``), run for 1, 2, ...,
G steps:
for each, the largest share of the tolerance (rtol 1e-4 / atol 1e-5) of
params, m and v between the kernel and the plain version and between each
and the plain version's float64 run, and a hash of the plain version's
state (to compare processes and trees); then the entries where the kernel
and the plain version are furthest apart after G steps, named.

``--root DIR`` runs the mode on the tree at DIR instead (its package, its
chip_smoke.py and its kernel source): unpack the parent commit with ``git
archive`` into a git-ignored directory and run parent, change, change,
parent in one call, so that both trees are timed on one card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import sys
import time

ARGS = sys.argv[1:]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if "--root" in ARGS:
    ROOT = os.path.abspath(ARGS[ARGS.index("--root") + 1])
sys.path.insert(0, ROOT)
os.chdir(ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from njode_tpu_torch import NeuralJumpODE  # noqa: E402
from njode_tpu_torch.ops import train_kernel as tk  # noqa: E402
from njode_tpu_torch.utils import (Trainer, create_data_loaders,  # noqa: E402
                                   make_adam)

SEED = int(ARGS[ARGS.index("--seed") + 1]) if "--seed" in ARGS else 0


def default_case(dev: torch.device) -> tuple:
    model = NeuralJumpODE(1, 32, 1, num_moments=2, device=dev,
                          generator=torch.Generator().manual_seed(0))
    data = cs.train_data(dev, 1024, 128, 3, n_valid=1000)
    return tk.init_train_state(model), data, cs.train_kwargs(2)


def epoch_ms(state, data, kw, rounds: int = 3, kernel=None,
             plain=None) -> tuple[list, float]:
    """(epoch-call ms per round, the largest error against the plain
    version at chip_smoke's tolerance; the walk's normwise)."""
    kernel = kernel or tk.fused_train_run
    plain = plain or tk.fused_train_run_reference
    walk = kernel is not tk.fused_train_run
    with torch.no_grad():
        run = lambda: kernel(state, data, **kw)  # noqa: E731
        ours = run()
        torch.cuda.synchronize()
        ref = plain(state, data, **kw)
    pairs = ((ours[1], ref[1], "losses"), (ours[0].params, ref[0].params,
                                           "params"),
             (ours[0].m, ref[0].m, "Adam m"), (ours[0].v, ref[0].v, "Adam v"))
    check = cs.assert_close_norm if walk else cs.assert_close
    err = max(check(a, b, what) for a, b, what in pairs)
    with torch.no_grad():
        return [cs.time_ms(run, warmup=3, reps=20)
                for _ in range(rounds)], err


def launch_times(state, data, kw) -> str:
    """The wrapper, the bare launch on preallocated buffers, and the
    kernel's device time (torch.profiler), at the default shape."""
    from torch.profiler import ProfilerActivity, profile
    lib, fn = tk._load_kernel()
    plan = tk.launch_plan(32, 10, 128)
    out = tk.TrainState(*(x.clone() for x in state))
    losses = torch.empty(8, device=data.device)
    n_s = tk.scratch_floats(plan, 2, 10, 128)
    scratch = torch.empty(n_s, device=data.device)
    dims = (ctypes.c_int * 15)(2, 32, 10, 128, 8, 0, 0, 0, plan.blocks,
                               plan.slots, plan.wpt, plan.warps,
                               int(plan.staged), int(plan.slots_global), 0)
    hyper = (ctypes.c_float * 13)(1e-3, 5e-4, 0.9, 0.999, 0.1, 0.001, 1e-8,
                                  1e-10, 1.0, 10.0, 0.1, 0.1, 1.0)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [x.data_ptr() for x in (data, out.params, out.m, out.v, out.stat,
                                   losses, scratch)]
    with torch.no_grad():
        wrapper = cs.time_ms(lambda: tk.fused_train_run(state, data, **kw),
                             warmup=3, reps=30)
        bare = cs.time_ms(lambda: fn(*ptrs, n_s, dims, hyper, stream),
                          warmup=3, reps=30)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                tk.fused_train_run(state, data, **kw)
            torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kern = sorted(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == cuda and "train_run" in e.name)
    return (f"wrapper {wrapper:.4f} ms, bare launch {bare:.4f} ms, kernel "
            f"(profiler, 10 calls) {kern[0]:.1f}-{kern[-1]:.1f} us")


def mode_epoch(dev: torch.device) -> None:
    state, data, kw = default_case(dev)
    t0 = time.perf_counter()
    tk._load_kernel()
    print(f"[{ROOT}] build {time.perf_counter() - t0:.1f} s", flush=True)
    ms, err = epoch_ms(state, data, kw)
    print(f"[{ROOT}] epoch call (8 steps of 128, H 32, K 2) ms "
          f"{[round(x, 4) for x in ms]}; max abs err vs plain {err:.2e}",
          flush=True)
    if "--launch" in ARGS:
        print(f"[{ROOT}] {launch_times(state, data, kw)}", flush=True)


def mode_walk(dev: torch.device) -> None:
    from njode_tpu_torch.ops import walk_train as wt
    t0 = time.perf_counter()
    wt._load_kernel()
    print(f"[{ROOT}] build {time.perf_counter() - t0:.1f} s", flush=True)
    n_rows = -(-cs.PROD_TRAIN // cs.PROD_BS) * cs.PROD_BS
    data = cs.train_data(dev, n_rows, cs.PROD_BS, 51, n_valid=cs.PROD_TRAIN)
    kw = cs.walk_train_kwargs(2, "direct", "euler", cs.PROD_BS)
    if "--bf16" in ARGS:
        kw["mxu_dtype"] = "bfloat16"
    state = wt.init_walk_state(cs.walk_model(dev, seed=0))
    ms, err = epoch_ms(state, data, kw, kernel=wt.fused_walk_train_run,
                       plain=wt.fused_walk_train_run_reference)
    row = "13b" if "--bf16" in ARGS else "13"
    print(f"[{ROOT}] walk-train (row {row}) epoch call "
          f"({n_rows // cs.PROD_BS} steps of {cs.PROD_BS}, H {cs.PROD_H}, M "
          f"{cs.PROD_M}) ms "
          f"{[round(x, 4) for x in ms]}; max abs err vs plain {err:.2e}",
          flush=True)


def mode_step(dev: torch.device) -> None:
    from njode_tpu_torch.ops import fused_step as fs
    t0 = time.perf_counter()
    fs._load_kernel()
    print(f"[{ROOT}] build {time.perf_counter() - t0:.1f} s", flush=True)
    c = cs.step_case(torch.Generator().manual_seed(17), 256, 2, False, 1,
                     "relu", "identity", 4096, dev)
    args = ("relu", "identity")
    for rows, cdt in (("9-10", None), ("9b-10b", cs.BF16)):
        with torch.no_grad():
            y_k, y_p = (cs.step_fwd(c, *args, k, cdt) for k in (True, False))
            g_k, g_p = (cs.step_bwd(c, *args, k, cdt) for k in (True, False))
            torch.cuda.synchronize()
            rel = max(float((a[i, j] - b[i, j]).norm() / b[i, j].norm())
                      for a, b in zip(g_k, g_p) for i in range(a.shape[0])
                      for j in range(a.shape[1]))
            f_ms = [cs.time_ms(lambda: cs.step_fwd(c, *args, True, cdt),
                               warmup=3, reps=20) for _ in range(3)]
            b_ms = [cs.time_ms(lambda: cs.step_bwd(c, *args, True, cdt),
                               warmup=3, reps=20) for _ in range(3)]
        print(f"[{ROOT}] rows {rows} (H 256, N 2, two networks, L 1, "
              f"4,096 rows): forward ms {[round(x, 4) for x in f_ms]}, "
              f"backward ms {[round(x, 4) for x in b_ms]}; vs plain: forward "
              f"max abs err {float((y_k - y_p).abs().max()):.2e}, backward "
              f"largest error/norm {rel:.2e}", flush=True)


def mode_gap(dev: torch.device) -> None:
    from njode_tpu_torch import NJODEFilter
    from njode_tpu_torch.ops import gap_scan
    t0 = time.perf_counter()
    gap_scan._load_kernel()
    print(f"[{ROOT}] build {time.perf_counter() - t0:.1f} s", flush=True)
    model = cs.production_model(dev)
    request = cs.batch_request(dev)
    obs_t, obs_v, query, mask = request
    ts, xs = cs.stream_ticks()
    xs = xs.to(dev)
    filt = NJODEFilter(model)
    state = filt.update(filt.init_state(xs.shape[1]), ts[-1], xs[-1])
    shapes = (
        ("predict_at (21,000 rows, d_h 50)",
         cs.gap_rows(model, obs_t, obs_v, query, mask)),
        ("filter (256 rows, gap 0.02)",
         cs.gap_rows(model, state.t_last[:, None], xs[-1][:, None],
                     state.t_last[:, None] + 0.02)),
        ("d_h 256 (21,000 rows, random gaps)",
         cs.substep_args(cs.gap_case(torch.Generator().manual_seed(4), 1,
                                     query.numel(), 256, 1, cs.N_SUB, dev),
                         cs.N_SUB, "relu", "identity")))
    for name, args in shapes:
        with torch.no_grad():
            h_k, t_k = gap_scan.gap_substeps(*args)
            h_p, t_p = gap_scan.gap_substeps_reference(*args)
            torch.cuda.synchronize()
            if not torch.equal(t_k, t_p):
                raise AssertionError(f"t_L differs at {name}")
            err = cs.assert_close(h_k, h_p, f"h_L at {name}")
            ms = [cs.time_ms(lambda: gap_scan.gap_substeps(*args))
                  for _ in range(3)]
        print(f"[{ROOT}] row 1 at {name}: ms {[round(x, 4) for x in ms]}; "
              f"max abs err vs plain {err:.2e}", flush=True)
    pa = [cs.time_ms(lambda: model.predict_at(obs_t, obs_v, query, mask))
          for _ in range(3)]
    from torch.profiler import ProfilerActivity, profile
    counts = []
    for call in (lambda: model.predict_at(obs_t, obs_v, query, mask),
                 lambda: filt.predict(state, ts[-1] + 0.02)):
        gap_scan.LAUNCHES = 0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        cuda = torch.autograd.DeviceType.CUDA
        counts.append((gap_scan.LAUNCHES, sum(
            e.device_type == cuda for e in prof.events())))
    print(f"[{ROOT}] predict_at (21,000 queries) ms "
          f"{[round(x, 4) for x in pa]}; launches a call (gap kernel / all "
          f"device launches): predict_at {counts[0][0]} / {counts[0][1]}, "
          f"filter predict {counts[1][0]} / {counts[1][1]}", flush=True)


def device_ms(step, n: int = 5) -> dict:
    """Device ms a call of ``step`` by kernel name (torch.profiler over n
    calls)."""
    from torch.profiler import ProfilerActivity, profile
    import re
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            nm = e.name.replace("(anonymous namespace)::", "")
            m = re.search(r"([A-Za-z_]\w*)(?:<[^(]*>)?\(", nm)
            name = m.group(1) if m else (nm or "?")
            by_kernel[name] = (by_kernel.get(name, 0.0)
                               + e.time_range.elapsed_us() / (1e3 * n))
    return by_kernel


def mode_gaptrain(dev: torch.device) -> None:
    from njode_tpu_torch.ops import gap_scan
    from njode_tpu_torch.simulation import simulate_batch
    t0 = time.perf_counter()
    gap_scan._load_train_kernel()
    print(f"[{ROOT}] build {time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(33)
    b = simulate_batch(cs.PROD_BS, "black_scholes", 0.1, True, generator=gen,
                       device=dev, mu=0.1, sigma=0.5, x0=1.0)
    model = NeuralJumpODE(use_pallas=True, device=dev,
                          generator=torch.Generator().manual_seed(0),
                          **cs.PROD_MODEL_KW)
    ct = torch.randn(1, cs.PROD_BS * (cs.PROD_N - 1), cs.PROD_H, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(5))
    for dt, n_sub, rows in ((cs.PROD_DT, cs.PROD_M, (3, 5)),
                            (0.1, 10, (2, 4))):
        stride = gap_scan.residual_stride(n_sub)
        args = cs.forced_rows(model, b.times, b.values, dt)
        fwd = (*args, dt, n_sub, stride, "relu", "identity")
        with torch.no_grad():
            res = gap_scan._launch_train_fwd(*fwd)
            ref = gap_scan.gap_train_forward_reference(*fwd)
            bwd = (ct, args[1], args[3], *args[4:], res[2], res[3], dt,
                   n_sub, stride, "relu", "identity")
            ours = gap_scan._launch_train_bwd(*bwd)
            plain = gap_scan.gap_train_backward_reference(*bwd)
            torch.cuda.synchronize()
            if not torch.equal(res[1], ref[1]):
                raise AssertionError(f"t_L differs at dt {dt}")
            rel = max(float((a - p).double().norm()
                            / p.double().norm().clamp_min(1e-30))
                      for a, p in zip(ours, plain))
            if rel > cs.GRAD_RTOL:
                raise AssertionError(f"backward error/norm {rel:.2e} at dt "
                                     f"{dt}")
            f_ms = [cs.time_ms(lambda: gap_scan._launch_train_fwd(*fwd))
                    for _ in range(3)]
            b_ms = [cs.time_ms(lambda: gap_scan._launch_train_bwd(*bwd))
                    for _ in range(3)]
            by_kernel = device_ms(lambda: (gap_scan._launch_train_fwd(*fwd),
                                           gap_scan._launch_train_bwd(*bwd)))
            fwd_alone = device_ms(lambda: gap_scan._launch_train_fwd(*fwd))
            bwd_alone = device_ms(lambda: gap_scan._launch_train_bwd(*bwd))
        steps = torch.round((ref[1] - args[2]) / dt)
        print(f"[{ROOT}] rows {rows[0]}/{rows[1]} (2,304 rows, d_h "
              f"{cs.PROD_H}, dt {dt}, n_sub {n_sub}, stride {stride}; "
              f"substeps longest {int(steps.max())}, mean "
              f"{float(steps.mean()):.2f}): forward ms "
              f"{[round(x, 4) for x in f_ms]}, backward ms "
              f"{[round(x, 4) for x in b_ms]}; backward vs plain largest "
              f"error/norm {rel:.2e}; device ms a forward + backward by "
              f"kernel (profiler): " + ", ".join(
                  f"{n} {t:.4f}" for n, t in sorted(by_kernel.items(),
                                                    key=lambda x: -x[1]))
              + f"; the forward alone (5 calls, no backward between): "
              f"{sum(fwd_alone.values()):.4f} (" + ", ".join(
                  f"{n} {t:.4f}" for n, t in sorted(fwd_alone.items()))
              + "); the backward alone (5 calls on the same residuals): "
              f"{sum(bwd_alone.values()):.4f}", flush=True)


def mode_bwd(dev: torch.device, other: str) -> None:
    import shutil
    import subprocess
    import tempfile
    from pathlib import Path
    from njode_tpu_torch.ops import _build, gap_scan
    from njode_tpu_torch.simulation import simulate_batch
    shipped = gap_scan._load_train_kernel()
    libs, code = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, root, flags in (
                ("this tree", ROOT, []), ("other tree", other, []),
                ("this tree, no fmad", ROOT, ["-fmad=false"]),
                ("other tree, no fmad", other, ["-fmad=false"])):
            csrc = Path(root) / "njode_tpu_torch" / "ops" / "csrc"
            d = Path(tmp) / name.replace(" ", "_").replace(",", "")
            d.mkdir()
            for f in csrc.glob("*.cuh"):
                shutil.copy(f, d)
            shutil.copy(csrc / "gap_train.cu", d)
            so = d / "libgap_train.so"
            log = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS,
                                  *flags, f"-I{d}", "-o", str(so),
                                  str(d / "gap_train.cu")], check=True,
                                 capture_output=True, text=True)
            if not flags:
                code[name] = bwd_code(log.stdout + log.stderr, so)
            lib = ctypes.CDLL(str(so))
            for fn in ("njode_gap_train_bwd_grid", "njode_gap_train_bwd"):
                getattr(lib, fn).argtypes = getattr(shipped, fn).argtypes
                getattr(lib, fn).restype = getattr(shipped, fn).restype
            lib.njode_cuda_error_string.argtypes = [ctypes.c_int]
            lib.njode_cuda_error_string.restype = ctypes.c_char_p
            libs[name] = lib
        gen = torch.Generator(device=dev).manual_seed(33)
        b = simulate_batch(cs.PROD_BS, "black_scholes", 0.1, True,
                           generator=gen, device=dev, mu=0.1, sigma=0.5,
                           x0=1.0)
        model = NeuralJumpODE(use_pallas=True, device=dev,
                              generator=torch.Generator().manual_seed(0),
                              **cs.PROD_MODEL_KW)
        ct = torch.randn(1, cs.PROD_BS * (cs.PROD_N - 1), cs.PROD_H,
                         device=dev,
                         generator=torch.Generator(device=dev).manual_seed(5))
        original = gap_scan._load_train_kernel
        try:
            for row, dt, n_sub in ((5, cs.PROD_DT, cs.PROD_M), (4, 0.1, 10)):
                gap_scan._load_train_kernel = original
                stride = gap_scan.residual_stride(n_sub)
                args = cs.forced_rows(model, b.times, b.values, dt)
                with torch.no_grad():
                    res = gap_scan._launch_train_fwd(*args, dt, n_sub, stride,
                                                     "relu", "identity")
                    bwd = (ct, args[1], args[3], *args[4:], res[2], res[3],
                           dt, n_sub, stride, "relu", "identity")
                    outs, times = {}, {}
                    for name in ["this tree", "other tree", "other tree",
                                 "this tree"] * 2 + ["this tree, no fmad",
                                                     "other tree, no fmad"]:
                        gap_scan._load_train_kernel = (
                            lambda lib=libs[name]: lib)
                        gap_scan._bwd_launch.cache_clear()
                        outs[name] = gap_scan._launch_train_bwd(*bwd)
                        if "fmad" not in name:
                            times.setdefault(name, []).append(sum(device_ms(
                                lambda: gap_scan._launch_train_bwd(*bwd),
                                n=20).values()))
                torch.cuda.synchronize()
                same = [torch.equal(a, o) for a, o in zip(
                    outs["this tree, no fmad"], outs["other tree, no fmad"])]
                print(f"[{ROOT} against {other}] row {row} (2,304 gaps, dt "
                      f"{dt}, n_sub {n_sub}): the backward's device ms in "
                      f"turns, this tree " + ", ".join(
                          f"{t:.4f}" for t in times["this tree"])
                      + ", other tree " + ", ".join(
                          f"{t:.4f}" for t in times["other tree"])
                      + "; both built with -fmad=false, the outputs bitwise "
                      "equal: " + ", ".join(
                          f"{n} {v}" for n, v in zip(cs.GAP_OUTPUTS, same)),
                      flush=True)
        finally:
            gap_scan._load_train_kernel = original
            gap_scan._bwd_launch.cache_clear()
    for name, text in code.items():
        print(f"[{ROOT if name == 'this tree' else other}] {name}'s backward "
              f"instances: {text}", flush=True)


def bwd_code(log: str, so) -> str:
    """gap_bwd_kernel's instances in a build: registers and spill bytes from
    its ptxas log, and the count of machine instructions from ``cuobjdump
    -sass``."""
    import re
    import subprocess
    from pathlib import Path
    from njode_tpu_torch.ops import _build
    regs, entry, spill = {}, None, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entry, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            regs[entry] = (int(m.group(1)), spill)
            entry = None
    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    try:
        sass = subprocess.run([str(tool), "-sass", str(so)], check=True,
                              capture_output=True, text=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        sass = ""
        print(f"cuobjdump -sass failed: {e}", flush=True)
    counts, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\w+)", ln)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", ln):
            counts[fn] += 1
    out = []
    for e, (r, sp) in sorted(regs.items()):
        if "gap_bwd_kernel" in e:
            out.append(f"{cs.kernel_label(e)} {r} registers, {sp} spill "
                       f"bytes, {counts.get(e, 0)} instructions")
    return "; ".join(out) if out else "no ptxas output"


def mode_cell(dev: torch.device) -> None:
    from njode_tpu_torch.ops import fused_cell
    from njode_tpu_torch.simulation import simulate_batch
    t0 = time.perf_counter()
    fused_cell._load_kernel()
    print(f"[{ROOT}] build {time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(33)
    b = simulate_batch(cs.TRAIN_BS, "black_scholes", 0.1, True, generator=gen,
                       device=dev, mu=0.1, sigma=0.5, x0=1.0)
    model = NeuralJumpODE(use_pallas=True, device=dev,
                          generator=torch.Generator().manual_seed(0),
                          **cs.DEFAULT_MODEL_KW)
    B, N = b.times.shape
    weights = model._ode_weights()
    with torch.no_grad():
        h_j = model._jump(b.values.reshape(B * N, 1))
        K, d = h_j.shape[0], h_j.shape[-1]
        h0 = h_j.reshape(K, B, N, d)[:, :, :-1].reshape(K, -1, d).contiguous()
        x_s = model._scale(b.values[:, :-1].reshape(-1, 1))
        h_s = model._scale(h0)
        t_cur = b.times[:, :-1].reshape(-1)
        t_new = b.times[:, 1:].reshape(-1)
        cell = [a.contiguous() for a in fused_cell._cell_inputs(
            h0, x_s, h_s, t_cur, t_new, weights)]
        args = (cell[0], h0, *cell[1:], "relu")
        out, pre = fused_cell._launch(*args)
        ref = fused_cell.fused_cell_reference(*args)
        torch.cuda.synchronize()
        err = max(cs.assert_close(out, ref[0], "cell out"),
                  cs.assert_close(pre, ref[1], "cell pre"))
        wrap = [cs.time_ms(lambda: fused_cell._launch(*args))
                for _ in range(3)]

    def step():
        return fused_cell.ode_euler_fused(h0, x_s, h_s, t_cur, t_new, weights,
                                          "relu")
    # host-clocked times first: a profiler session slows the launches after
    # it
    step_ms = [cs.time_ms(step) for _ in range(3)]
    with torch.no_grad():
        kern = device_ms(lambda: fused_cell._launch(*args), n=20)
    one = device_ms(step, n=1)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    n_launch = sum(1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"[{ROOT}] row 6 at {B} x {N - 1} gaps (K_h {K}, d_h {d}, d_in "
          f"{cell[0].shape[-1]}, relu/identity): vs plain max abs err "
          f"{err:.2e}; kernel device ms (profiler, 20 calls) " + ", ".join(
              f"{n} {t:.4f}" for n, t in kern.items())
          + f"; _launch ms {[round(x, 4) for x in wrap]}; ode_euler_fused "
          f"with its preparation, under autograd, ms "
          f"{[round(x, 4) for x in step_ms]}, {n_launch} device launches a "
          f"call: " + ", ".join(f"{n} {t:.4f}" for n, t in one.items()),
          flush=True)


def mode_walkscan(dev: torch.device) -> None:
    from njode_tpu_torch.ops import walk_scan
    t0 = time.perf_counter()
    walk_scan._load_kernel()
    print(f"[{ROOT}] build {time.perf_counter() - t0:.1f} s", flush=True)
    for K in (1, 2):
        c = cs.walk_case(torch.Generator().manual_seed(62 + K), K, cs.PROD_BS,
                         cs.PROD_H, dev)
        hj = c["hj"].detach().requires_grad_()
        w = [x.detach().requires_grad_() for x in c["w"]]
        g_idx = torch.round(c["times"] / cs.PROD_DT).long()

        def fwd(fn):
            return fn(hj, c["x"], c["times"], c["mask"], g_idx, w, cs.PROD_DT,
                      cs.PROD_M, "relu", "identity")
        out = fwd(walk_scan.walk_gaps_fused)
        ours = [out.detach()] + list(torch.autograd.grad(
            out, [hj, *w], c["ct"], retain_graph=True))
        ref_out = fwd(walk_scan.walk_gaps_reference)
        ref = [ref_out.detach()] + list(torch.autograd.grad(
            ref_out, [hj, *w], c["ct"]))
        torch.cuda.synchronize()
        err_f = cs.assert_close(ours[0], ref[0], f"h_minus at K {K}")
        err_b = max(cs.assert_close_norm(a, b, f"d{n} at K {K}")
                    for n, a, b in zip(("h_jump", "W1", "b1", "W2", "b2"),
                                       ours[1:], ref[1:]))
        f_ms = [cs.time_ms(lambda: fwd(walk_scan.walk_gaps_fused))
                for _ in range(3)]
        b_ms = [cs.time_ms(lambda: torch.autograd.grad(
            out, [hj, *w], c["ct"], retain_graph=True)) for _ in range(3)]
        def fwd_bwd():
            fwd(walk_scan.walk_gaps_fused)
            torch.autograd.grad(out, [hj, *w], c["ct"], retain_graph=True)
        by_kernel = device_ms(fwd_bwd)
        fwd_alone = device_ms(lambda: fwd(walk_scan.walk_gaps_fused))
        print(f"[{ROOT}] rows 7-8 at {cs.PROD_BS} rows, H {cs.PROD_H}, K_h "
              f"{K}: forward ms {[round(x, 4) for x in f_ms]}, backward ms "
              f"{[round(x, 4) for x in b_ms]}; vs plain: forward max abs err "
              f"{err_f:.2e}, backward max abs err {err_b:.2e}; device ms a "
              f"forward + backward by kernel (profiler): " + ", ".join(
                  f"{n} {t:.4f}" for n, t in sorted(by_kernel.items(),
                                                    key=lambda x: -x[1]))
              + f"; the forward alone (5 calls, no backward between): "
              f"walk_fwd_kernel {fwd_alone.get('walk_fwd_kernel', 0.0):.4f}",
              flush=True)


def mode_recipe(dev: torch.device) -> None:
    tk._load_kernel()
    arm = "kernel"
    if "--plain" in ARGS:
        tk.fused_train_run, arm = tk.fused_train_run_reference, "plain"
    E = cs.TRAIN_EPOCHS
    for _ in range(2):
        model = NeuralJumpODE(1, 32, 1, num_moments=2, device=dev,
                              generator=torch.Generator().manual_seed(SEED))
        tr = Trainer(model, make_adam(model.parameters(), 1e-3, 5e-4),
                     ignore_first_continuity=True,
                     moment_weights=[1.0, 10.0], use_train_kernel=True)
        cfg = cs.default_config(E, "timed")
        train_fn, val_fn = create_data_loaders(base_seed=SEED + 1,
                                               device=dev,
                                               **cfg["data"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = tr.train(train_fn, val_fn, n_epochs=E, batch_size=128,
                        print_every=E, config=cfg)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        mm, mv, rel = cs.val_metrics(model, dev)
        print(f"[{ROOT}] default recipe ({arm}), seed {SEED}, {E} epochs: "
              f"{s:.3f} s = "
              f"{E * 1000 / s:.0f} traj/s; final train loss "
              f"{hist['train_loss'][-1]:.4f}; val MSE mean {mm:.3e} var "
              f"{mv:.3e}, relative loss {rel:.4f}", flush=True)


def entry_name(e: int, H: int) -> str:
    """The name of entry e of a network's flat parameter block."""
    HH = H * H
    if e < 4 * HH:
        return f"{('J2', 'O1', 'W1h', 'W2')[e // HH]}[{e % HH // H},{e % H}]"
    e -= 4 * HH
    vec = ("j1", "bj1", "bj2", "w1x", "w1t", "w1d", "b1", "b2", "bo1", "o2")
    return "bo2" if e == len(vec) * H else f"{vec[e // H]}[{e % H}]"


def mode_steps(dev: torch.device, spec: str) -> None:
    K, H, method, act, bs, G = spec.split(",")
    K, H, bs, G = int(K), int(H), int(bs), int(G)
    scale = dict(cs.ACT_PAIRS)[act]
    # chip_smoke.train_kernel_case's weights and data, built here so that
    # --root runs it on a tree without that helper
    model = NeuralJumpODE(1, H, 1, num_moments=K, activation=act,
                          input_scaling=scale, device=dev,
                          generator=torch.Generator().manual_seed(K * H))
    data = cs.train_data(dev, G * bs, bs, H + K, n_valid=G * bs - bs // 3)
    state = tk.init_train_state(model)
    kw = cs.train_kwargs(K, method, act, scale)
    kw.update(n_slots=data.shape[1] // 2, batch_size=bs)
    s64 = tk.TrainState(*(x.double() for x in state))

    def share(a, b):
        a, b = a.double(), b.double()
        return (a - b).abs() / (cs.ATOL + cs.RTOL * b.abs())

    for g in range(1, G + 1):
        with torch.no_grad():
            ours = tk.fused_train_run(state, data[:g * bs], **kw)
            ref = tk.fused_train_run_reference(state, data[:g * bs], **kw)
            r64 = tk.fused_train_run_reference(s64, data[:g * bs].double(),
                                               **kw)
        digest = hashlib.sha1(b"".join(
            x.cpu().numpy().tobytes() for x in ref[0])).hexdigest()[:12]
        line = " ".join(
            f"{n} {float(share(ours[0][i], ref[0][i]).max()):.3f}"
            f"/{float(share(ours[0][i], r64[0][i]).max()):.3f}"
            f"/{float(share(ref[0][i], r64[0][i]).max()):.3f}"
            for i, n in enumerate(("params", "m", "v")))
        print(f"[{ROOT}] {spec} after {g} steps, shares of the tolerance "
              f"kernel-plain/kernel-f64/plain-f64: {line}; plain state "
              f"{digest}", flush=True)
    P = state.params.shape[1]
    for i, n in enumerate(("params", "m")):
        top = torch.topk(share(ours[0][i], ref[0][i]).flatten(), 3)
        for val, idx in zip(top.values.tolist(), top.indices.tolist()):
            k, e = divmod(idx, P)
            kern, plain, f64 = (float(t[0][i].flatten()[idx])
                                for t in (ours, ref, r64))
            print(f"[{ROOT}]   {n} of net {k} {entry_name(e, H)}: share "
                  f"{val:.2f}; kernel {kern:.7e}, plain {plain:.7e}, "
                  f"float64 {f64:.7e}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ab_torch_training: no CUDA device")
    dev, _ = cs.device_phase()
    mode = ARGS[0] if ARGS else ""
    if mode == "gap":
        mode_gap(dev)
    elif mode == "gaptrain":
        mode_gaptrain(dev)
    elif mode == "cell":
        mode_cell(dev)
    elif mode == "bwd" and "--other" in ARGS:
        mode_bwd(dev, os.path.abspath(ARGS[ARGS.index("--other") + 1]))
    elif mode == "walkscan":
        mode_walkscan(dev)
    elif mode == "epoch":
        mode_epoch(dev)
    elif mode == "walk":
        mode_walk(dev)
    elif mode == "step":
        mode_step(dev)
    elif mode == "recipe":
        mode_recipe(dev)
    elif mode == "steps":
        mode_steps(dev, ARGS[1])
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main()
