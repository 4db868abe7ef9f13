"""A/B runs of the training kernels (rows 9-13) on one CUDA card.

    python scripts/ab_torch_training.py epoch [--root DIR] [--launch]
    python scripts/ab_torch_training.py walk [--root DIR]
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
entrywise, an epoch call here is 40).  ``step``: one call each of the
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
    state = wt.init_walk_state(cs.walk_model(dev, seed=0))
    ms, err = epoch_ms(state, data, kw, kernel=wt.fused_walk_train_run,
                       plain=wt.fused_walk_train_run_reference)
    print(f"[{ROOT}] walk-train epoch call ({n_rows // cs.PROD_BS} steps of "
          f"{cs.PROD_BS}, H {cs.PROD_H}, M {cs.PROD_M}) ms "
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
    if mode == "epoch":
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
