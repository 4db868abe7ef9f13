#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one CUDA card.

    python3 chip_smoke.py

Phases, one line each (phase 10 two); any failure is an uncaught exception
and a nonzero exit:

1. device: the card's name and power limit (nvidia-smi); TF32 off.
2. build:  compile both CUDA kernels from njode_tpu_torch/ops/csrc, one
   nvcc per source, started together; the gap kernel's line.
3. kernel vs plain: the whole-gap kernel against its plain PyTorch version
   over activation x scaling x K_h x d_h x rows, zero/partial gaps and
   max_substeps=0: h to rtol 1e-4 / atol 1e-5 (fma contraction and
   summation order over 100 substeps), t_L bitwise.
4. batch serving: 1,000 Black-Scholes streams x 21 queries through
   NeuralJumpODE.predict_at of the production model (hidden 50, shared, two
   moments, dt_ode_step 0.01), checked against the same model on the CPU
   (where the plain version runs); one separate-network request too.
5. streaming serving: NJODEFilter on 256 streams for 20 ticks, checked
   against predict_at on the same history.
6. times (CUDA events, median of 30 after warm-up): kernel vs plain,
   predict_at queries/s, filter tick latency.
7. build: the training kernel's build time and ptxas line (built in 2).
8. training kernel vs plain: fused_train_run against its plain version over
   8 steps of N = 10 slots, batch 128 with a trajectory-masked last
   minibatch, K in (1, 2) x H in (32, 64, 128) x direct/second_moment x
   relu/identity, tanh/tanh, selu/identity: per-step losses, params, Adam
   m and v to rtol 1e-4 / atol 1e-5 (f32 sums in other orders, and
   contracted multiply-adds, through 8 Adam steps).
9. the default training path: run_experiment of the default Black-Scholes
   config (the values experiments/common.py build_config makes from the
   CLI defaults) for 5 epochs on the card, one kernel launch per epoch,
   then a second call to 7 epochs that resumes at epoch 5; then one epoch
   of identical packed data through the kernel and the composed path
   (apply_loss + autograd + torch.optim.Adam) from identical weights, at
   the tolerance of phase 8.
10. training times (host clock around synchronized work, CUDA events for
   kernels): the full default recipe (200 epochs x 1,000 fresh
   trajectories) through Trainer.train with the kernel; the same recipe as
   one fused_train_run over all epochs' packed data, as bench.py runs it;
   the composed path (Trainer.train with the same validation) and the plain
   version, each warmed by one epoch, then 20 epochs timed and scaled to
   200;
   val MSE of the trained model against the closed-form moments
   (bench.py:435-455).

Each kernel's launch count is reset just before its main path (phases 4-5
for the gap kernel, phase 9 for the training kernel) and read just after.
The last line is the JSON result; the line before it lists the kernels.
There is no CPU run: without a CUDA device the script fails.
"""

from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from njode_tpu_torch import NeuralJumpODE, NJODEFilter
from njode_tpu_torch.models import nj_ode_loss_dense, pad_ragged
from njode_tpu_torch.ops import gap_scan
from njode_tpu_torch.ops import train_kernel as tk
from njode_tpu_torch.simulation import moments_at_obs, simulate_batch
from njode_tpu_torch.utils import (Trainer, create_data_loaders, make_adam,
                                   run_experiment)

RTOL, ATOL = 1e-4, 1e-5
DT, N_SUB = 0.01, 100
KERNEL_SOURCE = "njode_tpu_torch/ops/csrc/gap_scan.cu"
REPLACES = "njode_tpu/ops/gap_scan.py:201"
TRAIN_SOURCE = "njode_tpu_torch/ops/csrc/train_run.cu"
TRAIN_REPLACES = ("njode_tpu/ops/train_kernel.py:223 (_train_kernel), "
                  "njode_tpu/ops/train_kernel.py:478 (_train_kernel_dual)")
# the H100 SXM's published peaks: f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS, PEAK_BYTES = 67e12, 3.35e12


def device_phase() -> tuple[torch.device, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs on a CUDA card only")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0"), card


def build_phase() -> float:
    """Both kernels, one nvcc each, started together; prints the gap
    kernel's line and returns the build time."""
    from njode_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build(["gap_scan", "train_run"])
    gap_scan._load_kernel()
    tk._load_kernel()
    took = time.perf_counter() - t0
    print(f"build: gap_scan.cu in {took:.2f} s (with train_run.cu, in "
          f"parallel); ptxas: {ptxas_line('gap_scan')}", flush=True)
    return took


def ptxas_line(name: str) -> str:
    from njode_tpu_torch.ops import _build
    return " | ".join(ln.strip() for ln in _build.BUILD_LOG.get(
        name, "").splitlines() if "registers" in ln or "spill" in ln)


def gap_case(gen: torch.Generator, K: int, R: int, d_h: int, d_x: int,
             n_sub: int, dev: torch.device) -> dict:
    """Random gap inputs: zero gaps, gaps shorter than dt, gaps ending on a
    grid point, and gaps up to the full budget; torch-default weight law."""
    def uni(shape, bound):
        return (torch.rand(shape, generator=gen) * 2 - 1) * bound
    d_in = d_h + d_x + 2
    t0 = torch.floor(torch.rand(R, generator=gen) * 50) * DT   # on the grid
    kind = torch.randint(0, 4, (R,), generator=gen)
    steps = torch.randint(0, n_sub + 1, (R,), generator=gen).float()
    free = torch.rand(R, generator=gen) * (n_sub + 1) * DT
    short = torch.rand(R, generator=gen) * DT
    gap = torch.where(kind == 0, 0.0, torch.where(
        kind == 1, short, torch.where(kind == 2, steps * DT, free)))
    case = {
        "h": torch.randn(K, R, d_h, generator=gen) * 0.5,
        "x_scaled": torch.randn(R, d_x, generator=gen),
        "t_last": t0, "t_target": t0 + gap,
        "weights": gap_scan.split_weights((uni((K, d_h, d_in), d_in ** -0.5),
                                           uni((K, d_h), d_in ** -0.5),
                                           uni((K, d_h, d_h), d_h ** -0.5),
                                           uni((K, d_h), d_h ** -0.5))),
    }
    return {k: (gap_scan.GapWeights(*(w.to(dev) for w in v)) if k == "weights"
                else v.to(dev)) for k, v in case.items()}


def substep_args(c: dict, n_sub: int, act: str, scale: str) -> tuple:
    """The kernel's own arguments for a case (what the wrapper hands it)."""
    return gap_scan.substep_inputs(c["h"], c["x_scaled"], c["t_last"],
                                   c["t_target"], c["weights"], DT) + (
        DT, n_sub, act, scale)


def kernel_phase(dev: torch.device) -> float:
    gen = torch.Generator().manual_seed(3)
    worst_abs = worst_rel = 0.0
    n_cases = 0
    cases = [(d_h, R, K, act, scale, N_SUB)
             for d_h in (50, 256) for R in (1, 37, 21000) for K in (1, 2)
             for act in gap_scan.SUPPORTED_ACTS for scale in gap_scan.SCALINGS]
    cases += [(50, 37, K, act, "tanh", 0) for K in (1, 2)
              for act in ("relu", "selu")]
    with torch.no_grad():
        for d_h, R, K, act, scale, n_sub in cases:
            c = gap_case(gen, K, R, d_h, 1, max(n_sub, 1), dev)
            args = substep_args(c, n_sub, act, scale)
            h_k, t_k = gap_scan.gap_substeps(*args)
            h_p, t_p = gap_scan.gap_substeps_reference(*args)
            full = (c["h"], c["x_scaled"], c["t_last"], c["t_target"],
                    c["weights"], DT, n_sub, act, scale)
            f_k, ft_k = gap_scan.integrate_gap_fused(*full)
            f_p, ft_p = gap_scan.integrate_gap_reference(*full)
            torch.cuda.synchronize()
            where = f"d_h={d_h} R={R} K={K} act={act} scale={scale} n_sub={n_sub}"
            for a, b in ((t_k, t_p), (ft_k, ft_p)):
                if not torch.equal(a, b):
                    raise AssertionError(f"t_L not bitwise equal at {where}: "
                                         f"{int((a != b).sum())} rows differ")
            for a, b, what in ((h_k, h_p, "h_L"), (f_k, f_p, "h(t_target)")):
                if not torch.isfinite(a).all():
                    raise AssertionError(f"non-finite {what} at {where}")
                err = (a - b).abs()
                bad = err > ATOL + RTOL * b.abs()
                if bad.any():
                    raise AssertionError(
                        f"{what} differs at {where}: max abs err "
                        f"{float(err.max()):.3e}, {int(bad.sum())} entries "
                        "beyond tolerance")
                worst_abs = max(worst_abs, float(err.max()))
                worst_rel = max(worst_rel, float(
                    (err / (b.abs() + ATOL)).max()))
            n_cases += 1
    print(f"kernel vs plain: {n_cases} cases (act x scaling x K_h in (1, 2) x "
          f"d_h in (50, 256) x R in (1, 37, 21000), + max_substeps=0): "
          f"max abs err {worst_abs:.3e}, max err/(|ref|+atol) "
          f"{worst_rel:.3e}; t_L bitwise equal", flush=True)
    return worst_abs


def assert_close(a: torch.Tensor, b: torch.Tensor, what: str,
                 rtol: float = RTOL, atol: float = ATOL) -> float:
    a, b = a.cpu(), b.cpu()
    if not torch.isfinite(a).all():
        raise AssertionError(f"{what}: non-finite values")
    err = (a - b).abs()
    if (err > atol + rtol * b.abs()).any():
        raise AssertionError(f"{what}: max abs err {float(err.max()):.3e} "
                             f"beyond rtol={rtol} atol={atol}")
    return float(err.max())


def production_model(dev: torch.device, shared: bool = True) -> NeuralJumpODE:
    return NeuralJumpODE(
        input_dim=1, hidden_dim=50, output_dim=1, num_moments=2,
        n_hidden_layers=1, activation="relu", input_scaling="identity",
        shared_network=shared, dt_ode_step=DT, t_max=1.0, device=dev,
        generator=torch.Generator().manual_seed(0 if shared else 1))


def batch_request(dev: torch.device, n_streams: int = 1000, n_queries: int = 21):
    """BS streams (mu 0.1, sigma 0.5, x0 1, T 1, 100 steps, 10 observations);
    every 4th stream loses its first 3 observations, so its history is
    end-padded and it has queries before its first observation."""
    gen = torch.Generator().manual_seed(1)
    b = simulate_batch(n_streams, "black_scholes", 0.1, generator=gen,
                       mu=0.1, sigma=0.5, x0=1.0, T=1.0, n_steps=100)
    times = [t[3:] if i % 4 == 0 else t for i, t in enumerate(b.times)]
    values = [v[3:] if i % 4 == 0 else v for i, v in enumerate(b.values)]
    obs_t, obs_v, mask = pad_ragged(times, values, device=dev)
    query = torch.sort(torch.rand(n_streams, n_queries, generator=gen),
                       dim=1).values.to(dev)
    return obs_t, obs_v, query, mask


def batch_phase(dev: torch.device, model: NeuralJumpODE, request) -> None:
    obs_t, obs_v, query, mask = request
    out = model.predict_at(obs_t, obs_v, query, mask)
    torch.cuda.synchronize()
    launched = gap_scan.LAUNCHES
    if launched == 0:
        raise AssertionError("predict_at did not launch the gap kernel")
    raw = out["raw"]
    if raw.shape != (1000, 21, 1, 2) or not torch.isfinite(raw).all():
        raise AssertionError(f"predict_at raw: shape {tuple(raw.shape)}, "
                             "or non-finite values")
    first = torch.where(mask, obs_t, torch.inf)[:, :1]
    before = query < first
    if not before.any() or (raw[before] != 0).any():
        raise AssertionError("queries before the first observation must "
                             "exist and read exactly 0")
    cpu_model = copy.deepcopy(model).to("cpu")
    ref = cpu_model.predict_at(obs_t.cpu(), obs_v.cpu(), query.cpu(),
                               mask.cpu())
    err = assert_close(raw, ref["raw"], "predict_at vs plain (CPU)")
    assert_close(out["var"], ref["var"], "predict_at var vs plain (CPU)")

    sep = production_model(dev, shared=False)
    req = (obs_t[:64], obs_v[:64], query[:64], mask[:64])
    out_sep = sep.predict_at(*req)
    ref_sep = copy.deepcopy(sep).to("cpu").predict_at(
        *(x.cpu() for x in req))
    err_sep = assert_close(out_sep["raw"], ref_sep["raw"],
                           "separate-network predict_at vs plain (CPU)")
    print(f"batch serving: 21,000 queries (1,000 streams x 21), "
          f"{int(before.sum())} before the first observation read 0; "
          f"max abs err vs plain {err:.3e}; separate-network K=2 request "
          f"(64 x 21) max abs err {err_sep:.3e}; launches "
          f"{gap_scan.LAUNCHES} (predict_at {launched})", flush=True)


def stream_ticks(n_streams: int = 256, n_ticks: int = 20):
    gen = torch.Generator().manual_seed(2)
    ts = [0.02 * (i + 1) for i in range(n_ticks)]
    xs = 1.0 + 0.1 * torch.randn(n_ticks, n_streams, 1, generator=gen)
    return ts, xs


def streaming_phase(dev: torch.device, model: NeuralJumpODE) -> None:
    filt = NJODEFilter(model)
    ts, xs = stream_ticks()
    xs = xs.to(dev)
    state = filt.init_state(xs.shape[1])
    before = gap_scan.LAUNCHES
    for t, x in zip(ts, xs):
        state = filt.update(state, t, x)
        out = filt.predict(state, t + 0.02)
    torch.cuda.synchronize()
    if gap_scan.LAUNCHES <= before:
        raise AssertionError("NJODEFilter.predict did not launch the kernel")
    n = xs.shape[1]
    obs_t = torch.tensor(ts, dtype=torch.float32, device=dev).expand(n, -1)
    obs_v = xs.permute(1, 0, 2)
    query = torch.full((n, 1), ts[-1] + 0.02, dtype=torch.float32, device=dev)
    pa = model.predict_at(obs_t, obs_v, query)
    err = assert_close(out["raw"], pa["raw"][:, 0], "filter vs predict_at",
                       rtol=1e-5, atol=1e-5)
    print(f"streaming serving: {n} streams x {len(ts)} ticks (update at "
          f"t=0.02 i, predict at t+0.02); last predictions vs predict_at on "
          f"the same history max abs err {err:.3e}; launches "
          f"{gap_scan.LAUNCHES - before}", flush=True)


def time_ms(fn, warmup: int = 5, reps: int = 30) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def gap_rows(model: NeuralJumpODE, obs_t, obs_v, query, mask=None) -> tuple:
    """The kernel's arguments as predict_at builds them for a request."""
    with model._inference():
        x, t_last, t_q, _ = model._query_rows(obs_t, obs_v, query, mask)
        c = {"h": model._jump(x), "x_scaled": model._scale(x),
             "t_last": t_last, "t_target": t_q,
             "weights": model._gap_weights()}
    return substep_args(c, model.max_substeps, model._act_key,
                        model._scale_key)


def timing_phase(dev: torch.device, card: str, model: NeuralJumpODE,
                 request) -> tuple[float, float]:
    obs_t, obs_v, query, mask = request
    args = gap_rows(model, obs_t, obs_v, query, mask)
    with torch.no_grad():  # in turns: plain, kernel, kernel, plain
        p_ms = time_ms(lambda: gap_scan.gap_substeps_reference(*args))
        k_ms = time_ms(lambda: gap_scan.gap_substeps(*args))
        k2_ms = time_ms(lambda: gap_scan.gap_substeps(*args))
        p2_ms = time_ms(lambda: gap_scan.gap_substeps_reference(*args))
    ts, xs = stream_ticks()
    xs = xs.to(dev)
    filt = NJODEFilter(model)
    state = filt.update(filt.init_state(xs.shape[1]), ts[-1], xs[-1])
    f_args = gap_rows(model, state.t_last[:, None], xs[-1][:, None],
                      state.t_last[:, None] + 0.02)
    with torch.no_grad():
        fk_ms = time_ms(lambda: gap_scan.gap_substeps(*f_args))
        fp_ms = time_ms(lambda: gap_scan.gap_substeps_reference(*f_args))
    # the width of bench.py --scaled, gaps of every kind up to the budget
    wide = substep_args(gap_case(torch.Generator().manual_seed(4), 1,
                                 query.numel(), 256, 1, N_SUB, dev),
                        N_SUB, "relu", "identity")
    with torch.no_grad():
        wk_ms = time_ms(lambda: gap_scan.gap_substeps(*wide))
        wp_ms = time_ms(lambda: gap_scan.gap_substeps_reference(*wide))
    pa_ms = time_ms(lambda: model.predict_at(obs_t, obs_v, query, mask))

    def tick():
        s = filt.update(state, ts[-1], xs[-1])
        filt.predict(s, ts[-1] + 0.02)
    tick_ms = time_ms(tick)
    n_q = query.numel()
    print(f"times on {card}: gap kernel {k_ms:.4f} / {k2_ms:.4f} ms vs plain "
          f"{p_ms:.4f} / {p2_ms:.4f} ms at the predict_at shape (R={n_q}, "
          f"d_h=50, max_substeps={model.max_substeps}); at the filter shape "
          f"(R={xs.shape[1]}, gap 0.02) kernel {fk_ms:.4f} ms vs plain "
          f"{fp_ms:.4f} ms; at d_h=256 (R={n_q}, random gaps) kernel "
          f"{wk_ms:.4f} ms vs plain {wp_ms:.4f} ms; predict_at {pa_ms:.4f} ms = "
          f"{n_q / (pa_ms / 1e3):.0f} queries/s; filter tick (update + "
          f"predict, {xs.shape[1]} streams) {tick_ms:.4f} ms", flush=True)
    return statistics.median([k_ms, k2_ms]), statistics.median([p_ms, p2_ms])


def gap_bound(args: tuple) -> tuple[float, str]:
    """Least time of one gap_substeps call on the H100: the larger of its
    f32 work over 67 TFLOP/s (per row and full substep taken, two d_h x d_h
    products and the elementwise update: 4 d_h^2 + 4 d_h, the substeps
    counted from this request's t_L) and its bytes (each input read once,
    each output written once) over 3.35 TB/s."""
    h, base, t_last, t_target, w1h, w1t, w2, b2, dt = args[:9]
    K, R, d_h = h.shape
    with torch.no_grad():
        _, t_l = gap_scan.gap_substeps_reference(*args)
    steps = float(torch.round((t_l - t_last) / dt).sum())
    flops = K * steps * (4 * d_h * d_h + 4 * d_h)
    n_bytes = 4 * (2 * h.numel() + base.numel() + 2 * t_last.numel()
                   + t_target.numel() + w1h.numel() + w1t.numel()
                   + w2.numel() + b2.numel())
    return bound_of(flops, n_bytes)


def bound_of(flops: float, n_bytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, n_bytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------- training

TRAIN_N, TRAIN_BS, TRAIN_G = 10, 128, 8
TRAIN_EPOCHS = 200           # the default recipe's
COMPARED_EPOCHS = 20         # timed epochs of the composed and plain arms
ACT_PAIRS = (("relu", "identity"), ("tanh", "tanh"), ("selu", "identity"))


def default_config(n_epochs: int, name: str) -> dict:
    """What experiments/common.py build_config makes from the CLI defaults
    of experiments/experiment_black_scholes.py (obs_only resolves on for
    Black-Scholes; --kernels auto is use_pallas 'auto')."""
    return {
        "experiment_name": name, "input_dim": 1, "hidden_dim": 32,
        "output_dim": 1, "n_hidden_layers": 1, "activation": "relu",
        "dropout_rate": 0.0, "input_scaling": "identity",
        "variance_method": "direct", "dt_ode_step": None,
        "ode_solver": "euler", "learning_rate": 1e-3, "weight_decay": 5e-4,
        "n_epochs": n_epochs, "batch_size": 128, "shuffle": True,
        "print_every": 5, "device": "auto", "ignore_first_continuity": True,
        "num_moments": 2, "moment_weights": [1.0, 10.0],
        "shared_network": False, "extended_moments": False,
        "data_parallel": 0, "model_parallel": 1,
        "model_parallel_mode": None, "multihost": False,
        "coordinator_address": None, "num_processes": None,
        "process_id": None, "compute_dtype": "float32",
        "checkpoint_backend": "msgpack", "ensemble": 0,
        "ensemble_lrs": None, "use_pallas": "auto", "grid_walk": "auto",
        "train_kernel_mxu": "float32", "debug_checks": False, "seed": 0,
        "data_seed": 0,
        "data": {"process_type": "black_scholes", "n_train": 1000,
                 "n_val": 200, "obs_fraction": 0.1, "cache_data": False,
                 "obs_only": True, "T": 1.0, "n_steps": 100, "mu": 0.1,
                 "sigma": 0.5, "x0": 1.0},
    }


def train_data(dev: torch.device, n_traj: int, bs: int, seed: int,
               n_valid=None) -> torch.Tensor:
    """Packed kernel rows of fresh obs-only BS trajectories (the default
    recipe's law), the last n_traj - n_valid rows padding that repeats
    row 0, as the Trainer pads its last minibatch."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    b = simulate_batch(n_traj, "black_scholes", 0.1, True, generator=gen,
                       device=dev, mu=0.1, sigma=0.5, x0=1.0)
    n_valid = n_traj if n_valid is None else n_valid
    valid = torch.arange(n_traj, device=dev) < n_valid
    times = torch.where(valid[:, None], b.times, b.times[:1])
    values = torch.where(valid[:, None, None], b.values, b.values[:1])
    return tk.pack_minibatches(times, values, valid, bs)


def train_kwargs(K: int, method: str = "direct", act: str = "relu",
                 scale: str = "identity") -> dict:
    return dict(n_slots=TRAIN_N, num_moments=K, batch_size=TRAIN_BS,
                activation=act, input_scaling=scale, lr=1e-3,
                weight_decay=5e-4, moment_weights=(1.0, 10.0),
                variance_method=method)


def compare_state(ours, ref, where: str) -> float:
    """Losses, params, m and v at RTOL/ATOL; returns the largest abs err."""
    worst = 0.0
    for a, b, what in ((ours[1], ref[1], "losses"),
                       (ours[0].params, ref[0].params, "params"),
                       (ours[0].m, ref[0].m, "Adam m"),
                       (ours[0].v, ref[0].v, "Adam v")):
        worst = max(worst, assert_close(a, b, f"{what} at {where}"))
    return worst


def train_kernel_phase(dev: torch.device) -> float:
    worst, n_cases = 0.0, 0
    plans = {}
    n_rows = TRAIN_G * TRAIN_BS
    for K in (1, 2):
        for H in (32, 64, 128):
            plans[H] = tk.launch_plan(H, TRAIN_N, TRAIN_BS)
            for method in ("direct", "second_moment"):
                for act, scale in ACT_PAIRS:
                    model = NeuralJumpODE(
                        1, H, 1, num_moments=K, activation=act,
                        input_scaling=scale, device=dev,
                        generator=torch.Generator().manual_seed(K * H))
                    data = train_data(dev, n_rows, TRAIN_BS, H + K,
                                      n_valid=n_rows - TRAIN_BS // 3)
                    state = tk.init_train_state(model)
                    kw = train_kwargs(K, method, act, scale)
                    with torch.no_grad():
                        ours = tk.fused_train_run(state, data, **kw)
                        torch.cuda.synchronize()
                        ref = tk.fused_train_run_reference(state, data, **kw)
                    worst = max(worst, compare_state(
                        ours, ref, f"K={K} H={H} {method} {act}/{scale}"))
                    n_cases += 1
    print(f"training kernel vs plain: {n_cases} cases (K in (1, 2) x H in "
          f"(32, 64, 128) x direct/second_moment x relu/identity, tanh/tanh, "
          f"selu/identity; N={TRAIN_N}, batch {TRAIN_BS}, {TRAIN_G} steps, "
          f"last minibatch {TRAIN_BS // 3} rows masked): losses, params, m, v "
          f"max abs err {worst:.3e} at rtol {RTOL} / atol {ATOL}; plans "
          f"(warps, weights staged, smem bytes) {plans}", flush=True)
    return worst


def training_path_phase(dev: torch.device, tmp: Path) -> None:
    """run_experiment of the default config, 5 epochs then a resume to 7;
    one epoch through the kernel and the composed path from the same
    weights.  The caller resets the launch count before."""
    cfg = default_config(5, "default_bs")
    res = run_experiment(cfg, save_dir=str(tmp))
    torch.cuda.synchronize()
    after5 = tk.LAUNCHES
    hist = res["history"]["train_loss"]
    if after5 != 5 or len(hist) != 5:
        raise AssertionError(f"5 epochs gave {after5} kernel launches and "
                             f"{len(hist)} losses; expected 5 and 5")
    if not all(math.isfinite(x) for x in hist + res["history"]["val_loss"]):
        raise AssertionError(f"non-finite losses {hist}")
    run = tmp / "default_bs"
    for name in ("config.json", "model.ckpt", "history.json"):
        if not (run / name).is_file():
            raise AssertionError(f"run_experiment wrote no {name}")
    res7 = run_experiment(default_config(7, "default_bs"), save_dir=str(tmp))
    torch.cuda.synchronize()
    hist7 = json.loads((run / "history.json").read_text())["train_loss"]
    if tk.LAUNCHES != 7 or len(hist7) != 7 or hist7[:5] != hist:
        raise AssertionError(f"the resume to 7 epochs gave {tk.LAUNCHES} "
                             f"launches in all and {len(hist7)} losses")
    print(f"default training path: run_experiment (hidden 32, K=2 separate, "
          f"batch 128, 1,000 fresh obs-only BS trajectories per epoch) 5 "
          f"epochs: train loss {hist[0]:.4f} -> {hist[-1]:.4f}, val "
          f"{res['history']['val_loss'][-1]:.4f}, kernel launches {after5}; "
          f"resumed to 7 epochs (loss {res7['final_train_loss']:.4f}), "
          f"launches {tk.LAUNCHES}", flush=True)


def kernel_vs_composed_phase(dev: torch.device) -> float:
    """One epoch of identical packed data (1,000 trajectories, 8 steps)
    through the kernel and through apply_loss + autograd + Adam."""
    model = NeuralJumpODE(1, 32, 1, num_moments=2, device=dev,
                          generator=torch.Generator().manual_seed(5))
    data = train_data(dev, 1024, TRAIN_BS, 11, n_valid=1000)
    kw = train_kwargs(2)
    with torch.no_grad():
        state, k_losses = tk.fused_train_run(tk.init_train_state(model),
                                             data, **kw)
    opt = make_adam(model.parameters(), 1e-3, 5e-4)
    c_losses = []
    N = TRAIN_N
    for g in range(data.shape[0] // TRAIN_BS):
        rows = data[g * TRAIN_BS:(g + 1) * TRAIN_BS]
        opt.zero_grad()
        loss = model.apply_loss(
            rows[:, N:2 * N], rows[:, :N, None], traj_mask=rows[:, 2 * N] > 0,
            ignore_first_continuity=True, moment_weights=[1.0, 10.0])
        loss.backward()
        opt.step()
        c_losses.append(loss.detach())
    err = assert_close(k_losses, torch.stack(c_losses),
                       "kernel vs composed per-step losses")
    ref = tk.init_train_state(model).params
    err = max(err, assert_close(state.params, ref,
                                "kernel vs composed params after an epoch"))
    print(f"kernel vs composed path: one epoch (8 steps) from identical "
          f"weights, per-step losses and params max abs err {err:.3e}",
          flush=True)
    return err


def val_metrics(model: NeuralJumpODE, dev: torch.device) -> tuple:
    """bench.py:435-455: 200 fresh grid-simulated trajectories; MSE of the
    before-jump mean and variance (direct: W^2) against the closed-form
    truths past slot 0, and the relative loss."""
    gen = torch.Generator(device=dev).manual_seed(7)
    vb = simulate_batch(200, "black_scholes", 0.1, generator=gen, device=dev,
                        mu=0.1, sigma=0.5, x0=1.0)
    with torch.no_grad():
        preds, before = model.apply(vb.times, vb.values, vb.mask)
        yt, ytb = moments_at_obs(vb.times, vb.values, "black_scholes",
                                 num_moments=2, mu=0.1, sigma=0.5)
        mse_mean = float(((before[:, 1:, :, 0] - ytb[:, 1:, :, 0]) ** 2).mean())
        mse_var = float(((before[:, 1:, :, 1] ** 2 - ytb[:, 1:, :, 1]) ** 2)
                        .mean())
        L_model = float(nj_ode_loss_dense(vb.values, preds, before, vb.mask,
                                          moment_weights=[1.0, 10.0]))
        L_true = float(nj_ode_loss_dense(vb.values, yt, ytb, vb.mask,
                                         moment_weights=[1.0, 10.0]))
    return mse_mean, mse_var, (L_model - L_true) / max(L_true, 1e-8)


def training_times_phase(dev: torch.device, card: str, tmp: Path) -> tuple:
    """Phase 10.  Returns (kernel ms per epoch call, plain ms per epoch
    call, bound ms per epoch call, bound_by)."""
    E, n = TRAIN_EPOCHS, 1000
    # the whole recipe through Trainer.train with the kernel
    model = NeuralJumpODE(1, 32, 1, num_moments=2, device=dev,
                          generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, make_adam(model.parameters(), 1e-3, 5e-4),
                      ignore_first_continuity=True,
                      moment_weights=[1.0, 10.0], use_train_kernel=True)
    cfg = default_config(E, "timed")
    train_fn, val_fn = create_data_loaders(base_seed=1, device=dev,
                                           **cfg["data"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = trainer.train(train_fn, val_fn, n_epochs=E, batch_size=128,
                         print_every=E, config=cfg)
    torch.cuda.synchronize()
    trainer_s = time.perf_counter() - t0
    mse_mean, mse_var, rel = val_metrics(model, dev)

    # one epoch's kernel call and its plain version, CUDA events
    data = train_data(dev, 1024, TRAIN_BS, 3, n_valid=n)
    state = tk.init_train_state(model)
    kw = train_kwargs(2)
    with torch.no_grad():
        run_k = lambda: tk.fused_train_run(state, data, **kw)
        run_p = lambda: tk.fused_train_run_reference(state, data, **kw)
        p_ms = time_ms(run_p, warmup=2, reps=5)
        k_ms = time_ms(run_k, warmup=2, reps=10)
        k2_ms = time_ms(run_k, warmup=0, reps=10)
        p2_ms = time_ms(run_p, warmup=0, reps=5)
    # bench.py:468-481's count: forward matmul flops x 3, valid trajectories
    H, K, S = 32, 2, TRAIN_N - 1
    fwd = K * 2 * (TRAIN_N * (H + H * H) + (2 * TRAIN_N - 1) * (H * H + H)
                   + S * ((H + 3) * H + H * H))
    P = tk.n_params_per_net(H)
    epoch_bytes = 4 * (data.numel() + 2 * 3 * K * P + 2 * 2
                       + data.shape[0] // TRAIN_BS)
    bound_ms, bound_by = bound_of(3 * fwd * n, epoch_bytes)

    # the recipe as one call over all epochs' packed data (bench.py's way)
    all_data = torch.cat([train_data(dev, 1024, TRAIN_BS, 100 + e, n_valid=n)
                          for e in range(E)])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    with torch.no_grad():
        start.record()
        _, losses = tk.fused_train_run(tk.init_train_state(model), all_data,
                                       **kw)
        end.record()
        end.synchronize()
    one_call_ms = start.elapsed_time(end)
    if not torch.isfinite(losses).all():
        raise AssertionError("non-finite losses in the one-call recipe")

    # the composed path through Trainer.train, with the kernel arm's
    # validation and relative loss, and the plain version over packed
    # epochs: each warmed by one epoch, then COMPARED_EPOCHS timed and
    # scaled to E
    comp = NeuralJumpODE(1, 32, 1, num_moments=2, device=dev,
                         generator=torch.Generator().manual_seed(0))
    comp_tr = Trainer(comp, make_adam(comp.parameters(), 1e-3, 5e-4),
                      ignore_first_continuity=True,
                      moment_weights=[1.0, 10.0], use_train_kernel=False)
    comp_tr.train(train_fn, val_fn, n_epochs=1, batch_size=128,
                  print_every=E, config=cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comp_tr.train(train_fn, val_fn, n_epochs=COMPARED_EPOCHS, batch_size=128,
                  print_every=E, config=cfg)
    torch.cuda.synchronize()
    comp_s = (time.perf_counter() - t0) * E / COMPARED_EPOCHS
    with torch.no_grad():
        st = tk.init_train_state(comp)
        st, _ = tk.fused_train_run_reference(st, all_data[:1024], **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for e in range(COMPARED_EPOCHS):
            st, _ = tk.fused_train_run_reference(
                st, all_data[e * 1024:(e + 1) * 1024], **kw)
        torch.cuda.synchronize()
    plain_s = (time.perf_counter() - t0) * E / COMPARED_EPOCHS
    step_ms = statistics.median([k_ms, k2_ms]) / (1024 // TRAIN_BS)
    print(f"training times on {card}: default recipe ({E} epochs x {n} fresh "
          f"trajectories) through Trainer.train with the kernel "
          f"{trainer_s:.3f} s = {E * n / trainer_s:.0f} traj/s (final train "
          f"loss {hist['train_loss'][-1]:.4f}); as one fused_train_run over "
          f"all epochs' packed data {one_call_ms / 1e3:.3f} s = "
          f"{E * n / (one_call_ms / 1e3):.0f} traj/s; composed path through "
          f"Trainer.train ({COMPARED_EPOCHS} epochs after one warm-up, scaled "
          f"to {E}): {comp_s:.3f} s = {E * n / comp_s:.0f} traj/s; plain "
          f"version ({COMPARED_EPOCHS} epoch calls after one, scaled): "
          f"{plain_s:.3f} s", flush=True)
    print(f"training kernel on {card}: one epoch call (8 steps, 1,024 rows) "
          f"{k_ms:.3f} / {k2_ms:.3f} ms = {step_ms:.4f} ms per step, plain "
          f"version {p_ms:.3f} / {p2_ms:.3f} ms; bound {bound_ms:.4f} ms "
          f"({bound_by}); val MSE mean {mse_mean:.3e} var {mse_var:.3e}, "
          f"relative loss {rel:.4f}", flush=True)
    return (statistics.median([k_ms, k2_ms]), statistics.median([p_ms, p2_ms]),
            bound_ms, bound_by)


def main() -> None:
    dev, card = device_phase()
    build_s = build_phase()
    max_err = kernel_phase(dev)

    model = production_model(dev)
    request = batch_request(dev)
    gap_scan.LAUNCHES = 0
    batch_phase(dev, model, request)
    streaming_phase(dev, model)
    launches = gap_scan.LAUNCHES

    k_ms, p_ms = timing_phase(dev, card, model, request)
    g_bound, g_by = gap_bound(gap_rows(model, *request))

    print(f"build: train_run.cu in {build_s:.2f} s (with gap_scan.cu, in "
          f"parallel); ptxas: {ptxas_line('train_run')}", flush=True)
    t_err = train_kernel_phase(dev)
    with tempfile.TemporaryDirectory() as tmp:
        tk.LAUNCHES = 0
        training_path_phase(dev, Path(tmp))
        t_launches = tk.LAUNCHES
        t_err = max(t_err, kernel_vs_composed_phase(dev))
        tk_ms, tp_ms, t_bound, t_by = training_times_phase(dev, card,
                                                           Path(tmp))
    print(json.dumps({"kernels": [{
        "name": "gap_scan_fwd", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": g_bound, "bound_by": g_by,
        "library_ms": None}, {
        "name": "train_run", "route": "cuda", "source": TRAIN_SOURCE,
        "replaces": TRAIN_REPLACES, "launches": t_launches,
        "max_abs_err": t_err, "ms": tk_ms, "plain_ms": tp_ms,
        "bound_ms": t_bound, "bound_by": t_by, "library_ms": None}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
