#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure is an uncaught exception and a nonzero
exit:

1. device: the card's name and power limit (nvidia-smi); TF32 off.
2. build:  compile the CUDA kernel from njode_tpu_torch/ops/csrc.
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

The kernel's launch count is reset just before phases 4-5 and read just
after.  The last line is the JSON result; the line before it lists the
kernel.  There is no CPU run: without a CUDA device the script fails.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import time

import torch

from njode_tpu_torch import NeuralJumpODE, NJODEFilter
from njode_tpu_torch.models import pad_ragged
from njode_tpu_torch.ops import gap_scan
from njode_tpu_torch.simulation import simulate_batch

RTOL, ATOL = 1e-4, 1e-5
DT, N_SUB = 0.01, 100
KERNEL_SOURCE = "njode_tpu_torch/ops/csrc/gap_scan.cu"
REPLACES = "njode_tpu/ops/gap_scan.py:201"


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


def build_phase() -> None:
    from njode_tpu_torch.ops import _build
    t0 = time.perf_counter()
    gap_scan._load_kernel()
    took = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.BUILD_LOG.get("gap_scan", "").splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build: gap_scan.cu in {took:.2f} s; ptxas: {' | '.join(ptxas)}",
          flush=True)


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


def main() -> None:
    dev, card = device_phase()
    build_phase()
    max_err = kernel_phase(dev)

    model = production_model(dev)
    request = batch_request(dev)
    gap_scan.LAUNCHES = 0
    batch_phase(dev, model, request)
    streaming_phase(dev, model)
    launches = gap_scan.LAUNCHES

    k_ms, p_ms = timing_phase(dev, card, model, request)
    print(json.dumps({"kernels": [{
        "name": "gap_scan_fwd", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
