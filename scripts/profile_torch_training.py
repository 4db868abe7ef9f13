"""Where the time of the PyTorch port's training runs goes, on one CUDA card.

1. torch.profiler over 10 epochs of the default Black-Scholes recipe
   (hidden 32, two separate moment networks, batch 128, 1,000 fresh obs-only
   trajectories per epoch, validation on 200) through ``Trainer.train``,
   once with the whole-run kernel and once on the composed path: host wall
   per epoch, device time per epoch, the device's idle share, and the ops
   that take the most device and host time.  The kernel path's Chrome trace
   goes to chiprun_out/.
2. The kernel's own split: a copy of ops/csrc/train_run.cu with clock64()
   probes read by each block's first thread (the weights' staging and the
   valid count, phase A's forwards to the block barrier after them, its
   cotangents and backward, the block's partial sums, the grid barrier
   after phase A, phase B's sums of the partials with Adam, the grid
   barrier ending the step) is built with nvcc into a temporary directory
   and run for one 8-step epoch call at the default shape; it prints the
   cycles of each phase, mean over blocks.  The probes cost a few percent;
   the shipped kernel has none.

With ``--production``, instead: torch.profiler over 5 epochs of the
production recipe (``scripts/run_black_scholes.sh``: hidden 50, shared
network, dt_ode_step 0.01, batch 256, 10,000 fresh trajectories per epoch,
validation on 2,000) through ``Trainer.train`` on the walk-train kernel:
host wall and device time per epoch, the device's idle share, device
launches per epoch and the top ops; its Chrome trace goes to the same
output directory.
Then the walk-train kernel's own split, from a copy of
ops/csrc/walk_train.cu with clock64() probes read by each block's first
thread (the weights' staging, jump forward, forward walk, readouts with the
loss and the readout backward, the backward walk, the jump backward, the
grid barrier after the walk, the gradient sums with Adam, the barrier
ending the step), over one epoch call.

With ``--scaled``, instead: torch.profiler over 3 epochs of the scaled
recipe (``scripts/run_scaled_sweep.sh``: hidden 256, two separate moment
networks, batch 4,096, 100,000 fresh trajectories per epoch, validation on
5,000) through ``Trainer.train``, once on the fused-step kernels
(``use_pallas="step"``) and once on the composed path (``False``), each
after one epoch of warm-up: host wall and device time per epoch, the
device's idle share, device launches per epoch and the top ops; the
fused-step arm's Chrome trace goes to the same output directory.  Then
rows 9-10's and 9b-10b's own split at that shape, from a copy of
ops/csrc/fused_step.cu with clock64() probes read by each block's first
thread (the tensor-core products to the barrier after them, their
epilogues, the weight-gradient sums, the rest), over one call of each.

With ``--forced``, instead: torch.profiler over 3 epochs of each forced
recipe (``use_pallas=True``, the CLI's ``--kernels force``; the production
config with grid_walk off, on the gap loop's training pair, and the
default config, on the fused Euler cell) through ``Trainer.train``, each
after one epoch of warm-up: the same report, the production arm's Chrome
trace to the same output directory.  Then row 5's and row 4's own split
(ops/csrc/gap_train.cu's backward at the forced production minibatch,
2,304 gaps at dt 0.01 and at dt 0.1), from a copy with %globaltimer
probes read by each block's first thread (a segment's walk end is the
latest of the block's warps): the count and sort phases, then each
segment's walk, the weight sums of the segment above it and the grid
barrier, the last segment's sums and the final chunk sum; median and
latest block, microseconds from the kernel's start.  Then row 3's and row
2's (the forward at the same minibatches), from a copy with the same
probes: the count, the sort (to the grid barrier before the walk), the
long rows on groups (the latest warp of a block to leave them), all rows
(the latest warp), and the time the walkers spend issuing their
checkpoint and output stores (summed over a block's warps).

    PYTHONPATH=. python scripts/profile_torch_training.py [--production | --scaled | --forced]
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from njode_tpu_torch import NeuralJumpODE  # noqa: E402
from njode_tpu_torch.ops import _build  # noqa: E402
from njode_tpu_torch.ops import train_kernel as tk  # noqa: E402
from njode_tpu_torch.utils import (Trainer, create_data_loaders,  # noqa: E402
                                   make_adam)

EPOCHS = 10
PHASES = ("staging: both networks' weights, the valid count",
          "phase A: forwards, to the barrier after them",
          "phase A: cotangents and backward, to the barrier after them",
          "phase A: the block's partial sums",
          "grid barrier after phase A",
          "phase B: the partials summed, Adam, the loss",
          "grid barrier ending the step")


def device_us(prof) -> float:
    """Device time summed over the device-side events (kernels, copies), us."""
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == cuda)


def trainer(dev: torch.device, use_kernel: bool) -> Trainer:
    model = NeuralJumpODE(1, 32, 1, num_moments=2, device=dev,
                          generator=torch.Generator().manual_seed(0))
    return Trainer(model, make_adam(model.parameters(), 1e-3, 5e-4),
                   ignore_first_continuity=True, moment_weights=[1.0, 10.0],
                   use_train_kernel=use_kernel)


def report(prof, name: str, card: str, wall_us: float, epochs: int) -> None:
    """Wall, device time and idle share per epoch, device launches per
    epoch (kernels and copies), and the top ops by device and host time."""
    dev_us = device_us(prof)
    cuda = torch.autograd.DeviceType.CUDA
    n_dev = sum(1 for e in prof.events() if e.device_type == cuda)
    print(f"Trainer.train, {name}, on {card}: wall {wall_us / epochs:.1f} "
          f"us/epoch (profiled), device {dev_us / epochs:.1f} us/epoch, "
          f"device idle {100.0 * (1.0 - dev_us / wall_us):.1f}%, "
          f"{n_dev / epochs:.1f} device launches per epoch", flush=True)
    sort = ("self_device_time_total" if hasattr(
        prof.key_averages()[0], "self_device_time_total")
        else "self_cuda_time_total")
    print(prof.key_averages().table(sort_by=sort, row_limit=10), flush=True)
    print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                    row_limit=10), flush=True)


def profile_production(dev: torch.device, card: str, out_dir: str) -> None:
    """The production recipe on the walk-train kernel, 5 epochs profiled
    after 2 of warm-up."""
    epochs = 5
    cfg = chip_smoke.production_config(epochs, "profiled")
    train_fn, val_fn = create_data_loaders(base_seed=2, device=dev,
                                           **cfg["data"])

    def walk_trainer() -> Trainer:
        model = chip_smoke.walk_model(dev, seed=0)
        return Trainer(model, make_adam(model.parameters(), 1e-3, 5e-4),
                       ignore_first_continuity=True,
                       moment_weights=list(chip_smoke.PROD_MW),
                       use_train_kernel=True)
    walk_trainer().train(train_fn, val_fn, n_epochs=2,
                         batch_size=chip_smoke.PROD_BS, print_every=100,
                         config=cfg)                           # warm-up
    tr = walk_trainer()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.train(train_fn, val_fn, n_epochs=epochs,
                 batch_size=chip_smoke.PROD_BS, print_every=5, config=cfg)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    report(prof, "production recipe, walk-train kernel", card, wall_us,
           epochs)
    prof.export_chrome_trace(os.path.join(out_dir,
                                          "trace_walk_train.json"))


def profile_scaled(dev: torch.device, card: str, out_dir: str) -> None:
    """The scaled recipe on the fused-step kernels and on the composed path,
    3 epochs each profiled after one of warm-up."""
    epochs = 3
    cfg = chip_smoke.scaled_config(epochs, "profiled")
    train_fn, val_fn = create_data_loaders(base_seed=2, device=dev,
                                           **cfg["data"])
    for name, up in (("fused-step kernels", "step"), ("composed", False)):
        model = chip_smoke.scaled_model(dev, up)
        tr = Trainer(model, make_adam(model.parameters(), 1e-3, 5e-4),
                     ignore_first_continuity=True,
                     moment_weights=list(chip_smoke.SCALED_MW),
                     use_train_kernel=False)
        tr.train(train_fn, val_fn, n_epochs=1,
                 batch_size=chip_smoke.SCALED_BS, print_every=100,
                 config=cfg)                                   # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.train(train_fn, val_fn, n_epochs=epochs,
                     batch_size=chip_smoke.SCALED_BS, print_every=5,
                     config=cfg)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        report(prof, f"scaled recipe, {name}", card, wall_us, epochs)
        if up == "step":
            prof.export_chrome_trace(os.path.join(out_dir,
                                                  "trace_fused_step.json"))


def profile_forced(dev: torch.device, card: str, out_dir: str) -> None:
    """The forced recipes (use_pallas True), 3 epochs each profiled after
    one of warm-up."""
    epochs = 3
    for name, cfg, kw, mw, bs in (
            ("forced production recipe, gap-loop kernels",
             chip_smoke.forced_production_config(epochs, "profiled"),
             chip_smoke.PROD_MODEL_KW, chip_smoke.PROD_MW,
             chip_smoke.PROD_BS),
            ("forced default recipe, fused Euler cell",
             chip_smoke.forced_default_config(epochs, "profiled"),
             chip_smoke.DEFAULT_MODEL_KW, (1.0, 10.0), chip_smoke.TRAIN_BS)):
        train_fn, val_fn = create_data_loaders(base_seed=2, device=dev,
                                               **cfg["data"])
        model = NeuralJumpODE(use_pallas=True, device=dev,
                              generator=torch.Generator().manual_seed(0),
                              **kw)
        tr = Trainer(model, make_adam(model.parameters(), 1e-3, 5e-4),
                     ignore_first_continuity=True, moment_weights=list(mw),
                     use_train_kernel=False)
        tr.train(train_fn, val_fn, n_epochs=1, batch_size=bs,
                 print_every=100, config=cfg)                  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.train(train_fn, val_fn, n_epochs=epochs, batch_size=bs,
                     print_every=100, config=cfg)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        report(prof, name, card, wall_us, epochs)
        if "production" in name:
            prof.export_chrome_trace(os.path.join(out_dir,
                                                  "trace_forced.json"))


def instrumented_gap_bwd_source() -> str:
    """ops/csrc/gap_train.cu with %globaltimer probes read by each block's
    thread 0 (a segment's walk end: the latest lane 0 of the block's warps)
    at fixed places; fails if an anchor is gone."""
    src = (_build.CSRC / "gap_train.cu").read_text()
    edits = [
        ("namespace {\n",
         "namespace {\n"
         "__device__ unsigned long long g_probe[2048 * 64];\n"
         "__device__ __forceinline__ unsigned long long gtime() {\n"
         "  unsigned long long t;\n"
         "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
         "  return t;\n}\n"
         "#define PROBE(i) do { if (tid == 0) g_probe[blk * 64 + (i)] = gtime(); } while (0)\n"
         "#define PROBE_MAX(i) do { if (lane == 0) atomicMax(&g_probe[blk * 64 + (i)], gtime()); } while (0)\n"),
        ("  // ---- count: outputs initialised",
         "  PROBE(0);\n  // ---- count: outputs initialised"),
        ("  grid.sync();\n\n  // ---- the walkers",
         "  grid.sync();\n  PROBE(1);\n\n  // ---- the walkers"),
        ("    for (int p = n_long + w_id; p < na; p += w_n) walk(p, s, n_c, rbuf, false);\n"
         "    if (s < s_top) sums(s + 1);\n    grid.sync();",
         "    for (int p = n_long + w_id; p < na; p += w_n) walk(p, s, n_c, rbuf, false);\n"
         "    PROBE_MAX(2 + 3 * (s_top - s));\n    if (s < s_top) sums(s + 1);\n"
         "    PROBE(3 + 3 * (s_top - s));\n    grid.sync();\n"
         "    PROBE(4 + 3 * (s_top - s));"),
        ("    sums(0);\n    grid.sync();\n  }",
         "    sums(0);\n    PROBE(60);\n    grid.sync();\n  }"),
        ("    a.dw[e] = sum;\n  }\n}",
         "    a.dw[e] = sum;\n  }\n  __syncthreads();\n  PROBE(61);\n"
         "  if (tid == 0) g_probe[blk * 64 + 63] = s_top + 1;\n}"),
    ]
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"gap_train.cu has no unique anchor {old!r}")
        src = src.replace(old, new)
    return src + (
        "\nextern \"C\" int njode_prof_read(unsigned long long* out) {\n"
        "  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));\n}\n")


def gap_bwd_split(dev: torch.device, card: str) -> None:
    """Rows 5 and 4 (gap_train.cu's backward) by phase, one call each at
    the forced production minibatch, from the instrumented copy."""
    from njode_tpu_torch.ops import gap_scan
    from njode_tpu_torch.simulation import simulate_batch
    with tempfile.TemporaryDirectory() as tmp:
        cu = os.path.join(tmp, "gap_train_probes.cu")
        so = os.path.join(tmp, "libgap_train_probes.so")
        with open(cu, "w") as f:
            f.write(instrumented_gap_bwd_source())
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS,
                        f"-I{_build.CSRC}", "-o", so, cu], check=True,
                       capture_output=True, text=True)
        lib = ctypes.CDLL(so)
        shipped = gap_scan._load_train_kernel()
        for name in ("njode_gap_train_fwd", "njode_gap_train_fwd_grid",
                     "njode_gap_train_bwd_grid", "njode_gap_train_bwd"):
            fn, ref = getattr(lib, name), getattr(shipped, name)
            fn.argtypes, fn.restype = ref.argtypes, ref.restype
        lib.njode_cuda_error_string.argtypes = [ctypes.c_int]
        lib.njode_cuda_error_string.restype = ctypes.c_char_p
        gen = torch.Generator(device=dev).manual_seed(33)
        b = simulate_batch(chip_smoke.PROD_BS, "black_scholes", 0.1, True,
                           generator=gen, device=dev, mu=0.1, sigma=0.5,
                           x0=1.0)
        model = NeuralJumpODE(use_pallas=True, device=dev,
                              generator=torch.Generator().manual_seed(0),
                              **chip_smoke.PROD_MODEL_KW)
        ct = torch.randn(1, chip_smoke.PROD_BS * (chip_smoke.PROD_N - 1),
                         chip_smoke.PROD_H, device=dev)
        original = gap_scan._load_train_kernel
        gap_scan._load_train_kernel = lambda: lib
        gap_scan._bwd_launch.cache_clear()
        try:
            for row, dt, n_sub in ((5, chip_smoke.PROD_DT, chip_smoke.PROD_M),
                                   (4, 0.1, 10)):
                stride = gap_scan.residual_stride(n_sub)
                args = chip_smoke.forced_rows(model, b.times, b.values, dt)
                tail = (dt, n_sub, stride, "relu", "identity")
                with torch.no_grad():
                    res = gap_scan._launch_train_fwd(*args, *tail)
                    bwd = (ct, args[1], args[3], *args[4:], res[2], res[3],
                           *tail)
                    gap_scan._launch_train_bwd(*bwd)                # warm-up
                    gap_scan._launch_train_bwd(*bwd)
                    torch.cuda.synchronize()
                probes = (ctypes.c_ulonglong * (2048 * 64))()
                lib.njode_prof_read(probes)
                plan, _ = gap_scan._bwd_launch(0, chip_smoke.PROD_H,
                                               args[0].shape[1], n_sub,
                                               stride, 1)
                per = [[probes[blk * 64 + i] for i in range(64)]
                       for blk in range(plan.blocks)]
                t0 = min(p[0] for p in per)
                top = per[0][63] - 1

                def at(i):
                    v = sorted(p[i] - t0 for p in per)
                    return f"{v[len(v) // 2] / 1e3:.1f}/{v[-1] / 1e3:.1f}"
                names = [(1, "count and sort")]
                for s_ in range(top, -1, -1):
                    j = 3 * (top - s_)
                    names += [(2 + j, f"segment {s_} walked"),
                              (3 + j, f"segment {s_ + 1}'s sums"),
                              (4 + j, "grid barrier")]
                names += [(60, "segment 0's sums"), (61, "chunk sum")]
                print(f"row {row} split on {card} (2,304 gaps, d_h "
                      f"{chip_smoke.PROD_H}, dt {dt}, n_sub {n_sub}, stride "
                      f"{stride}; plan {tuple(plan)[:9]}), microseconds from "
                      f"the kernel's start to each phase's end, median / "
                      f"latest block: " + "; ".join(
                          f"{nm} {at(i)}" for i, nm in names), flush=True)
        finally:
            gap_scan._load_train_kernel = original
            gap_scan._bwd_launch.cache_clear()


def instrumented_gap_fwd_source() -> str:
    """ops/csrc/gap_train.cu with %globaltimer probes in the forward's
    cooperative schedule, read by each block's thread 0 (a phase's end over
    the warps: the latest lane 0), and each put's issue time summed by lane
    0 of each writing warp; fails if an anchor is gone."""
    src = (_build.CSRC / "gap_train.cu").read_text()
    edits = [
        ("namespace {\n",
         "namespace {\n"
         "__device__ unsigned long long g_fprobe[2048 * 16];\n"
         "__device__ __forceinline__ unsigned long long ftime() {\n"
         "  unsigned long long t;\n"
         "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
         "  return t;\n}\n"
         "#define FPROBE(i) do { if (tid == 0) g_fprobe[blk * 16 + (i)] = ftime(); } while (0)\n"
         "#define FPROBE_MAX(i) do { if (lane == 0) atomicMax(&g_fprobe[blk * 16 + (i)], ftime()); } while (0)\n"),
        ("  count_rows(a.t0, a.ttgt, dt, a.n_sub, R, a.nbins, cnt, ghist, s_key, key_of);\n",
         "  FPROBE(0);\n"
         "  count_rows(a.t0, a.ttgt, dt, a.n_sub, R, a.nbins, cnt, ghist, s_key, key_of);\n"
         "  FPROBE(1);\n"),
        ("  // the long rows on groups, from the network's first counter, then every\n",
         "  FPROBE(2);\n"
         "  // the long rows on groups, from the network's first counter, then every\n"),
        ("    walk(__ldcg(order + p), __ldcg(cs + p), true);\n  }\n",
         "    walk(__ldcg(order + p), __ldcg(cs + p), true);\n  }\n  FPROBE_MAX(3);\n"),
        ("    walk(__ldcg(order + p), __ldcg(cs + p), false);\n  }\n}\n",
         "    walk(__ldcg(order + p), __ldcg(cs + p), false);\n  }\n  FPROBE_MAX(4);\n}\n"),
        ("    auto put = [&](float* dst_h, float* dst_t) {\n      if (!writer) return;\n",
         "    auto put = [&](float* dst_h, float* dst_t) {\n      if (!writer) return;\n"
         "      const unsigned long long t_put = ftime();\n"),
        ("      if (kb == 0 && lane == 0) *dst_t = t;\n    };\n",
         "      if (kb == 0 && lane == 0) *dst_t = t;\n"
         "      if (lane == 0) atomicAdd(&g_fprobe[blk * 16 + 5], ftime() - t_put);\n    };\n"),
    ]
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"gap_train.cu has no unique anchor {old!r}")
        src = src.replace(old, new)
    return src + (
        "\nextern \"C\" int njode_fprof_reset() {\n"
        "  static unsigned long long zero[2048 * 16];\n"
        "  return (int)cudaMemcpyToSymbol(g_fprobe, zero, sizeof(zero));\n}\n"
        "extern \"C\" int njode_fprof_read(unsigned long long* out) {\n"
        "  return (int)cudaMemcpyFromSymbol(out, g_fprobe, sizeof(g_fprobe));\n}\n")


def gap_fwd_split(dev: torch.device, card: str) -> None:
    """Rows 3 and 2 (gap_train.cu's forward) by phase, one call each at the
    forced production minibatch, from the instrumented copy."""
    from njode_tpu_torch.ops import gap_scan
    from njode_tpu_torch.simulation import simulate_batch
    with tempfile.TemporaryDirectory() as tmp:
        cu = os.path.join(tmp, "gap_fwd_probes.cu")
        so = os.path.join(tmp, "libgap_fwd_probes.so")
        with open(cu, "w") as f:
            f.write(instrumented_gap_fwd_source())
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS,
                        f"-I{_build.CSRC}", "-o", so, cu], check=True,
                       capture_output=True, text=True)
        lib = ctypes.CDLL(so)
        shipped = gap_scan._load_train_kernel()
        for name in ("njode_gap_train_fwd", "njode_gap_train_fwd_grid",
                     "njode_gap_train_bwd_grid", "njode_gap_train_bwd"):
            fn, ref = getattr(lib, name), getattr(shipped, name)
            fn.argtypes, fn.restype = ref.argtypes, ref.restype
        lib.njode_cuda_error_string.argtypes = [ctypes.c_int]
        lib.njode_cuda_error_string.restype = ctypes.c_char_p
        gen = torch.Generator(device=dev).manual_seed(33)
        b = simulate_batch(chip_smoke.PROD_BS, "black_scholes", 0.1, True,
                           generator=gen, device=dev, mu=0.1, sigma=0.5,
                           x0=1.0)
        model = NeuralJumpODE(use_pallas=True, device=dev,
                              generator=torch.Generator().manual_seed(0),
                              **chip_smoke.PROD_MODEL_KW)
        original = gap_scan._load_train_kernel
        gap_scan._load_train_kernel = lambda: lib
        gap_scan._fwd_blocks.cache_clear()
        try:
            for row, dt, n_sub in ((3, chip_smoke.PROD_DT, chip_smoke.PROD_M),
                                   (2, 0.1, 10)):
                stride = gap_scan.residual_stride(n_sub)
                args = chip_smoke.forced_rows(model, b.times, b.values, dt)
                tail = (dt, n_sub, stride, "relu", "identity")
                with torch.no_grad():
                    gap_scan._launch_train_fwd(*args, *tail)      # warm-up
                    torch.cuda.synchronize()
                    lib.njode_fprof_reset()
                    gap_scan._launch_train_fwd(*args, *tail)
                    torch.cuda.synchronize()
                probes = (ctypes.c_ulonglong * (2048 * 16))()
                lib.njode_fprof_read(probes)
                blocks = gap_scan._fwd_blocks(0, chip_smoke.PROD_H)
                per = [[probes[blk * 16 + i] for i in range(16)]
                       for blk in range(blocks)]
                t0 = min(p[0] for p in per)

                def at(i):
                    v = sorted(p[i] - t0 for p in per)
                    return f"{v[len(v) // 2] / 1e3:.1f}/{v[-1] / 1e3:.1f}"
                stores = sorted(p[5] for p in per)
                print(f"row {row} split on {card} (2,304 gaps, d_h "
                      f"{chip_smoke.PROD_H}, dt {dt}, n_sub {n_sub}, stride "
                      f"{stride}; {blocks} blocks), microseconds from the "
                      f"kernel's start to each phase's end, median / latest "
                      f"block: count {at(1)}; sort {at(2)}; long rows on "
                      f"groups {at(3)}; all rows {at(4)}; the walkers' "
                      f"store issue, summed over a block's warps, median / "
                      f"largest block {stores[len(stores) // 2] / 1e3:.1f}/"
                      f"{stores[-1] / 1e3:.1f}", flush=True)
        finally:
            gap_scan._load_train_kernel = original
            gap_scan._fwd_blocks.cache_clear()


STEP_PHASES = ("products (to the barrier after them)",
               "epilogues (store, activation, records, barrier)",
               "weight-gradient sums (bf16: outer_sum; f32: step_dw_kernel, "
               "its own blocks)", "the rest")


def _probe_edits(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"fused_step source has no unique anchor {old!r}")
        src = src.replace(old, new)
    return src


def instrumented_step_sources() -> tuple[str, str]:
    """(ops/csrc/fused_step.cu, ops/csrc/step_f32.cuh) with cycle counters
    read by each block's thread 0: the products and epilogues of every
    product (mm_store, mm_chunk), the bf16 outer_sum, the f32 dW kernel,
    and each step kernel whole; fails if an anchor is gone."""
    add = "if (threadIdx.x == 0) atomicAdd(&g_prof[{k}], " \
          "(unsigned long long)(clock64() - {t}));"
    cu = _probe_edits((_build.CSRC / "fused_step.cu").read_text(), [
        ("  constexpr int MT = RPW / 2;\n  float acc[MT][C][4];\n"
         "  tile_mm_tc<C, MT>(njode_step_smem + a_off, W, H, HS, warp, lane, acc);\n"
         "  __syncthreads();\n",
         "  const long long t0 = clock64();\n"
         "  constexpr int MT = RPW / 2;\n  float acc[MT][C][4];\n"
         "  tile_mm_tc<C, MT>(njode_step_smem + a_off, W, H, HS, warp, lane, acc);\n"
         "  __syncthreads();\n  " + add.format(k=0, t="t0")
         + "\n  const long long t1 = clock64();\n"),
        ("  if (e.act >= 0) tile_act_tc<C, MT>(out, H, HS, warp, lane, e.act);\n"
         "  __syncthreads();\n}",
         "  if (e.act >= 0) tile_act_tc<C, MT>(out, H, HS, warp, lane, e.act);\n"
         "  __syncthreads();\n  " + add.format(k=1, t="t1") + "\n}"),
        ("  outer_sum_tc<C, RPW>(njode_step_smem + a_off, njode_step_smem + g_off, "
         "H, HS, P, first);\n}",
         "  const long long t0 = clock64();\n"
         "  outer_sum_tc<C, RPW>(njode_step_smem + a_off, njode_step_smem + g_off, "
         "H, HS, P, first);\n  " + add.format(k=2, t="t0") + "\n}"),
        ("                float* __restrict__ Y, int B, int N, int H, Layout lo, "
         "int act, int scale) {\n",
         "                float* __restrict__ Y, int B, int N, int H, Layout lo, "
         "int act, int scale) {\n  const long long tK = clock64();\n"),
        ("    readout(o_wk, N + s);\n  }\n}",
         "    readout(o_wk, N + s);\n  }\n  " + add.format(k=3, t="tK") + "\n}"),
        ("                float* __restrict__ partial, int B, int N, int H, "
         "Layout lo, int act,\n                int scale) {\n",
         "                float* __restrict__ partial, int B, int N, int H, "
         "Layout lo, int act,\n                int scale) {\n"
         "  const long long tK = clock64();\n"),
        ("pv(lo.row_ob)[e] = 0.0f;\n  }\n}",
         "pv(lo.row_ob)[e] = 0.0f;\n  }\n  " + add.format(k=3, t="tK")
         + "\n}"),
    ])
    cuh = _probe_edits((_build.CSRC / "step_f32.cuh").read_text(), [
        ("extern __shared__ float njode_step_smem[];\n",
         "extern __shared__ float njode_step_smem[];\n"
         "__device__ unsigned long long g_prof[4];\n"
         "extern \"C\" int njode_prof_read(unsigned long long* out) {\n"
         "  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n"
         "}\n"),
        ("  float* stage = njode_step_smem + kHead;\n"
         "  const float* A = U + p.a_row + r0 + rg * TM;\n",
         "  float* stage = njode_step_smem + kHead;\n"
         "  const float* A = U + p.a_row + r0 + rg * TM;\n"
         "  const long long t0 = clock64();\n"),
        ("  __syncthreads();  // every operand read: out may overwrite them\n",
         "  __syncthreads();  // every operand read: out may overwrite them\n  "
         + add.format(k=0, t="t0") + "\n  const long long t1 = clock64();\n"),
        ("      default: finish([](float v) { return v; });\n    }\n  }\n"
         "  __syncthreads();\n}",
         "      default: finish([](float v) { return v; });\n    }\n  }\n"
         "  __syncthreads();\n  " + add.format(k=1, t="t1") + "\n}"),
        ("            int SG) {\n  if (threadIdx.x == 0) {\n",
         "            int SG) {\n  const long long tK = clock64();\n"
         "  if (threadIdx.x == 0) {\n"),
        ("    jump_bwd(s0);\n  }\n}",
         "    jump_bwd(s0);\n  }\n  " + add.format(k=3, t="tK") + "\n}"),
        ("               Layout lo, int RT) {\n",
         "               Layout lo, int RT) {\n  const long long tD = clock64();\n"),
        ("      if (j < H) P[(size_t)a * H + j] = acc[i][q];\n    }\n  }\n}",
         "      if (j < H) P[(size_t)a * H + j] = acc[i][q];\n    }\n  }\n  "
         + add.format(k=2, t="tD") + "\n}"),
    ])
    return cu, cuh


def step_kernel_times(run, n: int = 10) -> str:
    """Device time a call of each CUDA kernel ``run`` launches
    (torch.profiler over n calls), by kernel name."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    by = {}
    for e in prof.events():
        if e.device_type == cuda:
            name = e.name.split("(")[0].split("<")[0].split("::")[-1]
            by[name] = by.get(name, 0.0) + e.time_range.elapsed_us()
    return ", ".join(f"{k} {v / n / 1e3:.4f} ms" for k, v in by.items())


def fused_step_split(dev: torch.device, card: str) -> None:
    """Rows 9-10 and 9b-10b at the scaled recipe's shape (two networks, H
    256, N 2, 4,096 rows), one call each of an instrumented copy: the cycles
    of each block's thread 0 in each phase, summed over blocks (the f32 dW
    kernel's blocks apart: they run after the backward's), and the device
    time of each kernel a call launches (torch.profiler, the shipped
    build)."""
    from njode_tpu_torch.ops import fused_step as fs
    c = chip_smoke.step_case(torch.Generator().manual_seed(17),
                             chip_smoke.SCALED_H, 2, False, 1, "relu",
                             "identity", chip_smoke.SCALED_BS, dev)
    cases = (("forward (row 9)", False, None), ("backward (row 10)", True, None),
             ("bf16 forward (row 9b)", False, chip_smoke.BF16),
             ("bf16 backward (row 10b)", True, chip_smoke.BF16))
    for name, bwd, cdt in cases:
        run = chip_smoke.step_bwd if bwd else chip_smoke.step_fwd
        with torch.no_grad():
            run(c, "relu", "identity", True, cdt)
            print(f"fused-step {name} device time a call on {card}: "
                  + step_kernel_times(lambda: run(c, "relu", "identity", True,
                                                  cdt)), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        cu = os.path.join(tmp, "fused_step_probes.cu")
        so = os.path.join(tmp, "libfused_step_probes.so")
        src, hdr = instrumented_step_sources()
        with open(cu, "w") as f:
            f.write(src)
        with open(os.path.join(tmp, "step_f32.cuh"), "w") as f:
            f.write(hdr)
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS,
                        f"-I{_build.CSRC}", "-o", so, cu], check=True,
                       capture_output=True, text=True)
        lib = ctypes.CDLL(so)
        shipped = fs._load_kernel()
        for fn_name in ("njode_step_fwd", "njode_step_bwd",
                        "njode_step_scratch_floats"):
            fn, ref = getattr(lib, fn_name), getattr(shipped, fn_name)
            fn.argtypes, fn.restype = ref.argtypes, ref.restype
        lib.njode_cuda_error_string.argtypes = [ctypes.c_int]
        lib.njode_cuda_error_string.restype = ctypes.c_char_p
        original = fs._load_kernel
        fs._load_kernel = lambda: lib
        try:
            for name, bwd, cdt in cases:
                run = chip_smoke.step_bwd if bwd else chip_smoke.step_fwd
                with torch.no_grad():
                    run(c, "relu", "identity", True, cdt)        # warm-up
                    torch.cuda.synchronize()
                    cycles = (ctypes.c_ulonglong * 4)()
                    lib.njode_prof_read(cycles)
                    before = list(cycles)
                    run(c, "relu", "identity", True, cdt)
                    torch.cuda.synchronize()
                    lib.njode_prof_read(cycles)
                per = [cycles[k] - before[k] for k in range(4)]
                # the kernel's own: in the f32 backward the dW kernel's
                # blocks are not inside it
                per[3] -= per[0] + per[1] + (per[2] if cdt is not None else 0)
                total = per[0] + per[1] + per[3] + (per[2] if cdt is not None else 0)
                print(f"fused-step {name} phase split on {card} (two "
                      f"networks, H {chip_smoke.SCALED_H}, N 2, "
                      f"{chip_smoke.SCALED_BS} rows, plan "
                      f"{chip_smoke.step_plan(c, cdt)}), cycles of each block's "
                      f"thread 0 summed over blocks (shares of the step "
                      f"kernel's):", flush=True)
                for k, phase in enumerate(STEP_PHASES):
                    if k == 2 and not bwd:
                        continue
                    print(f"  {phase}: {per[k]} ({100.0 * per[k] / total:.1f}%)",
                          flush=True)
        finally:
            fs._load_kernel = original


WALK_PHASES = ("weights to shared memory, valid count", "jump forward",
               "forward walk", "readouts + loss + readout backward",
               "backward walk", "jump backward", "grid barrier after the walk",
               "gradient sums + Adam (phase B)", "grid barrier ending the step")
N_PROBES = 16


def instrumented_walk_source() -> str:
    """ops/csrc/walk_train.cu with cycle counters read by each block's
    thread 0 at fixed places; fails if an anchor is gone."""
    src = (_build.CSRC / "walk_train.cu").read_text()
    prof = ("do { if (tid == 0) atomicAdd(&g_prof[blk * 16 + (K_)], "
            "(unsigned long long)(clock64() - tP)); tP = clock64(); } "
            "while (0)")
    edits = [
        ("namespace cg = cooperative_groups;",
         "namespace cg = cooperative_groups;\n"
         "__device__ unsigned long long g_prof[1024 * 16];\n"
         "extern \"C\" int njode_prof_read(unsigned long long* out) {\n"
         "  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n"
         "}\n"
         f"#define PROFW(K_) {prof}"),
        ("    c1 *= hp.b1;\n", "    long long tP = clock64();\n    c1 *= hp.b1;\n"),
        ("      // ---- 1. jump forward", "      PROFW(0);\n      // ---- 1."),
        ("      // ---- 2. forward walk", "      PROFW(1);\n      // ---- 2."),
        ("      // ---- 3. readouts", "      PROFW(2);\n      // ---- 3."),
        ("      // ---- 6. backward walk", "      PROFW(3);\n      // ---- 6."),
        ("      if (last) {\n        if (!d.four) {",
         "      PROFW(4);\n      if (last) {\n        if (!d.four) {"),
        ("      grid.sync();\n\n      // ---- phase B",
         "      PROFW(5);\n      grid.sync();\n      PROFW(6);\n\n"
         "      // ---- phase B"),
        ("      if (last && blk == 0 && tid == 0) {",
         "      PROFW(7);\n      if (last && blk == 0 && tid == 0) {"),
        ("      grid.sync();\n    }\n  }\n",
         "      grid.sync();\n      PROFW(8);\n    }\n  }\n"),
    ]
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"walk_train.cu has no unique anchor {old!r}")
        src = src.replace(old, new)
    return src


def walk_kernel_split(dev: torch.device, card: str) -> None:
    from njode_tpu_torch.ops import walk_train as wt
    with tempfile.TemporaryDirectory() as tmp:
        cu = os.path.join(tmp, "walk_train_probes.cu")
        so = os.path.join(tmp, "libwalk_train_probes.so")
        with open(cu, "w") as f:
            f.write(instrumented_walk_source())
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS,
                        f"-I{_build.CSRC}", "-o", so, cu], check=True,
                       capture_output=True, text=True)
        lib = ctypes.CDLL(so)
        shipped = wt._load_kernel()
        for name in ("njode_walk_train_run", "njode_walk_train_scratch_floats"):
            fn, ref = getattr(lib, name), getattr(shipped, name)
            fn.argtypes, fn.restype = ref.argtypes, ref.restype
        lib.njode_cuda_error_string.argtypes = [ctypes.c_int]
        lib.njode_cuda_error_string.restype = ctypes.c_char_p
        bs, n = chip_smoke.PROD_BS, chip_smoke.PROD_TRAIN
        rows = -(-n // bs) * bs
        data = chip_smoke.train_data(dev, rows, bs, 3, n_valid=n)
        state = wt.init_walk_state(chip_smoke.walk_model(dev, seed=0))
        kw = chip_smoke.walk_train_kwargs(2, "direct", "euler", bs)
        original = wt._load_kernel
        wt._load_kernel = lambda: lib
        try:
            with torch.no_grad():
                wt.fused_walk_train_run(state, data, **kw)       # warm-up
                torch.cuda.synchronize()
                cycles = (ctypes.c_ulonglong * (1024 * N_PROBES))()
                lib.njode_prof_read(cycles)
                before = list(cycles)
                wt.fused_walk_train_run(state, data, **kw)
                torch.cuda.synchronize()
                lib.njode_prof_read(cycles)
        finally:
            wt._load_kernel = original
        plan = wt.launch_plan(chip_smoke.PROD_H, bs, chip_smoke.PROD_N,
                              "euler", chip_smoke.PROD_M)
        nblk = plan.blocks
        per = [[cycles[b * N_PROBES + k] - before[b * N_PROBES + k]
                for b in range(nblk)] for k in range(len(WALK_PHASES))]
        total = sum(sum(p) / nblk for p in per)
        print(f"walk-train kernel phase split on {card} (one epoch call: "
              f"{rows // bs} steps of {bs}, H={chip_smoke.PROD_H}, "
              f"N={chip_smoke.PROD_N}, M={chip_smoke.PROD_M}; plan "
              f"{tuple(plan)}), cycles of each block's thread 0, mean over "
              f"blocks, share of the call:", flush=True)
        for k, name in enumerate(WALK_PHASES):
            mean = sum(per[k]) / nblk
            print(f"  {name}: {mean:.0f} cycles ({100.0 * mean / total:.1f}%)"
                  f", blocks {min(per[k])}-{max(per[k])}", flush=True)
        print(f"  whole call: {total:.0f} cycles", flush=True)


def profile_trainer(dev: torch.device, card: str, out_dir: str) -> None:
    cfg = chip_smoke.default_config(EPOCHS, "profiled")
    for name, use_kernel in (("kernel", True), ("composed", False)):
        train_fn, val_fn = create_data_loaders(base_seed=2, device=dev,
                                               **cfg["data"])
        trainer(dev, use_kernel).train(train_fn, val_fn, n_epochs=2,
                                       batch_size=128, print_every=100,
                                       config=cfg)            # warm-up
        tr = trainer(dev, use_kernel)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.train(train_fn, val_fn, n_epochs=EPOCHS, batch_size=128,
                     print_every=5, config=cfg)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        report(prof, f"{name} path", card, wall_us, EPOCHS)
        if use_kernel:   # the composed path's trace runs to tens of MB
            prof.export_chrome_trace(os.path.join(out_dir,
                                                  "trace_train_kernel.json"))


def instrumented_source() -> str:
    """ops/csrc/train_run.cu with cycle counters read by each block's
    thread 0 at fixed places; fails if an anchor is gone."""
    src = (_build.CSRC / "train_run.cu").read_text()
    prof = ("do { if (tid == 0) atomicAdd(&g_prof[blk * 16 + (K_)], "
            "(unsigned long long)(clock64() - tP)); tP = clock64(); } "
            "while (0)")
    barrier = ("__syncthreads();  // net 0's predictions to net 1's "
               "cotangents")
    sums = "// the chunk's sums into the block's partial"
    reduce = ("reduce_chunk<CPT>(slots, slot_f, nc, c0 == lo, d, part, warp, "
              "nw, lane);")
    edits = [
        ("namespace cg = cooperative_groups;",
         "namespace cg = cooperative_groups;\n"
         "__device__ unsigned long long g_prof[128 * 16];\n"
         "extern \"C\" int njode_prof_read(unsigned long long* out) {\n"
         "  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n"
         "}\n"
         f"#define PROFW(K_) {prof}"),
        ("    c1 *= hp.b1;  // this step's bias-correction powers\n",
         "    long long tP = clock64();\n"
         "    c1 *= hp.b1;  // this step's bias-correction powers\n"),
        ("    // ---- phase A: the block's share",
         "    PROFW(0);\n    // ---- phase A: the block's share"),
        (f"      {barrier}\n", f"      {barrier}\n      PROFW(1);\n"),
        (f"      {sums}\n", f"      PROFW(2);\n      {sums}\n"),
        (f"      {reduce}\n", f"      {reduce}\n      PROFW(3);\n"),
        ("    grid.sync();\n\n    // ---- phase B",
         "    grid.sync();\n    PROFW(4);\n\n    // ---- phase B"),
        ("    grid.sync();\n  }\n  if (blk == 0 && tid == 0) {",
         "    PROFW(5);\n    grid.sync();\n    PROFW(6);\n  }\n"
         "  if (blk == 0 && tid == 0) {"),
    ]
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"train_run.cu has no unique anchor {old!r}")
        src = src.replace(old, new)
    return src


def kernel_split(dev: torch.device, card: str) -> None:
    """The training kernel at the default shape (one epoch call: 8 steps of
    128, K 2, H 32, N 10), one call of an instrumented copy: the cycles of
    each block's thread 0 in each phase."""
    with tempfile.TemporaryDirectory() as tmp:
        cu = os.path.join(tmp, "train_run_probes.cu")
        so = os.path.join(tmp, "libtrain_run_probes.so")
        with open(cu, "w") as f:
            f.write(instrumented_source())
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS,
                        f"-I{_build.CSRC}", "-o", so, cu], check=True,
                       capture_output=True, text=True)
        lib = ctypes.CDLL(so)
        _, shipped_fn = tk._load_kernel()
        fn = lib.njode_train_run
        fn.argtypes, fn.restype = shipped_fn.argtypes, shipped_fn.restype
        lib.njode_cuda_error_string.argtypes = [ctypes.c_int]
        lib.njode_cuda_error_string.restype = ctypes.c_char_p
        model = NeuralJumpODE(1, 32, 1, num_moments=2, device=dev,
                              generator=torch.Generator().manual_seed(0))
        data = chip_smoke.train_data(dev, 1024, 128, 3, n_valid=1000)
        state = tk.init_train_state(model)
        kw = chip_smoke.train_kwargs(2)
        shipped = tk._load_kernel
        tk._load_kernel = lambda: (lib, fn)
        try:
            with torch.no_grad():
                tk.fused_train_run(state, data, **kw)          # warm-up
                torch.cuda.synchronize()
                cycles = (ctypes.c_ulonglong * (128 * 16))()
                lib.njode_prof_read(cycles)
                before = list(cycles)
                tk.fused_train_run(state, data, **kw)
                torch.cuda.synchronize()
                lib.njode_prof_read(cycles)
        finally:
            tk._load_kernel = shipped
        plan = tk.launch_plan(32, chip_smoke.TRAIN_N, 128)
        nblk = plan.blocks
        per = [[cycles[b * 16 + k] - before[b * 16 + k] for b in range(nblk)]
               for k in range(len(PHASES))]
        total = sum(sum(p) / nblk for p in per)
        print(f"training kernel phase split on {card} (one epoch call: 8 "
              f"steps of 128, K=2, H=32, N={chip_smoke.TRAIN_N}; plan "
              f"{tuple(plan)}), cycles of each block's thread 0, mean over "
              f"blocks, share of the call:", flush=True)
        for k, name in enumerate(PHASES):
            mean = sum(per[k]) / nblk
            print(f"  {name}: {mean:.0f} cycles ({100.0 * mean / total:.1f}%)"
                  f", blocks {min(per[k])}-{max(per[k])}", flush=True)
        print(f"  whole call: {total:.0f} cycles, "
              f"{total / 8:.0f} a step", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_training: no CUDA device")
    dev, card = chip_smoke.device_phase()
    out_dir = "chiprun_out"
    os.makedirs(out_dir, exist_ok=True)
    if "--production" in sys.argv[1:]:
        profile_production(dev, card, out_dir)
        walk_kernel_split(dev, card)
        return
    if "--scaled" in sys.argv[1:]:
        profile_scaled(dev, card, out_dir)
        fused_step_split(dev, card)
        return
    if "--forced" in sys.argv[1:]:
        profile_forced(dev, card, out_dir)
        gap_bwd_split(dev, card)
        gap_fwd_split(dev, card)
        return
    profile_trainer(dev, card, out_dir)
    kernel_split(dev, card)


if __name__ == "__main__":
    main()
