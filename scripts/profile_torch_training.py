"""Where the time of the PyTorch port's default training run goes, on one
CUDA card.

1. torch.profiler over 10 epochs of the default Black-Scholes recipe
   (hidden 32, two separate moment networks, batch 128, 1,000 fresh obs-only
   trajectories per epoch, validation on 200) through ``Trainer.train``,
   once with the whole-run kernel and once on the composed path: host wall
   per epoch, device time per epoch, the device's idle share, and the ops
   that take the most device and host time.  The kernel path's Chrome trace
   goes to chiprun_out/.
2. The kernel's own split: a copy of ops/csrc/train_run.cu with clock64()
   probes inserted at fixed places (after the forward, after the cotangents
   and backward, around the block barriers, the gradient reduction and
   Adam) is built with nvcc into a temporary directory and run for one
   8-step epoch at the default shape; it prints the cycles each warp spent
   in each phase.  The probes cost a few percent; the shipped kernel has
   none.

    PYTHONPATH=. python scripts/profile_torch_training.py
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
PHASES = ("forward", "cotangents+backward", "wait before reduce", "reduce",
          "wait after reduce", "Adam + pass barrier")


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
        dev_us = device_us(prof)
        print(f"Trainer.train, {name} path, on {card}: wall "
              f"{wall_us / EPOCHS:.1f} us/epoch (profiled), device "
              f"{dev_us / EPOCHS:.1f} us/epoch, device idle "
              f"{100.0 * (1.0 - dev_us / wall_us):.1f}%", flush=True)
        sort = ("self_device_time_total" if hasattr(
            prof.key_averages()[0], "self_device_time_total")
            else "self_cuda_time_total")
        print(prof.key_averages().table(sort_by=sort, row_limit=10),
              flush=True)
        print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                        row_limit=10), flush=True)
        if use_kernel:   # the composed path's trace runs to tens of MB
            prof.export_chrome_trace(os.path.join(out_dir,
                                                  "trace_train_kernel.json"))


def instrumented_source() -> str:
    """ops/csrc/train_run.cu with per-warp cycle counters at fixed places;
    fails if the source no longer has the places it anchors to."""
    src = (_build.CSRC / "train_run.cu").read_text()
    edits = [
        ("namespace {\n\nconstexpr int kWarp = 32;",
         "__device__ unsigned long long g_prof[16 * 8];\n"
         "extern \"C\" int njode_prof_read(unsigned long long* out) {\n"
         "  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n"
         "}\n"
         "namespace {\n"
         "#define PROF(k, t0) if (lane == 0) atomicAdd(&g_prof[warp * 8 + (k)],"
         " (unsigned long long)(clock64() - (t0)))\n\n"
         "constexpr int kWarp = 32;"),
        ("        const int b = b0 + warp;\n        if (b < BS) {",
         "        const int b = b0 + warp;\n        long long tA = clock64();\n"
         "        if (b < BS) {"),
        ("          forward<CPT>(mine, net, d, lane);",
         "          forward<CPT>(mine, net, d, lane);\n"
         "          PROF(0, tA); tA = clock64();"),
        ("            backward<CPT>(mine, net, d, lane);\n          }\n        }",
         "            backward<CPT>(mine, net, d, lane);\n"
         "            PROF(1, tA);\n          }\n        }\n"
         "        tA = clock64();"),
        ("        if (mode != kPredOnly) {\n          __syncthreads();",
         "        if (mode != kPredOnly) {\n          __syncthreads();\n"
         "          PROF(2, tA); tA = clock64();"),
        ("          reduce_chunk<CPT>(slots, slot_f, nc, d, gacc, warp, C, "
         "lane);\n          __syncthreads();",
         "          reduce_chunk<CPT>(slots, slot_f, nc, d, gacc, warp, C, "
         "lane);\n          PROF(3, tA); tA = clock64();\n"
         "          __syncthreads();\n          PROF(4, tA);"),
        ("      if (mode != kPredOnly) {  // Adam",
         "      long long tB = clock64();\n"
         "      if (mode != kPredOnly) {  // Adam"),
        ("          vk[e] = v;\n        }\n      }\n      __syncthreads();",
         "          vk[e] = v;\n        }\n      }\n      __syncthreads();\n"
         "      PROF(5, tB);"),
        ("  for (int step = 0; step < d.G; ++step) {",
         "  const long long tS = clock64();\n"
         "  for (int step = 0; step < d.G; ++step) {"),
        ("  if (tid == 0) {\n    stat[0] = sh_c1;",
         "  PROF(7, tS);\n  if (tid == 0) {\n    stat[0] = sh_c1;"),
    ]
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"train_run.cu has no unique anchor {old!r}")
        src = src.replace(old, new)
    return src


def kernel_split(dev: torch.device, card: str) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        cu = os.path.join(tmp, "train_run_probes.cu")
        so = os.path.join(tmp, "libtrain_run_probes.so")
        with open(cu, "w") as f:
            f.write(instrumented_source())
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                       check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(so)
        fn = lib.njode_train_run
        fn.argtypes = ([ctypes.c_void_p] * 7
                       + [ctypes.POINTER(ctypes.c_int),
                          ctypes.POINTER(ctypes.c_float), ctypes.c_void_p])
        fn.restype = ctypes.c_int
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
                cycles = (ctypes.c_ulonglong * 128)()
                lib.njode_prof_read(cycles)
                before = list(cycles)
                tk.fused_train_run(state, data, **kw)
                torch.cuda.synchronize()
                lib.njode_prof_read(cycles)
        finally:
            tk._load_kernel = shipped
        warps = tk.launch_plan(32, chip_smoke.TRAIN_N, 128)[0]
        total = [cycles[w * 8 + 7] - before[w * 8 + 7] for w in range(warps)]
        print(f"training kernel phase split on {card} (one epoch call: 8 "
              f"steps, K=2, H=32, N={chip_smoke.TRAIN_N}, batch 128, "
              f"{warps} warps), cycles per warp summed over the call, mean "
              f"over warps, share of the call:", flush=True)
        for k, name in enumerate(PHASES):
            per = [cycles[w * 8 + k] - before[w * 8 + k] for w in range(warps)]
            mean = sum(per) / warps
            print(f"  {name}: {mean:.0f} cycles ({100.0 * mean / total[0]:.1f}%)"
                  f", warps {min(per)}-{max(per)}", flush=True)
        print(f"  whole call: {total[0]} cycles", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_training: no CUDA device")
    dev, card = chip_smoke.device_phase()
    out_dir = "chiprun_out"
    os.makedirs(out_dir, exist_ok=True)
    profile_trainer(dev, card, out_dir)
    kernel_split(dev, card)


if __name__ == "__main__":
    main()
