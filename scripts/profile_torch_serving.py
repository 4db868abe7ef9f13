"""Where the time of the PyTorch port's serving path goes, on one CUDA card.

Runs the chip_smoke.py workloads of the production model (hidden 50, shared,
two moments, dt_ode_step 0.01): one batched predict_at of 1,000 streams x 21
queries, and NJODEFilter ticks (update + predict) on 256 streams.  For each
it prints the host wall time per call, the device time summed over kernels
(torch.profiler), the device's idle share of the wall time, the device
launches (kernels and copies) and the gap kernel's (row 1) launches per
call, row 1's own device time per call, and the ops that take the most
device and host time.  Chrome traces go to chiprun_out/.

    PYTHONPATH=. python scripts/profile_torch_serving.py
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from njode_tpu_torch import NJODEFilter  # noqa: E402
from njode_tpu_torch.ops import gap_scan  # noqa: E402

N_CALLS = 20


def device_us(prof) -> float:
    """Device time summed over the device-side events (kernels, copies), us."""
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == cuda)


def report(name: str, fn, card: str, out_dir: str) -> None:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    gap_scan.LAUNCHES = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(N_CALLS):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = device_us(prof)
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type == cuda]
    row1 = sum(e.time_range.elapsed_us() for e in events
               if "gap_scan_fwd_kernel" in e.name)
    print(f"{name} on {card}: wall {wall_us / N_CALLS:.1f} us/call "
          f"(profiled), device {dev / N_CALLS:.1f} us/call, device idle "
          f"{100.0 * (1.0 - dev / wall_us):.1f}%; device launches "
          f"{len(events) / N_CALLS:.1f}/call, gap-kernel (row 1) launches "
          f"{gap_scan.LAUNCHES / N_CALLS:.1f}/call, row 1 device time "
          f"{row1 / N_CALLS:.1f} us/call", flush=True)
    sort = ("self_device_time_total" if hasattr(
        prof.key_averages()[0], "self_device_time_total")
        else "self_cuda_time_total")
    print(prof.key_averages().table(sort_by=sort, row_limit=12), flush=True)
    print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                    row_limit=12), flush=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"trace_{name}.json"))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_serving: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    out_dir = "chiprun_out"
    os.makedirs(out_dir, exist_ok=True)
    model = chip_smoke.production_model(dev)
    obs_t, obs_v, query, mask = chip_smoke.batch_request(dev)
    report("predict_at", lambda: model.predict_at(obs_t, obs_v, query, mask),
           card, out_dir)
    ts, xs = chip_smoke.stream_ticks()
    xs = xs.to(dev)
    filt = NJODEFilter(model)
    state = filt.init_state(xs.shape[1])

    def tick():
        s = filt.update(state, ts[-1], xs[-1])
        filt.predict(s, ts[-1] + 0.02)
    report("filter_tick", tick, card, out_dir)


if __name__ == "__main__":
    main()
