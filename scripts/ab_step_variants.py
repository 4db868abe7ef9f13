"""A/B of variants of the fused step's f32 kernels (rows 9-10) on one card.

    python scripts/ab_step_variants.py [NAME ...] [--plans RT,SG;RT,SG ...]

Builds each named variant of ``csrc/step_f32.cuh`` / ``csrc/fused_step.cu``
(textual edits of the sources, ``VARIANTS`` below; ``shipped`` is the source
as it is) with nvcc, all in parallel, into a temporary directory, and
prints its f32 functions' registers and spill bytes as ptxas reports them.
Then, at the scaled recipe's shape (H 256, N 2, two networks, L 1,
relu/identity, 4,096 rows), it checks every (variant, plan) against the
plain version and times rows 9 and 10 through the wrapper (CUDA events,
median of 20 calls after 3, three rounds, the cases in turns and back).  A
plan is (trajectories a tile, slots a group); the default is the launch
plan's.  The ``no-*`` variants compute wrong values on purpose: they
ablate a part of the kernel to time the rest.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from njode_tpu_torch.ops import _build  # noqa: E402
from njode_tpu_torch.ops import fused_step as fs  # noqa: E402

FMA = "        for (int i = 0; i < TM; ++i) acc[m][i] = fmaf(av[i], wv[m], acc[m][i]);"
# name -> [(file, old text, new text)]
VARIANTS = {
    "shipped": [],
    # every thread's 16-byte copies in place of one bulk copy a slice
    "cp.async": [("step_f32.cuh", "const bool bulk = H == Hp;", "const bool bulk = false;")],
    # each block walks the plane's slices from its own start
    "rotate-k": [
        ("step_f32.cuh", "  const int base = *stage_count();\n",
         "  const int base = *stage_count();\n"
         "  const int rot = (blockIdx.x * 7 + blockIdx.y * 3) % n_sl;\n"),
        ("step_f32.cuh", "p.W + (size_t)sl * kBK * H, kBK * Hp * 4,",
         "p.W + (size_t)((sl + rot) % n_sl) * kBK * H, kBK * Hp * 4,"),
        ("step_f32.cuh", "    const float* a = A + (size_t)sl * kBK * RS;",
         "    const float* a = A + (size_t)((sl + rot) % n_sl) * kBK * RS;")],
    # 16 warps a block, 8-row register tiles (at most 128 registers)
    "16-warps": [("step_f32.cuh", "constexpr int kWarps = 8;", "constexpr int kWarps = 16;")],
    # the product chunks' epilogues skipped
    "no-epilogue": [
        ("step_f32.cuh", "  switch (p.mode) {\n    case kEpBias:",
         "  if (p.mode < 0) switch (p.mode) {\n    case kEpBias:"),
        ("step_f32.cuh", "  if (p.act >= 0 || p.rec.p) {", "  if (p.mode < 0) {")],
    # the product chunks' inner loop reduced to its first k (the stream
    # of the weight slices, the barriers and the epilogues stay)
    "no-products": [
        ("step_f32.cuh", FMA,
         "        for (int i = 0; i < TM; ++i)\n"
         "          if (i == 0 && kk == 0) acc[m][i] = fmaf(av[i], wv[m], acc[m][i]);")],
}


def build(names: list[str], tmp: str) -> dict:
    """name -> (library, ptxas output), the variants built in parallel."""
    procs = {}
    for name in names:
        d = os.path.join(tmp, name)
        os.makedirs(d)
        for f in ("step_f32.cuh", "fused_step.cu"):
            src = (_build.CSRC / f).read_text()
            for g, old, new in VARIANTS[name]:
                if g == f:
                    if src.count(old) != 1:
                        raise RuntimeError(f"{name}: no unique anchor {old!r} in {f}")
                    src = src.replace(old, new)
            with open(os.path.join(d, f), "w") as out:
                out.write(src)
        so = os.path.join(d, "lib.so")
        procs[name] = (so, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o", so,
             os.path.join(d, "fused_step.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    shipped = fs._load_kernel()
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{out[-3000:]}")
        lib = ctypes.CDLL(so)
        for fn in ("njode_step_fwd", "njode_step_bwd", "njode_step_scratch_floats",
                   "njode_cuda_error_string"):
            getattr(lib, fn).argtypes = getattr(shipped, fn).argtypes
            getattr(lib, fn).restype = getattr(shipped, fn).restype
        libs[name] = (lib, out)
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ab_step_variants: no CUDA device")
    args = sys.argv[1:]
    plans = [None]
    if "--plans" in args:
        spec = args[args.index("--plans") + 1]
        plans = [tuple(int(v) for v in p.split(",")) for p in spec.split(";")]
        args = args[:args.index("--plans")] + args[args.index("--plans") + 2:]
    names = args or list(VARIANTS)
    dev, card = cs.device_phase()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(names, tmp)
        for name, (_, out) in libs.items():
            _build.BUILD_LOG["fused_step"] = out
            f32 = {k: v for k, v in cs.step_instances().items() if k.startswith("f32")}
            print(f"{name}: registers, spill bytes {f32}", flush=True)
        c = cs.step_case(torch.Generator().manual_seed(17), 256, 2, False, 1, "relu",
                         "identity", 4096, dev)
        act = ("relu", "identity")
        shipped_load = fs._load_kernel

        def run(name, plan, bwd):
            fs._load_kernel = lambda: libs[name][0]
            plan = plan or cs.step_plan(c)[int(bwd)]
            if bwd:
                return fs._launch_bwd(c["W"], c["V"], c["times"], c["values"], c["gy"],
                                      c["lo"], *act, plan)
            return fs._launch_fwd(c["W"], c["V"], c["times"], c["values"], c["lo"], *act,
                                  plan)
        cases = [(n, p) for n in names for p in plans]
        times = {k: ([], []) for k in cases}
        try:
            with torch.no_grad():
                y_p = cs.step_fwd(c, *act, False)
                g_p = cs.step_bwd(c, *act, False)
                for k in cases:
                    y, g = run(*k, False), run(*k, True)
                    torch.cuda.synchronize()
                    print(f"{k}: forward max abs err {float((y - y_p).abs().max()):.2e}, "
                          f"backward largest error/norm "
                          f"{cs.step_bwd_share(g, g_p, 1.0):.2e}", flush=True)
                for _ in range(3):
                    for k in cases + cases[::-1]:
                        times[k][0].append(cs.time_ms(lambda: run(*k, False), 3, 20))
                        times[k][1].append(cs.time_ms(lambda: run(*k, True), 3, 20))
        finally:
            fs._load_kernel = shipped_load
    for k in cases:
        print(f"{card}: {k} rows 9-10 (H 256, N 2, two networks, L 1, 4,096 rows): "
              f"forward ms {sorted(round(x, 4) for x in times[k][0])}, backward ms "
              f"{sorted(round(x, 4) for x in times[k][1])}", flush=True)


if __name__ == "__main__":
    main()
