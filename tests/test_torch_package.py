"""Package boundary of the PyTorch port: it imports without JAX and without
a CUDA compiler, builds nothing at import, and CPU calls launch nothing."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import njode_tpu_torch
from njode_tpu_torch.ops import _build, gap_scan

REPO = Path(__file__).resolve().parents[1]
PORT_MODULES = ["njode_tpu_torch", "njode_tpu_torch.models",
                "njode_tpu_torch.models.jump_ode", "njode_tpu_torch.ops",
                "njode_tpu_torch.ops.gap_scan", "njode_tpu_torch.ops._build",
                "njode_tpu_torch.serving", "njode_tpu_torch.simulation",
                "njode_tpu_torch.utils"]


def _run(code, env_update=None):
    env = dict(os.environ, PYTHONPATH=str(REPO), **(env_update or {}))
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=str(REPO), timeout=120)


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in PORT_MODULES)
            + "bad = [m for m in sys.modules if m == 'jax' or "
              "m.startswith(('jax.', 'njode_tpu.')) or m == 'njode_tpu']\n"
              "assert not bad, bad\nprint('ok')\n")
    res = _run(code)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_import_needs_no_nvcc_and_builds_nothing():
    code = ("import njode_tpu_torch.ops._build as b, njode_tpu_torch\n"
            "assert not b._LIBS and not b.BUILD_LOG\n"
            "try:\n    b.find_nvcc()\nexcept RuntimeError as e:\n"
            "    print('no nvcc:', e)\n")
    res = _run(code, {"PATH": os.path.dirname(sys.executable),
                      "CUDA_HOME": str(REPO / "no-such-cuda")})
    assert res.returncode == 0, res.stderr
    if not Path("/usr/local/cuda/bin/nvcc").is_file():
        assert "no nvcc: nvcc not found" in res.stdout


def test_cpu_calls_launch_no_kernel():
    model = njode_tpu_torch.NeuralJumpODE(
        input_dim=1, hidden_dim=8, output_dim=1, num_moments=2,
        shared_network=True, dt_ode_step=0.05, t_max=1.0)
    gap_scan.LAUNCHES = 0
    times = torch.tensor([[0.0, 0.3, 0.7]])
    values = torch.ones(1, 3, 1)
    out = model.predict_at(times, values, torch.tensor([[0.1, 0.5, 0.95]]))
    filt = njode_tpu_torch.NJODEFilter(model)
    state = filt.update(filt.init_state(2), 0.2, torch.ones(2, 1))
    filt.predict(state, 0.6)
    assert gap_scan.LAUNCHES == 0
    assert torch.isfinite(out["raw"]).all()


def test_kernel_sources_ship_with_the_package():
    assert (_build.CSRC / "gap_scan.cu").is_file()
    assert _build.BUILD_DIR.parent == Path(gap_scan.__file__).parent
    flags = " ".join(_build.NVCC_FLAGS)
    assert "sm_90a" in flags and "fast_math" not in flags


def test_public_api():
    assert set(njode_tpu_torch.__all__) >= {"NeuralJumpODE", "NJODEFilter"}
    with pytest.raises(ValueError, match="Unknown ode_solver"):
        njode_tpu_torch.NeuralJumpODE(1, 4, 1, ode_solver="midpoint")
