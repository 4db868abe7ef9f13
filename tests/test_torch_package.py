"""Package boundary of the PyTorch port: it imports without JAX and without
a CUDA compiler, builds nothing at import, and CPU calls launch nothing."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import njode_tpu_torch
from njode_tpu_torch.ops import (_build, fused_cell, gap_scan, walk_scan,
                                 walk_train)

REPO = Path(__file__).resolve().parents[1]
PORT_MODULES = ["njode_tpu_torch", "njode_tpu_torch.models",
                "njode_tpu_torch.models.jump_ode",
                "njode_tpu_torch.models.loss", "njode_tpu_torch.ops",
                "njode_tpu_torch.ops.activations",
                "njode_tpu_torch.ops.fused_cell",
                "njode_tpu_torch.ops.fused_step",
                "njode_tpu_torch.ops.gap_scan",
                "njode_tpu_torch.ops.train_kernel",
                "njode_tpu_torch.ops.walk_scan",
                "njode_tpu_torch.ops.walk_train",
                "njode_tpu_torch.ops._build", "njode_tpu_torch.serving",
                "njode_tpu_torch.simulation",
                "njode_tpu_torch.simulation.moments",
                "njode_tpu_torch.utils", "njode_tpu_torch.utils.checkpoint",
                "njode_tpu_torch.utils.training",
                "njode_tpu_torch.utils.weights",
                "njode_tpu_torch.generative",
                "njode_tpu_torch.utils.plotting",
                "njode_tpu_torch.utils.profiling",
                "njode_tpu_torch.experiments",
                "njode_tpu_torch.experiments.common",
                "njode_tpu_torch.experiments.experiment_black_scholes",
                "njode_tpu_torch.experiments.experiment_ou",
                "njode_tpu_torch.experiments.experiment_heston",
                "njode_tpu_torch.experiments.experiment_hybrid",
                "njode_tpu_torch.experiments.compare_experiments"]


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


def test_the_port_and_a_no_plots_cli_run_need_no_matplotlib(tmp_path):
    """With matplotlib blocked the port imports, its utils export no
    plotting name, a --no-plots CLI run trains and saves, and a run that
    asks for plots fails on the import after training instead of skipping
    them."""
    code = (
        "import sys\n"
        "sys.modules['matplotlib'] = None\n"
        "import njode_tpu_torch, njode_tpu_torch.utils as u\n"
        "from njode_tpu_torch.experiments import experiment_black_scholes "
        "as e\n"
        "assert not [n for n in u.__all__ if n.startswith('plot')], "
        "u.__all__\n"
        "assert not hasattr(u, 'plot_training_history')\n"
        "tiny = ['--device', 'cpu', '--n-train', '8', '--n-val', '4', "
        "'--n-epochs', '2', '--batch-size', '4', '--n-steps', '20']\n"
        "e.main(tiny + ['--no-plots'])\n"
        "try:\n"
        "    e.main(tiny + ['--experiment-name', 'plots'])\n"
        "except ImportError as err:\n"
        "    assert err.name == 'matplotlib', err\n"
        "else:\n"
        "    raise AssertionError('plots were skipped quietly')\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path), timeout=120)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), (
        res.stdout + res.stderr)
    run = tmp_path / "runs" / "njode_black_scholes"
    assert (run / "model.ckpt").is_file() and not list(run.glob("*.png"))
    assert (tmp_path / "runs" / "plots" / "model.ckpt").is_file()


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
        shared_network=True, dt_ode_step=0.05, t_max=1.0, device="cpu")
    gap_scan.LAUNCHES = 0
    times = torch.tensor([[0.0, 0.3, 0.7]])
    values = torch.ones(1, 3, 1)
    out = model.predict_at(times, values, torch.tensor([[0.1, 0.5, 0.95]]))
    filt = njode_tpu_torch.NJODEFilter(model)
    state = filt.update(filt.init_state(2), 0.2, torch.ones(2, 1))
    filt.predict(state, 0.6)
    assert gap_scan.LAUNCHES == 0
    assert torch.isfinite(out["raw"]).all()


def test_cpu_grid_walk_and_walk_twin_launch_no_kernel():
    """The grid walk (forward and backward) and the walk-train kernel's
    wrapper take their plain versions for CPU tensors."""
    from njode_tpu_torch.utils import Trainer
    model = njode_tpu_torch.NeuralJumpODE(
        input_dim=1, hidden_dim=8, output_dim=1, num_moments=2,
        shared_network=True, dt_ode_step=0.1, t_max=1.0, grid_walk=True,
        device="cpu")
    walk_scan.LAUNCHES_FWD = walk_scan.LAUNCHES_BWD = walk_train.LAUNCHES = 0
    times = torch.tensor([[0.0, 0.3, 0.7, 1.0]] * 4)
    values = torch.ones(4, 4, 1)
    model.apply_loss(times, values, ignore_first_continuity=True).backward()
    trainer = Trainer(model, ignore_first_continuity=True,
                      use_train_kernel=True)
    trainer.train(lambda: (times, values), n_epochs=1, batch_size=2)
    assert walk_scan.LAUNCHES_FWD == walk_scan.LAUNCHES_BWD == 0
    assert walk_train.LAUNCHES == 0


@pytest.mark.parametrize("dt", [0.05, None], ids=["gap-loop", "cell"])
def test_cpu_forced_kernels_launch_no_kernel(dt):
    """use_pallas=True on CPU tensors: the gap loop's training pair and the
    fused cell take their plain versions, forward and backward."""
    model = njode_tpu_torch.NeuralJumpODE(
        input_dim=1, hidden_dim=8, output_dim=1, num_moments=2,
        shared_network=dt is not None, dt_ode_step=dt, t_max=1.0,
        use_pallas=True, device="cpu")
    for counter in (gap_scan.LAUNCHES_RES_FWD, gap_scan.LAUNCHES_BWD):
        for mode in counter:
            counter[mode] = 0
    gap_scan.LAUNCHES = fused_cell.LAUNCHES = 0
    times = torch.tensor([[0.0, 0.3, 0.7, 1.0]] * 4)
    loss = model.apply_loss(times, torch.ones(4, 4, 1),
                            ignore_first_continuity=True)
    loss.backward()
    assert torch.isfinite(loss)
    assert gap_scan.LAUNCHES == fused_cell.LAUNCHES == 0
    assert not any(gap_scan.LAUNCHES_RES_FWD.values())
    assert not any(gap_scan.LAUNCHES_BWD.values())


def test_kernel_sources_ship_with_the_package():
    assert (_build.CSRC / "gap_scan.cu").is_file()
    assert (_build.CSRC / "train_run.cu").is_file()
    for name in ("walk_scan.cu", "walk_train.cu", "walk_cell.cuh",
                 "fused_step.cu", "gap_train.cu", "gap_cell.cuh",
                 "fused_cell.cu"):
        assert (_build.CSRC / name).is_file(), name
    assert _build.BUILD_DIR.parent == Path(gap_scan.__file__).parent
    flags = " ".join(_build.NVCC_FLAGS)
    assert "sm_90a" in flags and "fast_math" not in flags


def test_public_api():
    assert set(njode_tpu_torch.__all__) >= {"NeuralJumpODE", "NJODEFilter",
                                            "sample_paths"}
    with pytest.raises(ValueError, match="Unknown ode_solver"):
        njode_tpu_torch.NeuralJumpODE(1, 4, 1, ode_solver="midpoint",
                                      device="cpu")


@pytest.mark.parametrize("entry", ["model", "data_loader", "run_experiment"])
def test_default_device_is_cuda(entry, tmp_path, monkeypatch):
    """With no device asked for, the port means cuda: the resolved device is
    cuda where a card exists, and without one the entry points raise rather
    than run on the CPU.  No CUDA tensor is built."""
    from njode_tpu_torch.models import resolve_device
    from njode_tpu_torch.utils import DataLoader, run_experiment
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == resolve_device("auto") == torch.device(
        "cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "model": lambda: njode_tpu_torch.NeuralJumpODE(1, 4, 1),
        "data_loader": lambda: DataLoader(0, 4, "black_scholes", 0.1, True,
                                          {}),
        "run_experiment": lambda: run_experiment(
            {"experiment_name": "x", "input_dim": 1, "hidden_dim": 4,
             "output_dim": 1, "learning_rate": 1e-3, "weight_decay": 0.0,
             "n_epochs": 1, "data": {"process_type": "black_scholes"}},
            save_dir=str(tmp_path)),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
