"""The port's experiment CLIs (``njode_tpu_torch.experiments``) on the CPU.

* ``build_config`` of the port gives the JAX package's dict
  (``experiments/common.py``) for each experiment's defaults, the flags of
  the ``scripts/run_*.sh`` recipes, each ``--kernels`` choice and other
  flags, and the ``--ensemble-lrs`` errors keep their messages.  Each side's
  ``main`` runs with its ``run_and_plot`` replaced by a recorder, so the
  comparison covers what each ``main`` hands on.
* Each CLI's ``main`` trains at a tiny size on the CPU and writes its
  artifacts and plots; a rerun resumes.
* ``compare_experiments`` (the overlay and ``--sweep``), the plotted lines
  (the model mean is ``predict_on_grid`` on the plotted path, the
  conditional expectation the port's ``condexp_*_on_grid``), the profiling
  helpers, and ``chip_smoke.py``'s recipe configs, now built by the port's
  ``build_config``, against the dicts it wrote out by hand before.
"""

import importlib.util
import json
import re
import shlex
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from njode_tpu_torch import NeuralJumpODE
from njode_tpu_torch.experiments import (compare_experiments,
                                         experiment_black_scholes,
                                         experiment_heston, experiment_hybrid,
                                         experiment_ou)
from njode_tpu_torch.simulation import (condexp_black_scholes_on_grid,
                                        condexp_heston_on_grid,
                                        condexp_hybrid_on_grid,
                                        condexp_ou_on_grid,
                                        generate_hybrid_ou_bs,
                                        supports_obs_only)
from njode_tpu_torch.utils import plotting
from njode_tpu_torch.utils.profiling import StepTimer, maybe_trace

REPO = Path(__file__).resolve().parents[1]
PORT = {"black_scholes": experiment_black_scholes, "ou": experiment_ou,
        "heston": experiment_heston, "hybrid": experiment_hybrid}
RUN_NAMES = {"black_scholes": "njode_black_scholes", "ou": "njode_ou",
             "heston": "njode_heston", "hybrid": "njode_hybrid"}
TINY = ["--device", "cpu", "--n-train", "8", "--n-val", "4", "--n-epochs",
        "4", "--batch-size", "4", "--print-every", "2", "--n-steps", "20"]


def jax_cli(name):
    """The JAX package's experiment module (run from its directory, as its
    ``from common import`` expects)."""
    sys.path.insert(0, str(REPO / "experiments"))
    try:
        spec = importlib.util.spec_from_file_location(
            f"jax_experiment_{name}", REPO / "experiments"
            / f"experiment_{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(REPO / "experiments"))
    return mod


def recorded_main(module, argv, monkeypatch, jax_side):
    """What ``main`` hands ``run_and_plot``: (config, process type,
    process parameters, make_plots, profile_dir)."""
    calls = []

    def record(config, process_type, process_params, make_plots=True,
               save_dir="runs", profile_dir=None):
        calls.append((config, process_type, process_params, make_plots,
                      profile_dir))

    monkeypatch.setattr(module, "run_and_plot", record)
    if jax_side:
        monkeypatch.setattr(sys, "argv", ["experiment", *argv])
        module.main()
    else:
        module.main(argv)
    (call,) = calls
    return call


def script_flags(name):
    """The flags a shell script passes to its experiment module."""
    text = (REPO / "scripts" / name).read_text().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines() if "experiment" in ln
                and "python" in ln)
    words = shlex.split(line.split('"$@"')[0])
    return words[words.index(next(w for w in words
                                  if "experiment" in w)) + 1:]


SCRIPTS = {"black_scholes": ["run_black_scholes.sh", "run_scaled_sweep.sh"],
           "ou": ["run_ou.sh"], "heston": ["run_heston.sh"],
           "hybrid": ["run_hybrid.sh"]}
FLAG_SETS = [(name, []) for name in PORT] + [
    (name, script_flags(script)) for name, scripts in SCRIPTS.items()
    for script in scripts] + [
    ("black_scholes", ["--kernels", k])
    for k in ("off", "auto", "force", "step", "train")] + [
    ("black_scholes", ["--ensemble-lrs", "1e-3,2e-3,5e-3"]),
    ("black_scholes", ["--ensemble", "2", "--ensemble-lrs", "1e-3,2e-3",
                       "--compute-dtype", "bfloat16", "--train-kernel-mxu",
                       "bfloat16", "--profile-dir", "prof", "--no-plots"]),
    ("black_scholes", ["--dt-ode-step", "0.01", "--grid-walk", "on",
                       "--ode-solver", "rk4", "--obs-only", "off",
                       "--experiment-name", "mine", "--no-shuffle"]),
    ("ou", ["--activation", "tanh", "--obs-only", "on", "--theta", "2"]),
    ("heston", ["--xi", "0.3", "--extended-moments", "--cache-data"]),
    ("hybrid", ["--exact-hybrid-truths", "--switch-time", "0.5",
                "--data-parallel", "2", "--multihost"])]


@pytest.mark.parametrize("name,argv", FLAG_SETS,
                         ids=[f"{n}:{' '.join(a) or 'defaults'}"
                              for n, a in FLAG_SETS])
def test_build_config_matches_jax(name, argv, monkeypatch):
    ours = recorded_main(PORT[name], argv, monkeypatch, jax_side=False)
    ref = recorded_main(jax_cli(name), argv, monkeypatch, jax_side=True)
    assert ours == ref


@pytest.mark.parametrize("value,ensemble", [
    ("1e-3", None), ("1e-3,x", None), ("1e-3,2e-3", "3")])
def test_ensemble_lrs_errors_keep_the_jax_messages(value, ensemble,
                                                   monkeypatch):
    argv = ["--ensemble-lrs", value] + (["--ensemble", ensemble]
                                        if ensemble else [])
    with pytest.raises(SystemExit) as ours:
        recorded_main(experiment_black_scholes, argv, monkeypatch, False)
    with pytest.raises(SystemExit) as ref:
        recorded_main(jax_cli("black_scholes"), argv, monkeypatch, True)
    assert str(ours.value) == str(ref.value) and "--ensemble" in str(
        ours.value)


@pytest.mark.parametrize("script", sorted(
    s for scripts in SCRIPTS.values() for s in scripts
    if s != "run_scaled_sweep.sh"))
def test_shell_twins_pass_the_same_flags(script):
    twin = script.replace(".sh", "_torch.sh")
    text = (REPO / "scripts" / twin).read_text()
    assert "python -u -m njode_tpu_torch.experiments.experiment_" in text
    assert script_flags(twin) == script_flags(script)


def test_help_states_the_ports_routes_and_no_tpu_figure(capsys):
    for module in PORT.values():
        with pytest.raises(SystemExit):
            module.main(["--help"])
    text = capsys.readouterr().out
    assert "--device" in text and "cuda" in text and "AUTO_SHAPE_H100" in text
    for word in ("TPU", "MXU", "VMEM", "BENCH_NOTES", "jax", "Pallas"):
        assert word not in text, word


@pytest.mark.parametrize("name", list(PORT))
def test_cli_main_trains_and_plots_on_the_cpu(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    res = PORT[name].main(TINY)
    d = tmp_path / "runs" / RUN_NAMES[name]
    for artifact in ("config.json", "history.json", "model.ckpt",
                     "training_history.png", "relative_loss.png",
                     "trajectory_comparison.png"):
        assert (d / artifact).is_file(), artifact
    history = json.loads((d / "history.json").read_text())
    assert len(history["train_loss"]) == 4
    assert all(np.isfinite(history["train_loss"]))
    config = json.loads((d / "config.json").read_text())
    args = PORT[name].parse_args(TINY)
    assert config == json.loads(json.dumps(PORT[name].configure(args)[0]))
    assert config["data"]["obs_only"] == supports_obs_only(
        config["data"]["process_type"])
    assert res["final_train_loss"] == history["train_loss"][-1]


def test_cli_rerun_resumes(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    experiment_black_scholes.main(TINY + ["--no-plots"])
    first = json.loads((tmp_path / "runs" / "njode_black_scholes"
                        / "history.json").read_text())["train_loss"]
    experiment_black_scholes.main(TINY + ["--no-plots", "--n-epochs", "6"])
    out = capsys.readouterr().out
    history = json.loads((tmp_path / "runs" / "njode_black_scholes"
                          / "history.json").read_text())
    assert "Epoch    4" in out and "(resumed)" in out
    assert len(history["train_loss"]) == 6
    assert history["train_loss"][:4] == first
    assert not list((tmp_path / "runs" / "njode_black_scholes").glob(
        "*.png"))


def test_cli_refuses_unported_flags(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for extra, item in ((["--ensemble", "2"], "item 11"),
                        (["--data-parallel", "2"], "item 12"),
                        (["--checkpoint-backend", "orbax"], "item 12")):
        with pytest.raises(NotImplementedError, match=item):
            experiment_black_scholes.main(TINY + ["--no-plots", *extra])


def test_profile_dir_writes_a_trace(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    experiment_ou.main(TINY + ["--no-plots", "--n-epochs", "1",
                               "--profile-dir", "prof"])
    (trace,) = (tmp_path / "prof").glob("trace_*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert events


def test_profiling_helpers():
    with maybe_trace(None):
        pass
    timer = StepTimer()
    for _ in range(2):
        with timer.measure({"x": [torch.ones(3)]}):
            torch.ones(4).sum()
    assert len(timer.times) == 2 and timer.mean >= 0.0


def write_run(d, hidden, layers, val, rel=(0.5, 0.2)):
    d.mkdir(parents=True)
    (d / "config.json").write_text(json.dumps(
        {"hidden_dim": hidden, "n_hidden_layers": layers}))
    (d / "history.json").write_text(json.dumps(
        {"train_loss": [2.0, 1.0], "val_loss": [1.5, val],
         "relative_loss": list(rel), "epoch_times": [0.5, 0.25]}))


def test_compare_experiments_overlay(tmp_path, capsys):
    runs = tmp_path / "runs"
    write_run(runs / "njode_black_scholes", 32, 1, 0.9)
    write_run(runs / "njode_ou", 32, 1, 0.8, rel=(0.4, 0.1))
    out = tmp_path / "cmp.png"
    compare_experiments.main(["--runs-dir", str(runs), "--output", str(out)])
    text = capsys.readouterr().out
    assert out.is_file() and out.stat().st_size > 0
    assert "skipping Heston" in text and "skipping Hybrid OU-BS" in text
    assert re.search(r"Ornstein-Uhlenbeck\s+0\.1000", text)


@pytest.mark.parametrize("grid", [True, False], ids=["heatmap", "bars"])
def test_compare_experiments_sweep(tmp_path, grid):
    runs = tmp_path / "runs"
    shapes = ([(h, l) for h in (16, 32) for l in (1, 2)] if grid
              else [(16, 1), (32, 2)])
    for i, (h, l) in enumerate(shapes):
        write_run(runs / f"sweep_{i}", h, l, 0.1 * (i + 1))
    (runs / "sweep_broken").mkdir()
    compare_experiments.main(["--runs-dir", str(runs), "--sweep",
                              str(runs / "sweep_*")])
    rows = (runs / "sweep_results.csv").read_text().splitlines()
    assert rows[0].startswith("run,hidden_dim,n_hidden_layers")
    assert len(rows) == 1 + len(shapes)
    assert (runs / "sweep_results.png").stat().st_size > 0


PLOT_PARAMS = {
    "black_scholes": dict(mu=0.1, sigma=0.5, x0=1.0),
    "ornstein_uhlenbeck": dict(theta=1.0, mu=0.5, sigma=0.3, x0=0.0),
    "heston": dict(mu=0.5, kappa=2.0, theta=0.04, xi=0.5, rho=-0.5, x0=1.0,
                   v0=0.04),
    "hybrid_ou_bs": dict(theta_ou=1.0, mu_ou=0.5, sigma_ou=0.3, mu_bs=0.1,
                         sigma_bs=0.2, switch_time=None, x0=1.0)}


@pytest.mark.parametrize("process", list(PLOT_PARAMS))
def test_plotted_lines(process, monkeypatch):
    """The drawn model-mean line is predict_on_grid on the drawn path and
    its drawn observations; the drawn conditional expectation is the
    port's condexp_*_on_grid on that path."""
    figs = []
    monkeypatch.setattr(plotting.plt, "close", figs.append)
    model = NeuralJumpODE(1, 8, 1, num_moments=2, dt_ode_step=0.05,
                          device="cpu",
                          generator=torch.Generator().manual_seed(1))
    params = dict(PLOT_PARAMS[process], T=1.0, n_steps=20)
    plotting.plot_single_trajectory_with_condexp(model, process, params,
                                                 obs_fraction=0.2, seed=42)
    (fig,) = figs
    ax = fig.axes[0]
    lines = {ln.get_label(): ln for ln in ax.get_lines()}
    (obs,) = [c for c in ax.collections if c.get_label() == "Observations"]
    t = torch.as_tensor(lines["True Path"].get_xdata())
    path = torch.as_tensor(lines["True Path"].get_ydata())
    obs_t = torch.as_tensor(obs.get_offsets()[:, 0].data, dtype=t.dtype)
    mask = torch.isin(t, obs_t)
    assert int(mask.sum()) == len(obs_t) >= 2
    want = model.predict_on_grid(t, mask[None], path[None, :, None])
    np.testing.assert_allclose(lines["Model Mean"].get_ydata(),
                               want["mean"][0, :, 0].numpy(), rtol=1e-6)
    p = PLOT_PARAMS[process]
    if process == "black_scholes":
        ce = condexp_black_scholes_on_grid(t, path, obs_t, p["mu"])
    elif process == "ornstein_uhlenbeck":
        ce = condexp_ou_on_grid(t, path, obs_t, p["theta"], p["mu"])
    elif process == "heston":
        ce = condexp_heston_on_grid(t, path, obs_t, p["mu"])
    else:
        switch = generate_hybrid_ou_bs(seed=42, device="cpu", **params)[2]
        ce = condexp_hybrid_on_grid(t, path, obs_t, switch, p["theta_ou"],
                                    p["mu_ou"], p["mu_bs"])
    np.testing.assert_allclose(
        lines["True Conditional Expectation"].get_ydata(), ce.numpy(),
        rtol=1e-6)
    labels = {c.get_label() for c in ax.collections}
    assert "Model ±2σ" in labels
    assert ("True ±2σ" in labels) == (process != "hybrid_ou_bs")


def test_plotting_refuses_ensembles():
    model = NeuralJumpODE(1, 8, 1, num_moments=2, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        plotting.plot_single_trajectory_with_condexp(
            model, "black_scholes", {}, ensemble_params={})


# ---- chip_smoke.py's recipe configs: the dicts it wrote out by hand before
# they came from build_config, kept here to prove the two equal

def _old_default_config(n_epochs, name):
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


def _old_production_config(n_epochs, name):
    cfg = _old_default_config(n_epochs, name)
    cfg.update(hidden_dim=50, batch_size=256, dt_ode_step=0.01,
               moment_weights=[1.0, 15.0], shared_network=True)
    cfg["data"] = dict(cfg["data"], n_train=10_000, n_val=2_000)
    return cfg


def _old_scaled_config(n_epochs, name):
    cfg = _old_default_config(n_epochs, name)
    cfg.update(hidden_dim=256, batch_size=4096, use_pallas="step")
    cfg["data"] = dict(cfg["data"], n_train=100_000, n_val=5_000,
                       obs_fraction=0.02)
    return cfg


def _old_family_config(cfg, process):
    keep = ("n_train", "n_val", "obs_fraction", "cache_data", "T", "n_steps")
    cfg = dict(cfg)
    cfg["data"] = {**{k: cfg["data"][k] for k in keep},
                   "process_type": process,
                   "obs_only": supports_obs_only(process),
                   **chip_smoke.FAMILY_PARAMS[process]}
    cfg["experiment_name"] += f"_{process}"
    if process.endswith("_nd"):
        del cfg["input_dim"], cfg["output_dim"]
    return cfg


def test_chip_smoke_recipe_configs_are_unchanged():
    cs = chip_smoke
    assert cs.default_config(5, "a") == _old_default_config(5, "a")
    assert cs.production_config(3, "b") == _old_production_config(3, "b")
    assert cs.scaled_config(2, "c") == _old_scaled_config(2, "c")
    assert cs.scaled_bf16_config(2, "d") == dict(
        _old_scaled_config(2, "d"), compute_dtype="bfloat16")
    assert cs.forced_default_config(3, "e") == dict(
        _old_default_config(3, "e"), use_pallas=True)
    for dt in (0.01, 0.1):
        assert cs.forced_production_config(2, "f", dt=dt) == dict(
            _old_production_config(2, "f"), use_pallas=True,
            grid_walk="off", dt_ode_step=dt)
    for recipe, old in (("default", _old_default_config),
                        ("production", _old_production_config),
                        ("scaled", _old_scaled_config)):
        for process in ("ornstein_uhlenbeck", "heston", "hybrid_ou_bs",
                        "black_scholes_nd", "ornstein_uhlenbeck_nd"):
            new = cs.family_config(recipe, 4, recipe, process)
            # the hybrid CLI adds its --exact-hybrid-truths flag, off, which
            # is run_experiment's default for a config without the key
            assert new.pop("exact_hybrid_truths", False) is False
            assert new == _old_family_config(old(4, recipe), process), (
                recipe, process)


@pytest.mark.parametrize("recipe,script", [
    ("production", "run_black_scholes.sh"),
    ("scaled", "run_scaled_sweep.sh")])
def test_chip_smoke_recipe_flags_are_the_scripts(recipe, script):
    flags = script_flags(script)
    i = flags.index("--n-epochs")
    assert chip_smoke.RECIPE_FLAGS[recipe] == flags[:i] + flags[i + 2:]
