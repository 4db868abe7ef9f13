"""Scale-out around the Trainer on the CPU: ensembles over ranks,
``run_experiment``'s mesh route, ``initialize_distributed`` and the kernel
report (njode_tpu_torch/parallel/, utils/ensemble.py, ops/report.py), held
against the single-process port and the JAX package.

One spawned world of two gloo ranks (tests/torch_parallel_ranks.py
``distributed_cases``, no JAX in the ranks) serves the module.  Ensembles
over ranks are bitwise the single-process ensemble (each member keeps the
streams of its index); ``run_experiment(data_parallel=2)`` on fixed data
and weights matches the JAX package's at tests/test_torch_training.py's
loss tolerance (rtol 2e-5).
"""

import json
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_parallel_ranks as R
from njode_tpu import NeuralJumpODE as JaxModel
from njode_tpu.ops.report import kernel_report as jax_kernel_report
from njode_tpu.parallel import distributed as jax_distributed
from njode_tpu.parallel import make_mesh as jax_make_mesh
from njode_tpu.utils import training as jax_training
from njode_tpu_torch import NeuralJumpODE
from njode_tpu_torch.ops.report import kernel_report
from njode_tpu_torch.parallel import (global_mesh, initialize_distributed,
                                     launch, make_mesh)
from njode_tpu_torch.utils import Trainer, run_experiment, state_dict_from_jax
from njode_tpu_torch.utils import training as T
from njode_tpu_torch.utils.ensemble import (shard_ensemble,
                                            train_ensemble_full,
                                            train_population)

ENS_MODEL_KW = dict(input_dim=1, hidden_dim=8, output_dim=1, num_moments=2,
                    n_hidden_layers=1)
ENS_TRAIN_KW = dict(n_epochs=2, n_trajectories=32, batch_size=16,
                    obs_fraction=0.2, n_val=8, n_steps=20, T=1.0, mu=0.1,
                    sigma=0.5, x0=1.0)
BRIDGE = dict(num_moments=2, shared_network=False, n_hidden_layers=1)
LOSS_TOL = dict(rtol=2e-5)
LAUNCH_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID",
              "OMPI_COMM_WORLD_SIZE")


def dp_config(**over):
    """tests/test_parallel.py's test_dp_chunked_run_experiment config, on
    the CPU, shuffle off (the packages shuffle from different
    generators)."""
    cfg = dict(
        experiment_name="dp_bs", input_dim=1, hidden_dim=8, output_dim=1,
        learning_rate=1e-2, weight_decay=0.0, n_epochs=4, batch_size=8,
        print_every=2, num_moments=2, moment_weights=[1.0, 10.0],
        ignore_first_continuity=True, seed=0, data_seed=0, shuffle=False,
        device="cpu", data_parallel=2,
        data=dict(process_type="black_scholes", n_train=16, n_val=8,
                  obs_fraction=0.1, cache_data=False, mu=0.1, sigma=0.5,
                  T=1.0, n_steps=30, x0=1.0))
    cfg.update(over)
    return cfg


def fixed_data():
    return R.make_data(16, seed=3, n_slots=4), R.make_data(8, seed=4,
                                                            n_slots=4)


def dp_init_state(cfg):
    init = JaxModel(input_dim=1, hidden_dim=8, output_dim=1,
                    num_moments=2).init(
        jax.random.fold_in(jax.random.PRNGKey(cfg["seed"]), 0))
    return state_dict_from_jax(init, **BRIDGE)


def ens_config(**over):
    """tests/test_torch_ensemble.py's ens_config with K=4 over 2 ranks and
    the torch.distributed.checkpoint directory."""
    cfg = dict(
        experiment_name="ens_dp", input_dim=1, hidden_dim=8, output_dim=1,
        n_hidden_layers=1, activation="relu", learning_rate=1e-2,
        weight_decay=5e-4, n_epochs=4, batch_size=16, shuffle=True,
        print_every=2, ignore_first_continuity=True, num_moments=2,
        moment_weights=[1.0, 10.0], ensemble=4, seed=0, data_seed=0,
        device="cpu", data_parallel=2, checkpoint_backend="orbax",
        data=dict(process_type="black_scholes", n_train=32, n_val=16,
                  obs_fraction=0.2, cache_data=False, obs_only=True,
                  mu=0.1, sigma=0.5, T=1.0, n_steps=20, x0=1.0))
    cfg.update(over)
    return cfg


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cfg = dp_config()
    return launch(R.distributed_cases, 2,
                  args=(ENS_MODEL_KW, ENS_TRAIN_KW, cfg, dp_init_state(cfg),
                        fixed_data(), str(tmp_path_factory.mktemp("runs")),
                        ens_config()),
                  devices=["cpu", "cpu"], timeout=240.0)


def assert_ensembles_equal(a, b):
    (sa, oa, ha), (sb, ob, hb) = a, b
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert ha.keys() == hb.keys()
    for k in ha:
        assert torch.equal(ha[k], hb[k]), k
    assert len(oa) == len(ob)
    for x, y in zip(oa, ob):
        assert x["param_groups"] == y["param_groups"]
        for i in y["state"]:
            for key in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(x["state"][i][key].cpu(),
                                   y["state"][i][key].cpu())


@pytest.mark.parametrize("k", [4, 3])
def test_ensemble_over_ranks_is_the_single_process_ensemble(world, k):
    """train_ensemble_full over 2 ranks: K=4 trains two members a rank, K=3
    (the axis does not divide it) all three on each; either way every
    rank returns the stack, the Adam states and the (epochs, K) loss rows
    of the single-process ensemble, bitwise."""
    ref = train_ensemble_full(NeuralJumpODE(device="cpu", **ENS_MODEL_KW),
                              "black_scholes", n_seeds=k, **ENS_TRAIN_KW)
    for rank in (0, 1):
        assert_ensembles_equal(world[rank][k], ref)
    assert world[0][k][2]["train"].shape == (2, k)


def test_population_over_ranks(world):
    """A population (per-member learning rates) takes the same route."""
    ref = train_population(NeuralJumpODE(device="cpu", **ENS_MODEL_KW),
                           "black_scholes", R.POP_LRS, **ENS_TRAIN_KW)
    assert_ensembles_equal(world[0]["population"], ref)
    lrs = [g["param_groups"][0]["lr"] for g in world[1]["population"][1]]
    assert lrs == R.POP_LRS


def test_ensemble_experiment_over_ranks_resumes_from_a_dcp_directory(
        world, tmp_path):
    """run_experiment --ensemble 4 --data-parallel 2 with the "orbax"
    checkpoints, 2 epochs then resumed to 4 (each rank writes its part of
    the directory, rank 0 the history): the stack and the member rows of
    one process's uninterrupted run, bitwise; the directory loads here."""
    from njode_tpu_torch.utils import load_checkpoint
    ref = run_experiment(ens_config(data_parallel=0,
                                    checkpoint_backend="msgpack"),
                         save_dir=str(tmp_path))
    res = world[0]["ensemble_experiment"]
    assert "Resuming 4-member ensemble from epoch 2" in \
        world[0]["ensemble_text"]
    for k in ("member_train_loss", "member_val_loss",
              "member_relative_loss"):
        assert res["history"][k] == ref["history"][k], k
    for k, v in ref["params_stack"].items():
        assert torch.equal(res["params_stack"][k], v), k
        assert torch.equal(world[1]["ensemble_experiment"]["params_stack"][k],
                           v), k
    stack, opt_states, _ = load_checkpoint(
        os.path.join(res["save_path"], "model.ckpt"))
    assert os.path.isdir(os.path.join(res["save_path"], "model.ckpt"))
    assert len(opt_states) == 4
    for k, v in ref["params_stack"].items():
        assert torch.equal(stack[k], v), k


def test_shard_ensemble_cuts_the_seed_axis():
    """One process: a 1-rank mesh keeps every member (the JAX package's
    replicate rule for what the axis does not divide)."""
    stack = {"w": torch.arange(12.).reshape(4, 3)}
    mesh = make_mesh(devices=["cpu"])
    assert shard_ensemble(mesh, stack) is stack
    assert shard_ensemble(mesh, [1, 2, 3]) == [1, 2, 3]


def test_ensemble_that_the_ranks_do_not_divide_raises_as_jax(tmp_path):
    """--ensemble 3 beside --data-parallel 2: the JAX package's message,
    before any rank starts."""
    cfg = dp_config(ensemble=3)
    with pytest.raises(ValueError) as ours:
        run_experiment(cfg, save_dir=str(tmp_path / "port"))
    with pytest.raises(ValueError) as ref:
        jax_training.run_experiment(
            {k: v for k, v in cfg.items() if k != "device"},
            save_dir=str(tmp_path / "jax"))
    assert str(ours.value) == str(ref.value)
    assert "cannot shard over 2 devices" in str(ours.value)


def test_run_experiment_data_parallel_matches_jax(world, tmp_path,
                                                  monkeypatch):
    """run_experiment(data_parallel=2) inside the 2-rank group against the
    JAX package's run_experiment(data_parallel=2) on the same fixed data
    and initial weights: per-epoch train, validation and relative losses;
    rank 0 alone prints and writes the run's files."""
    (tt, tv), (vt, vv) = fixed_data()
    monkeypatch.setattr(jax_training, "create_data_loaders", lambda **kw: (
        lambda: (jnp.asarray(tt), jnp.asarray(tv)),
        lambda: (jnp.asarray(vt), jnp.asarray(vv))))
    cfg = {k: v for k, v in dp_config().items() if k != "device"}
    ref = jax_training.run_experiment(cfg, save_dir=str(tmp_path))["history"]
    ours = world[0]["experiment"]["history"]
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(ours[key], ref[key], **LOSS_TOL)
    np.testing.assert_allclose(ours["relative_loss"], ref["relative_loss"],
                               rtol=1e-4)
    assert world[1]["experiment"]["history"]["train_loss"] == \
        ours["train_loss"]
    text = world[0]["experiment_text"]
    assert ("Distributed: 2 ranks (data axis 2, model axis 1), backend "
            "gloo, rank 0 on cpu") in text
    assert text.count("Kernels: ") == 1
    assert world[1]["experiment_text"] == ""
    run = os.path.join(world[0]["experiment"]["save_path"])
    saved = json.loads(open(os.path.join(run, "config.json")).read())
    assert saved["data_parallel"] == 2
    assert os.path.isfile(os.path.join(run, "history.json"))


def test_initialize_distributed_inside_a_group_returns_the_rank(world):
    assert [w["rank"] for w in world] == [0, 1]


@pytest.fixture
def clean_env(monkeypatch):
    for var in LAUNCH_ENV:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_initialize_distributed_single_process_note(clean_env, capsys):
    """No arguments and no launcher: a single process goes on, with one
    note, as the JAX package's does off a pod."""
    assert initialize_distributed() == 0
    assert not dist.is_initialized()
    assert "single-process mode" in capsys.readouterr().err


def test_initialize_distributed_raises_where_it_looks_multihost(clean_env):
    """SLURM_NTASKS=2 without a rendezvous: every process would train alone
    as rank 0, so it raises (the JAX package's _looks_multihost)."""
    clean_env.setenv("SLURM_NTASKS", "2")
    assert jax_distributed._looks_multihost()
    with pytest.raises(RuntimeError, match="looks multi-host"):
        initialize_distributed()


@pytest.mark.parametrize("route", ["explicit", "torchrun", "slurm"])
def test_initialize_distributed_joins_a_group(clean_env, route):
    """Explicit coordinator address, process count and id (a tcp://
    rendezvous), torchrun's environment, or SLURM's (no LOCAL_WORLD_SIZE):
    a world of one joins over gloo (no card here); a second call returns
    the rank.  Explicit arguments go together.  global_mesh() then spans
    the world, each rank on the device its launcher set: the CPU here, the
    current card where there is one."""
    port = free_port()
    env = {"torchrun": (("WORLD_SIZE", "1"), ("RANK", "0"),
                        ("LOCAL_RANK", "0")),
           "slurm": (("SLURM_NTASKS", "1"), ("SLURM_PROCID", "0"),
                     ("SLURM_LOCALID", "0"))}
    try:
        if route == "explicit":
            with pytest.raises(ValueError, match="go together"):
                initialize_distributed(f"127.0.0.1:{port}")
            assert initialize_distributed(f"127.0.0.1:{port}", 1, 0) == 0
        else:
            for var, val in (("MASTER_ADDR", "127.0.0.1"),
                             ("MASTER_PORT", str(port))) + env[route]:
                clean_env.setenv(var, val)
            assert initialize_distributed() == 0
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        assert initialize_distributed() == 0
        mesh = global_mesh()
        assert mesh.shape == {"data": 1, "model": 1}
        assert (mesh.device, mesh.backend) == (torch.device("cpu"), "gloo")
        clean_env.setattr(torch.cuda, "is_available", lambda: True)
        clean_env.setattr(torch.cuda, "current_device", lambda: 3)
        assert global_mesh().device == torch.device("cuda", 3)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_run_experiment_spawns_its_ranks_without_a_deadline(tmp_path,
                                                            monkeypatch):
    """--data-parallel 2 without a group spawns its ranks with no wall
    deadline, so a long run is not killed partway; a hung collective still
    fails after the process group's timeout."""
    import njode_tpu_torch.parallel as P
    real, seen = P.launch, []

    def spy(fn, n, **kw):
        seen.append(kw.get("timeout"))
        return real(fn, n, **kw)
    monkeypatch.setattr(P, "launch", spy)
    res = run_experiment(dp_config(n_epochs=1), save_dir=str(tmp_path))
    assert seen == [None]
    assert len(res["history"]["train_loss"]) == 1


# ------------------------------------------------------------ kernel report

REPORT_MODELS = [
    dict(),
    dict(use_pallas="step"),
    dict(use_pallas=True),
    dict(use_pallas=True, dt_ode_step=0.01),
    dict(dt_ode_step=0.01, grid_walk=True, shared_network=True),
    dict(dt_ode_step=0.01, grid_walk=True, use_pallas=True),
    dict(use_pallas="step", dropout_rate=0.1),
    dict(use_pallas=False, dt_ode_step=0.01),
]


@pytest.mark.parametrize("kw", REPORT_MODELS,
                         ids=[str(k) for k in REPORT_MODELS])
def test_kernel_report_decisions_follow_the_routes(kw):
    """Each on/off in the line is the predicate the model routes by."""
    model = NeuralJumpODE(1, 16, 1, num_moments=2, device="cpu", **kw)
    line = kernel_report(model, n_rows=64, n_slots=5, train_kernel="x")
    assert line.startswith("Kernels: ") and "\n" not in line
    assert ("walk=on" in line) == bool(model.grid_walk
                                       and model._use_walk_kernel())
    assert ("step=on" in line) == model._use_fused_step(5, 64)
    assert ("cell=on" in line) == model._use_fused()
    assert ("gap=on" in line) == bool(model.dt_ode_step is not None
                                      and model._use_gap_scan())
    assert ("gap=inference-only" in line) == bool(
        model.dt_ode_step is not None and not model._use_gap_scan()
        and model._use_gap_scan(inference=True))
    assert "train=off (x)" in line


SHARED_REASONS = [
    (dict(use_pallas="step", dropout_rate=0.1), "step=off (dropout unsupported)"),
    (dict(use_pallas="step", dt_ode_step=0.01),
     "step=off (--dt-ode-step set (substep gaps ride the walk kernel))"),
    (dict(), "walk=off (no --dt-ode-step (gaps are single Euler steps "
             "already))"),
    (dict(dt_ode_step=0.01, grid_walk=True, n_hidden_layers=2),
     "walk=off (n_hidden_layers 2 != 1)"),
    (dict(dt_ode_step=0.01, grid_walk=True, dropout_rate=0.1),
     "walk=off (dropout unsupported)"),
]


@pytest.mark.parametrize("kw,reason", SHARED_REASONS,
                         ids=[r for _, r in SHARED_REASONS])
def test_kernel_report_shares_the_jax_reasons(kw, reason):
    """The configuration-eligibility reasons both packages give read the
    same; the whole-run kernels' reason passes through as in JAX."""
    ours = kernel_report(NeuralJumpODE(1, 16, 1, num_moments=2,
                                       device="cpu", **kw),
                         n_rows=64, n_slots=5,
                         train_kernel="data/model-parallel meshes "
                                      "unsupported")
    ref = jax_kernel_report(JaxModel(1, 16, 1, num_moments=2, **kw),
                            n_rows=64, n_slots=5,
                            train_kernel="data/model-parallel meshes "
                                         "unsupported")
    assert reason in ours and reason in ref, (ours, ref)
    part = "train=off (data/model-parallel meshes unsupported)"
    assert part in ours and part in ref


def test_a_mesh_declines_the_whole_run_kernels_with_the_jax_reason(capsys):
    """Under a mesh the whole-run kernel and its walk twin decline: "auto"
    (the gate on a card) goes composed, the report says why, and True
    raises, with the JAX package's reason; the grid walk resolves off
    beside a mesh, as there.  Trainer.train prints one report a call."""
    mesh = make_mesh(devices=["cpu"])
    model = NeuralJumpODE(1, 16, 1, num_moments=2, device="cpu")
    auto = Trainer(model, mesh=mesh, ignore_first_continuity=True,
                   use_train_kernel="auto")
    auto.device = torch.device("cuda")      # the gate alone; no CUDA tensor
    assert auto._use_kernel(16, 5) is False
    reason = auto._kernel_decline(16, 5)
    assert reason == "data/model-parallel meshes unsupported"
    jax_trainer = jax_training.Trainer(
        JaxModel(1, 16, 1, num_moments=2), ignore_first_continuity=True,
        mesh=jax_make_mesh(data=2), use_train_kernel=True,
        train_kernel_opts=dict(lr=1e-3, weight_decay=0.0))
    with pytest.raises(ValueError) as ref:
        jax_trainer._train_kernel_check(16)
    assert str(ref.value).split(": ", 1)[1] == reason
    forced = Trainer(model, mesh=mesh, ignore_first_continuity=True,
                     use_train_kernel=True)
    with pytest.raises(ValueError, match="meshes unsupported"):
        forced._use_kernel(16, 5)
    walk = NeuralJumpODE(1, 16, 1, num_moments=2, shared_network=True,
                         dt_ode_step=0.01, grid_walk=True, device="cpu")
    with pytest.raises(ValueError, match="meshes unsupported"):
        Trainer(walk, mesh=mesh, ignore_first_continuity=True,
                use_train_kernel=True)._walk_train_check(16, 5)
    cfg = dict(dt_ode_step=0.01, shared_network=True, hidden_dim=16,
               data=dict(T=1.0, n_steps=100))
    cuda = torch.device("cuda")
    assert T._resolve_grid_walk(cfg, cuda, "auto") is True
    assert T._resolve_grid_walk(cfg, cuda, "auto",
                                single_device=False) is False
    assert jax_training._resolve_grid_walk(
        cfg, "tpu", single_device=False, use_pallas_cfg="auto") is False
    capsys.readouterr()
    tr = R.trainer_from(None)
    times, values = R.make_data()
    tr.train(lambda: (times, values), n_epochs=1, batch_size=R.BS)
    tr.train(lambda: (times, values), n_epochs=2, batch_size=R.BS)
    assert capsys.readouterr().out.count("Kernels: ") == 2
