"""Data parallelism of the port (njode_tpu_torch/parallel/, the Trainer's
mesh route) on the CPU, held against the single-process port and against
the JAX package's ``Trainer(mesh=make_mesh(data=2))``.

One spawned world of two gloo ranks (``parallel.launch``, the rank bodies
in tests/torch_parallel_ranks.py, which import no JAX) runs every case
once, for the whole module; each test reads its part.  Tolerances: the
2-rank Trainer against the single-process port at rtol 1e-5 / atol 1e-7
(JAX's ``test_dp_matches_single_device``: the shards' sums in another
order); against the JAX Trainer at tests/test_torch_training.py's (losses
rtol 2e-5, parameters rtol 1e-4 / atol 2e-6); replicas, uneven minibatches
and resumes bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from njode_tpu import NeuralJumpODE as JaxModel
from njode_tpu.parallel import make_mesh as jax_make_mesh
from njode_tpu.utils.training import Trainer as JaxTrainer
from njode_tpu.utils.training import make_adam as jax_make_adam
from njode_tpu_torch.parallel import launch, make_batch_sharder, make_mesh
from njode_tpu_torch.utils import load_checkpoint, state_dict_from_jax

DP_TOL = dict(rtol=1e-5, atol=1e-7)
LOSS_TOL = dict(rtol=2e-5)
STATE_TOL = dict(rtol=1e-4, atol=2e-6)
BRIDGE = dict(num_moments=2, shared_network=False, n_hidden_layers=1)
WORLD_TIMEOUT_S = 240.0


@pytest.fixture(scope="module")
def jax_init():
    """The JAX model's initial parameters, a host copy."""
    model = JaxModel(input_dim=1, hidden_dim=R.H, output_dim=1,
                     num_moments=2, use_pallas=False)
    params = model.init(jax.random.PRNGKey(11))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def init_state(jax_init):
    return state_dict_from_jax(jax_init, **BRIDGE)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("ckpt")


@pytest.fixture(scope="module")
def world(init_state, ckpt_dir):
    """Both ranks' results of tests/torch_parallel_ranks.py
    ``parallel_cases``."""
    return launch(R.parallel_cases, 2, args=(init_state, str(ckpt_dir)),
                  devices=["cpu", "cpu"], timeout=WORLD_TIMEOUT_S)


def single(init_state, batch_size=R.BS, n_epochs=3, **model_kw):
    """The single-process port on the same data and weights."""
    tr = R.trainer_from(init_state, model_kw=model_kw)
    hist, text = R.train_fixed(tr, n_epochs=n_epochs, batch_size=batch_size)
    return hist, R.state_of(tr), text


def assert_states(a, b, exact=False, **tol):
    assert a.keys() == b.keys()
    for k in a:
        if exact:
            assert torch.equal(a[k], b[k]), k
        else:
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(),
                                       err_msg=k, **tol)


def test_make_mesh_shapes_and_errors(world):
    """The mesh over 2 ranks (tests/test_parallel.py:17-22), JAX's "needs N
    devices" message, a 1 x 2 mesh (the model axis) over the same ranks;
    in one process the mesh is 1 x 1 and a mesh of 2 needs a world of 2,
    on either axis."""
    for rank, res in enumerate(world):
        shape, ranks, backend, device = res["mesh"]
        assert shape == {"data": 2, "model": 1}
        assert ranks == (rank, rank) and backend == "gloo"
        assert device == "cpu"
    errs = world[0]["mesh_errors"]
    assert errs["too_few"] == "ValueError: mesh 4x1 needs 4 devices, have 2"
    assert errs["model_axis"] is None
    assert "needs a world of 1 ranks" in errs["world"]
    one = make_mesh(devices=["cpu"])
    assert one.shape == {"data": 1, "model": 1} and one.rank == 0
    with pytest.raises(ValueError, match="needs a world of 2 ranks"):
        make_mesh(data=2, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="mesh 1x2 needs a world of 2"):
        make_mesh(model=2, devices=["cpu"] * 2)


def test_sharder_keeps_whole_arrays_the_axis_does_not_divide():
    """make_batch_sharder without a group: a 1-rank mesh keeps every row
    (as JAX's test_uneven_batch_falls_back keeps 10 rows on 8 devices)."""
    shard = make_batch_sharder(make_mesh(devices=["cpu"]))
    x = torch.ones(10, 3)
    assert torch.equal(shard(x), x)


@pytest.mark.parametrize("case,batch_size,reductions", [
    ("full", None, 3), ("ragged", R.BS, 9)])
def test_dp_matches_single_process(world, init_state, case, batch_size,
                                   reductions):
    """3 epochs on 2 ranks against the single-process port: the full batch
    (JAX's test_dp_matches_single_device), and minibatches of 16 over 40
    rows, whose last holds 8 valid rows, all on rank 0: the loss is the
    global masked mean (each rank's sum over the global valid count), so
    per-epoch and validation losses and the parameters agree; one gradient
    all-reduce a step."""
    hist, state = world[0][case][:2]
    ref_hist, ref_state, _ = single(init_state, batch_size)
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(hist[key], ref_hist[key], **DP_TOL)
    assert_states(state, ref_state, **DP_TOL)
    assert world[0][case][2] == world[1][case][2] == reductions


def test_a_mean_of_shard_means_fails_the_ragged_case(init_state):
    """The ragged case tells the global mean from a mean of the shards'
    means: on the last minibatch (rows 32-47, 8 valid, all on rank 0) the
    latter is half the single-process loss."""
    tr = R.trainer_from(init_state)
    times, values = (torch.as_tensor(a) for a in R.make_data())
    idx, valid = tr._minibatches(0, R.NT, R.BS, shuffle=False)
    ids, vm = idx[-1], valid[-1]
    t, v, m = times[ids], values[ids], torch.ones(R.BS, R.N, dtype=bool)
    with torch.no_grad():
        whole = float(tr._loss(t, v, m, traj_mask=vm))
        halves = [float(tr._loss(t[s], v[s], m[s], traj_mask=vm[s]))
                  for s in (slice(0, 8), slice(8, 16))]
    assert vm[:8].all() and not vm[8:].any()
    assert np.isclose(np.mean(halves), whole / 2, rtol=1e-6)


def test_dp_matches_jax_mesh_trainer(world, jax_init):
    """The 2-rank Trainer against the JAX Trainer on a 2-device data mesh,
    from the same weights (through the bridge), 3 epochs of minibatches of
    16 with a padded last one, shuffle off."""
    times, values = R.make_data()
    vt, vv = R.make_data(12, seed=1)
    model = JaxModel(input_dim=1, hidden_dim=R.H, output_dim=1,
                     num_moments=2, use_pallas=False)
    trainer = JaxTrainer(model, jax_make_adam(R.LR, R.WD),
                         ignore_first_continuity=True,
                         moment_weights=R.MW, seed=5,
                         mesh=jax_make_mesh(data=2))
    trainer.params = jax.tree_util.tree_map(jnp.asarray, jax_init)
    trainer.opt_state = trainer.optimizer.init(trainer.params)
    trainer._place_state()
    ref = trainer.train(lambda: (jnp.asarray(times), jnp.asarray(values)),
                        lambda: (jnp.asarray(vt), jnp.asarray(vv)),
                        n_epochs=3, batch_size=R.BS, shuffle=False,
                        print_every=1)
    hist, state = world[0]["ragged"][:2]
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(hist[key], ref[key], **LOSS_TOL)
    ref_state = state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, trainer.params), **BRIDGE)
    assert_states(state, ref_state, **STATE_TOL)


def test_uneven_minibatch_is_held_whole(world, init_state):
    """A minibatch of 15 rows on 2 ranks: every rank holds it whole (JAX's
    test_uneven_batch_falls_back), nothing is reduced, and the run is the
    single-process one bitwise (the validation batch of 12 rows still
    splits, its losses at the data-parallel tolerance)."""
    hist, state, reductions = world[0]["uneven"]
    ref_hist, ref_state, _ = single(init_state, batch_size=15)
    assert reductions == 0
    assert hist["train_loss"] == ref_hist["train_loss"]
    np.testing.assert_allclose(hist["val_loss"], ref_hist["val_loss"],
                               **DP_TOL)
    assert_states(state, ref_state, exact=True)


@pytest.mark.parametrize("case", ["full", "ragged", "uneven", "dropout",
                                  "pallas_step", "pallas_True",
                                  "resume_msgpack", "resume_orbax"])
def test_replicas_stay_bitwise_equal(world, case):
    """Every rank takes the same Adam step: the parameters of both ranks
    are bitwise equal after training, and so are the losses they
    report."""
    assert_states(world[0][case][1], world[1][case][1], exact=True)
    assert world[0][case][0]["train_loss"] == world[1][case][0]["train_loss"]


def test_dropout_ranks_draw_different_masks(world):
    """Where the ranks split the rows, each draws its dropout from a stream
    of (seed, epoch, rank); where each holds every row, from the same
    stream (so the replicas stay equal unreduced)."""
    d0, d1 = world[0]["dropout_draws"], world[1]["dropout_draws"]
    assert not torch.equal(d0["sharded"], d1["sharded"])
    assert not torch.equal(d0["sharded"], d0["whole"])
    assert torch.equal(d0["whole"], d1["whole"])
    assert np.isfinite(world[0]["dropout"][0]["train_loss"]).all()


@pytest.mark.parametrize("mode,label", [
    ("step", "composed (fused-step kernels), data-parallel over 2 ranks"),
    (True, "composed (forced fused Euler cell), data-parallel over 2 ranks")])
def test_kernel_modes_under_two_ranks(world, init_state, mode, label):
    """use_pallas "step" and True on 2 ranks (the kernels' plain versions
    on the CPU) against the same mode in one process; the path line names
    the route, and the kernel report is printed once."""
    hist, state, text = world[0][f"pallas_{mode}"]
    ref_hist, ref_state, _ = single(init_state, n_epochs=2,
                                    use_pallas=mode)
    assert label in text and text.count("Kernels: ") == 1
    np.testing.assert_allclose(hist["train_loss"], ref_hist["train_loss"],
                               **DP_TOL)
    assert_states(state, ref_state, **DP_TOL)


@pytest.mark.parametrize("backend", ["msgpack", "orbax"])
def test_resume_under_two_ranks(world, backend, tmp_path_factory):
    """2 epochs, then a third from the checkpoint (a file written by rank 0,
    or a torch.distributed.checkpoint directory written by both), equal
    the uninterrupted 3 epochs bitwise."""
    hist, state, text = world[0][f"resume_{backend}"]
    full_hist, full_state = world[0]["ragged"][:2]
    assert "Resuming from epoch 2" in text and "(resumed)" in text
    assert hist["train_loss"] == full_hist["train_loss"]
    assert hist["val_loss"] == full_hist["val_loss"]
    assert_states(state, full_state, exact=True)


def test_a_dcp_directory_loads_in_one_process(world, ckpt_dir, init_state,
                                              tmp_path):
    """The "orbax" backend's directory that both ranks wrote loads in this
    one process through load_checkpoint, which tells it from a file: the
    ranks' last state and histories.  One written by one process loads
    back bitwise too, Adam state included, and either backend replaces the
    other."""
    from njode_tpu_torch.utils import save_checkpoint
    sd, _, hist = load_checkpoint(str(ckpt_dir / "orbax" / "model.ckpt"))
    assert (ckpt_dir / "orbax" / "model.ckpt").is_dir()
    assert_states(sd, world[0]["resume_orbax"][1], exact=True)
    assert hist["train_losses"] == world[0]["resume_orbax"][0]["train_loss"]
    tr = R.trainer_from(init_state, checkpoint_backend="orbax")
    path = str(tmp_path / "model.ckpt")
    R.train_fixed(tr, n_epochs=2, save_path=path)
    assert (tmp_path / "model.ckpt").is_dir()
    sd, osd, hist = load_checkpoint(path)
    assert_states(sd, R.state_of(tr), exact=True)
    assert len(hist["train_losses"]) == 2
    fresh = R.trainer_from(None)
    fresh.optimizer.load_state_dict(osd)
    for (a, b) in zip(fresh.optimizer.state_dict()["state"].values(),
                      tr.optimizer.state_dict()["state"].values()):
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a[k], b[k])
    # the single file replaces the directory, and back
    save_checkpoint(path, sd, osd, hist)
    assert (tmp_path / "model.ckpt").is_file()
    save_checkpoint(path, sd, osd, hist, backend="orbax")
    assert (tmp_path / "model.ckpt").is_dir()


def test_backend_choice():
    """NCCL where every rank has a card of its own, gloo where ranks share
    one or run on the CPU; NCCL on a shared card raises."""
    from njode_tpu_torch.parallel import choose_backend
    assert choose_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert choose_backend(["cuda:0", "cuda:0"]) == "gloo"
    assert choose_backend(["cpu", "cpu"]) == "gloo"
    assert choose_backend(["cuda:0", "cuda:1"], "gloo") == "gloo"
    with pytest.raises(ValueError, match="card of its own"):
        choose_backend(["cuda:0", "cuda:0"], "nccl")
    with pytest.raises(ValueError, match="card of its own"):
        choose_backend(["cpu"], "nccl")


@pytest.mark.parametrize("fn,timeout,error,match", [
    (R.fails_on_rank_one, WORLD_TIMEOUT_S, RuntimeError,
     "(?s)rank 1:.*rank one fails here"),
    (R.never_returns, 3.0, TimeoutError, "exit code")])
def test_launch_fails_a_failing_or_hung_world(fn, timeout, error, match):
    """A rank that raises fails the call with its traceback, the other
    rank killed; a world past its deadline is killed and raises."""
    with pytest.raises(error, match=match):
        launch(fn, 2, devices=["cpu", "cpu"], timeout=timeout)


def test_launch_without_a_deadline_lets_the_ranks_finish():
    """Without ``timeout`` (run_experiment's spawn) the ranks run as long as
    they need: a world that outlasts the deadline that kills
    ``never_returns`` above returns its results."""
    assert launch(R.sleeps, 2, args=(4.0,), devices=["cpu", "cpu"]) == \
        [4.0, 4.0]
