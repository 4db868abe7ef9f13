"""The mesh's model axis of the port (njode_tpu_torch/parallel/model_axis.py,
``Trainer(model_shard=...)``, ``run_experiment(model_parallel=...)``) on
the CPU, held against the single-process port and against the JAX
package's ``make_mesh(model=M)`` with ``shard_params(moment_axis /
hidden_axis)``, ``Trainer(model_shard=...)`` and ``run_experiment``.

Two spawned worlds of gloo ranks (``parallel.launch``, the rank bodies in
tests/torch_model_axis_ranks.py, which import no JAX) run every case once:
a 1 x 2 mesh and a world of four (a 2 x 2 mesh, a 1 x 4 mesh).
Tolerances: against the JAX package, ``apply`` at its
tests/test_parallel.py:45-63 limits (rtol 1e-5, atol 1e-6), gradients at
its ``test_hidden_axis_tp_sharding`` limits (rtol 1e-4, atol 1e-6), losses
at rtol 1e-5 and parameters at tests/test_torch_training.py's (rtol 1e-4,
atol 2e-6); against the single-process port, "hidden" bitwise (the same
whole-network forward, Adam elementwise on the blocks) and "moments" at
the data axis's rtol 1e-5 / atol 1e-7: each rank's autograd graph holds
its networks alone, so a weight reached by two paths (the after-jump
readout and the integrated gap) sums its contributions in another order.
Resumes under the mesh are bitwise.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_model_axis_ranks as MA
import torch_parallel_ranks as R
from njode_tpu import NeuralJumpODE as JaxModel
from njode_tpu.models import nj_ode_loss_dense as jax_loss_dense
from njode_tpu.parallel import make_batch_sharder as jax_batch_sharder
from njode_tpu.parallel import make_mesh as jax_make_mesh
from njode_tpu.parallel import shard_params as jax_shard_params
from njode_tpu.utils import training as jax_training
from njode_tpu.utils.training import Trainer as JaxTrainer
from njode_tpu.utils.training import make_adam as jax_make_adam
from njode_tpu_torch import NeuralJumpODE
from njode_tpu_torch.parallel import launch
from njode_tpu_torch.utils import run_experiment
from njode_tpu_torch.utils import state_dict_from_jax
from njode_tpu_torch.utils.ensemble import train_ensemble_full

APPLY_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_TOL = dict(rtol=1e-5)
STATE_TOL = dict(rtol=1e-4, atol=2e-6)
DP_TOL = dict(rtol=1e-5, atol=1e-7)
SEP = dict(num_moments=2, shared_network=False, n_hidden_layers=1)
SHARED = dict(num_moments=2, shared_network=True, n_hidden_layers=1)
ENS_MODEL_KW = dict(input_dim=1, hidden_dim=8, output_dim=1, num_moments=2,
                    n_hidden_layers=1)
ENS_TRAIN_KW = dict(n_epochs=2, n_trajectories=16, batch_size=8,
                    obs_fraction=0.2, n_val=8, n_steps=20, T=1.0, mu=0.1,
                    sigma=0.5, x0=1.0)
WORLD_TIMEOUT_S = 300.0


def ep_config(**over):
    """JAX's EP config (tests/multihost_worker.py:128-145) on the CPU, one
    process's 1 x 2 mesh spawned by run_experiment, shuffle off."""
    cfg = dict(
        experiment_name="mp_ep", input_dim=1, hidden_dim=16, output_dim=1,
        n_hidden_layers=1, activation="relu", num_moments=2,
        moment_weights=[1.0, 10.0], ignore_first_continuity=True,
        learning_rate=1e-3, weight_decay=5e-4, n_epochs=2, batch_size=None,
        print_every=2, model_parallel=2, model_parallel_mode="moments",
        checkpoint_backend="orbax", seed=0, data_seed=0, shuffle=False,
        device="cpu",
        data=dict(process_type="black_scholes", n_train=32, n_val=16,
                  obs_fraction=0.2, cache_data=False, T=1.0, n_steps=20,
                  mu=0.1, sigma=0.5, x0=1.0))
    cfg.update(over)
    return cfg


EXPERIMENTS = {"moments": ep_config(),
               "hidden": ep_config(experiment_name="mp_tp",
                                   model_parallel_mode="hidden"),
               # --multihost inside the group: global_mesh(model=2), each
               # rank on the device its launcher set
               "multihost": ep_config(experiment_name="mp_mh",
                                      multihost=True, device="auto")}


def fixed_data():
    return R.make_data(32, seed=3, n_slots=4), R.make_data(16, seed=4,
                                                            n_slots=4)


@pytest.fixture(scope="module")
def jax_init():
    model = JaxModel(input_dim=1, hidden_dim=R.H, output_dim=1,
                     num_moments=2, use_pallas=False)
    return jax.tree_util.tree_map(np.asarray,
                                  model.init(jax.random.PRNGKey(11)))


@pytest.fixture(scope="module")
def jax_init16():
    """JAX's test_hidden_axis_tp_sharding model: shared, hidden 16."""
    model = JaxModel(input_dim=1, hidden_dim=MA.H16, output_dim=1,
                     num_moments=2, shared_network=True, use_pallas=False)
    return jax.tree_util.tree_map(np.asarray,
                                  model.init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def init_state(jax_init):
    return state_dict_from_jax(jax_init, **SEP)


@pytest.fixture(scope="module")
def state16(jax_init16):
    return state_dict_from_jax(jax_init16, **SHARED)


def exp_init():
    init = JaxModel(input_dim=1, hidden_dim=16, output_dim=1,
                    num_moments=2).init(
        jax.random.fold_in(jax.random.PRNGKey(0), 0))
    return state_dict_from_jax(init, **SEP)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("model_axis")


@pytest.fixture(scope="module")
def one_ckpt(init_state, workdir):
    """A one-process checkpoint after 2 epochs of minibatches."""
    path = str(workdir / "one" / "model.ckpt")
    R.train_fixed(R.trainer_from(init_state), n_epochs=2, save_path=path)
    return path


@pytest.fixture(scope="module")
def world(init_state, state16, one_ckpt, workdir):
    return launch(MA.two_rank_cases, 2,
                  args=(init_state, state16, one_ckpt, str(workdir),
                        EXPERIMENTS, exp_init(), fixed_data(),
                        ENS_MODEL_KW, ENS_TRAIN_KW),
                  devices=["cpu", "cpu"], timeout=WORLD_TIMEOUT_S)


@pytest.fixture(scope="module")
def world4(init_state, state16):
    return launch(MA.four_rank_cases, 4, args=(init_state, state16),
                  devices=["cpu"] * 4, timeout=WORLD_TIMEOUT_S)


def single(state, n_epochs=3, batch_size=R.BS, **kw):
    tr = R.trainer_from(state, **kw)
    hist, _ = R.train_fixed(tr, n_epochs=n_epochs, batch_size=batch_size)
    return hist, R.state_of(tr), tr.optimizer.state_dict()


def assert_states(a, b, exact=False, **tol):
    assert a.keys() == b.keys()
    for k in a:
        if exact:
            assert torch.equal(a[k], b[k]), k
        else:
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(),
                                       err_msg=k, **tol)


def assert_adam(a, b, exact=False, **tol):
    assert a["state"].keys() == b["state"].keys()
    for i in b["state"]:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            x, y = a["state"][i][k], b["state"][i][k]
            if exact:
                assert torch.equal(x, y), (i, k)
            else:
                np.testing.assert_allclose(x.numpy(), y.numpy(), **tol)


def batch():
    return (torch.as_tensor(a) for a in R.make_data(8, seed=2))


def jax_forward_and_grads(model, params, mesh):
    """JAX's sharded apply and gradients (tests/test_parallel.py:45-131) on
    the rank bodies' batch."""
    times, values = (jnp.asarray(a) for a in R.make_data(8, seed=2))
    mask = jnp.ones(times.shape, bool)
    t, v, m = jax_batch_sharder(mesh)(times, values, mask)

    def loss(p, t, v, m):
        preds, before = model.apply(p, t, v, m)
        return jax_loss_dense(v, preds, before, m,
                              moment_weights=(1.0, 10.0))
    preds, before = jax.jit(model.apply)(params, t, v, m)
    grads = jax.jit(jax.grad(loss))(params, t, v, m)
    return (np.asarray(preds), np.asarray(before),
            jax.tree_util.tree_map(np.asarray, grads))


# ------------------------------------------------------------------- mesh

def test_mesh_coordinates_groups_and_errors(world, world4):
    """A 1 x 2 mesh (rank r at (0, r), the model axis the world), a 2 x 2
    mesh (rank r at (r // 2, r % 2), groups of its own on each axis), JAX's
    "needs N devices" message, and make_mesh(model=2)'s data axis from
    the devices the model axis leaves."""
    for rank, res in enumerate(world):
        shape, r, dr, mr, backend, no_dg, no_mg = res["mesh"]
        assert shape == {"data": 1, "model": 2} and backend == "gloo"
        assert (r, dr, mr) == (rank, 0, rank) and no_dg and no_mg
    assert [w["mesh"] for w in world4] == [(0, 0, 0), (1, 0, 1), (2, 1, 0),
                                           (3, 1, 1)]
    errs = world[0]["mesh_errors"]
    assert errs["too_few"] == "mesh 2x2 needs 4 devices, have 2"
    with pytest.raises(ValueError) as ref:
        jax_make_mesh(data=2, model=2, devices=jax.devices()[:2])
    assert str(ref.value) == errs["too_few"]
    assert "needs a world of 4 ranks" in errs["world"]
    assert world[0]["default_data"] == {"data": 1, "model": 2}
    for rank in (0, 1):
        assert world[rank]["global_mesh"] == ({"data": 1, "model": 2}, rank,
                                              "cpu")


def test_shard_params_keeps_this_ranks_part(world, init_state, state16):
    """shard_params on state dicts by JAX's rule: "moments" keeps this
    rank's network of the two, "hidden" cuts every weight and bias whose
    output width the axis divides to half its rows."""
    for rank in (0, 1):
        keys = world[rank]["shard_moments"]
        assert keys == sorted(k for k in init_state
                              if k.split(".")[1] == str(rank))
    shapes = world[0]["shard_hidden"]
    for k, v in state16.items():
        want = ((v.shape[0] // 2,) + tuple(v.shape[1:])
                if v.shape[0] % 2 == 0 and v.shape[0] > 1 else tuple(v.shape))
        assert shapes[k] == want, k


# ---------------------------------------------------------------- forward

def test_moments_forward_and_gradients_match_jax(world, jax_init):
    """Each rank runs its one network (K_h 1) and gathers all moments once a
    forward; the outputs equal JAX's moment-sharded apply and one process's,
    and every gradient JAX's."""
    local, k_hidden, names = world[0]["moments_local"]
    assert (local, k_hidden) == (1, 1)
    assert all(n.split(".")[1] == "0" for n in names)
    assert world[0]["gathers_a_forward"] == 1
    model = JaxModel(input_dim=1, hidden_dim=R.H, output_dim=1,
                     num_moments=2, use_pallas=False)
    mesh = jax_make_mesh(data=1, model=2)
    params = jax_shard_params(mesh, jax.tree_util.tree_map(jnp.asarray,
                                                           jax_init),
                              moment_axis=True)
    preds, before, grads = jax_forward_and_grads(model, params, mesh)
    for rank in (0, 1):
        got = world[rank]["moments"]
        np.testing.assert_allclose(got["preds"].numpy(), preds, **APPLY_TOL)
        np.testing.assert_allclose(got["before"].numpy(), before,
                                   **APPLY_TOL)
        assert_states(got["grads"], state_dict_from_jax(grads, **SEP),
                      **GRAD_TOL)
    one = R.model_from(state_dict_from_jax(jax_init, **SEP))
    with torch.no_grad():
        p1, b1 = one.apply(*batch())
    assert torch.equal(world[0]["moments"]["preds"], p1)
    assert torch.equal(world[0]["moments"]["before"], b1)


def test_a_gather_whose_backward_sums_fails_the_gradient_test(world):
    """The trap: the loss is the same on both ranks, so a gather's backward
    that sums the incoming gradient over the model group (a reduce-
    scatter) doubles every gradient.  The same forward, then gradients
    twice the right ones, outside the tolerance that the gather passes."""
    right, trap = world[0]["moments"], world[0]["trap"]
    assert torch.equal(right["preds"], trap["preds"])
    for k, g in right["grads"].items():
        np.testing.assert_allclose(trap["grads"][k].numpy(),
                                   2 * g.numpy(), rtol=1e-6, atol=1e-9)
    with pytest.raises(AssertionError):
        assert_states(trap["grads"], right["grads"], **GRAD_TOL)


@pytest.mark.parametrize("m", [2, 4])
def test_hidden_forward_and_gradients_match_jax(world, world4, jax_init16,
                                                state16, m):
    """"hidden" on JAX's shared network of hidden 16 over M = 2 and 4 (JAX's
    test_hidden_axis_tp_sharding): forward and every gradient against JAX's
    TP mesh; the ranks' blocks hold the gradient's rows; the output head
    (2 columns) stays whole at M = 4; the forward is one process's
    bitwise."""
    res = world if m == 2 else world4
    model = JaxModel(input_dim=1, hidden_dim=MA.H16, output_dim=1,
                     num_moments=2, shared_network=True, use_pallas=False)
    mesh = jax_make_mesh(data=2 if m == 4 else 1, model=m)
    params = jax_shard_params(mesh, jax.tree_util.tree_map(jnp.asarray,
                                                           jax_init16),
                              hidden_axis=True)
    preds, before, grads = jax_forward_and_grads(model, params, mesh)
    ref = state_dict_from_jax(grads, **SHARED)
    for r in res:
        got = r["hidden"]
        np.testing.assert_allclose(got["preds"].numpy(), preds, **APPLY_TOL)
        np.testing.assert_allclose(got["before"].numpy(), before,
                                   **APPLY_TOL)
        assert_states(got["grads"], ref, **GRAD_TOL)
    kinds = res[0]["hidden_kinds"]
    head = ("replicated" if m == 4 else "rows")
    assert kinds["output_nn.net.3.weight"] == head
    assert kinds["jump_nn.net.0.weight"] == "rows"
    one = MA.shared16(state16)
    with torch.no_grad():
        p1, _ = one.apply(*batch())
    assert torch.equal(res[0]["hidden"]["preds"], p1)


# --------------------------------------------------------------- training

@pytest.mark.parametrize("mode,batch_size", [
    ("moments", None), ("moments", R.BS), ("hidden", None),
    ("hidden", R.BS)])
def test_training_matches_one_process(world, init_state, mode, batch_size):
    """3 epochs on a 1 x 2 mesh against one process from the same weights:
    "hidden" bitwise (losses, parameters, Adam state), "moments" at the
    data axis's tolerance; both ranks report the same losses and the same
    gathered state; no gradient all-reduce (one data rank)."""
    ref_hist, ref_state, ref_osd = single(init_state, batch_size=batch_size)
    hist, state, osd, _, reductions = world[0][("train", mode, batch_size)]
    assert reductions == 0
    other = world[1][("train", mode, batch_size)][0]
    assert other["train_loss"] == hist["train_loss"]
    assert other["val_loss"] == hist["val_loss"]
    assert_states(world[1][("train", mode, batch_size)][1], state,
                  exact=True)
    if mode == "hidden":
        assert hist["train_loss"] == ref_hist["train_loss"]
        assert hist["val_loss"] == ref_hist["val_loss"]
        assert_states(state, ref_state, exact=True)
        assert_adam(osd, ref_osd, exact=True)
    else:
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(hist[key], ref_hist[key], **DP_TOL)
        assert_states(state, ref_state, **DP_TOL)
        assert_adam(osd, ref_osd, rtol=1e-4, atol=1e-9)


def test_moments_training_matches_jax_trainer(world, jax_init):
    """The 1 x 2 mesh under "moments" against JAX's
    Trainer(mesh=make_mesh(data=1, model=2), model_shard="moments"): 3
    epochs of minibatches of 16 over 40 rows, from the same weights."""
    times, values = R.make_data()
    vt, vv = R.make_data(12, seed=1)
    model = JaxModel(input_dim=1, hidden_dim=R.H, output_dim=1,
                     num_moments=2, use_pallas=False)
    trainer = JaxTrainer(model, jax_make_adam(R.LR, R.WD, flat=False),
                         ignore_first_continuity=True, moment_weights=R.MW,
                         seed=5, mesh=jax_make_mesh(data=1, model=2),
                         model_shard="moments")
    trainer.params = jax.tree_util.tree_map(jnp.asarray, jax_init)
    trainer.opt_state = trainer.optimizer.init(trainer.params)
    trainer._place_state()
    ref = trainer.train(lambda: (jnp.asarray(times), jnp.asarray(values)),
                        lambda: (jnp.asarray(vt), jnp.asarray(vv)),
                        n_epochs=3, batch_size=R.BS, shuffle=False,
                        print_every=1)
    hist, state = world[0][("train", "moments", R.BS)][:2]
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(hist[key], ref[key], **LOSS_TOL)
    assert_states(state, state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, trainer.params), **SEP),
        **STATE_TOL)


def test_hidden_training_matches_jax_trainer(world, jax_init16):
    """JAX's shared network of hidden 16 on a 1 x 2 mesh under "hidden"
    against JAX's Trainer(model_shard="hidden") on the same mesh."""
    times, values = R.make_data()
    vt, vv = R.make_data(12, seed=1)
    model = JaxModel(input_dim=1, hidden_dim=MA.H16, output_dim=1,
                     num_moments=2, shared_network=True, use_pallas=False)
    trainer = JaxTrainer(model, jax_make_adam(R.LR, R.WD, flat=False),
                         ignore_first_continuity=True, moment_weights=R.MW,
                         seed=5, mesh=jax_make_mesh(data=1, model=2),
                         model_shard="hidden")
    trainer.params = jax.tree_util.tree_map(jnp.asarray, jax_init16)
    trainer.opt_state = trainer.optimizer.init(trainer.params)
    trainer._place_state()
    ref = trainer.train(lambda: (jnp.asarray(times), jnp.asarray(values)),
                        lambda: (jnp.asarray(vt), jnp.asarray(vv)),
                        n_epochs=3, batch_size=R.BS, shuffle=False,
                        print_every=1)
    hist, state = world[0][("train", "hidden16", R.BS)][:2]
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(hist[key], ref[key], **LOSS_TOL)
    assert_states(state, state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, trainer.params), **SHARED),
        **STATE_TOL)


def test_each_rank_holds_its_part(world):
    """The bytes a rank holds: under "moments" one network of two and its
    Adam state; under "hidden" about half of every divisible weight and
    its Adam state, beside the whole networks the forward reads."""
    params = list(R.model_from(None).parameters())
    one = sum(p.numel() for p in params) * 4
    held = world[0]["held"]
    assert held["moments"]["params"] == held["moments"]["module"] == one // 2
    # exp_avg and exp_avg_sq of each tensor, and its f32 step
    assert held["moments"]["optimizer"] == one + 4 * len(params) // 2
    assert held["hidden"]["module"] == one
    assert one // 2 < held["hidden"]["params"] < one


@pytest.mark.parametrize("batch_size,gathers", [(None, 8), (R.BS, 14)])
def test_two_by_two_mesh_matches_one_process(world4, init_state, batch_size,
                                             gathers):
    """A 2 x 2 mesh under "moments": each rank its half of the rows and one
    network; gradients summed over the data group alone (one all-reduce a
    step), the moments gathered over the model group (one gather a
    forward, two for the gathered checkpoint state); 3 epochs against one
    process at the data axis's tolerance, every rank reporting the same."""
    ref_hist, ref_state, _ = single(init_state, batch_size=batch_size)
    steps = 3 if batch_size is None else 9
    for r in world4:
        hist, state, _, _, reductions = r[("moments", batch_size)]
        assert reductions == steps
        assert r[("gathers", batch_size)] == gathers
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(hist[key], ref_hist[key], **DP_TOL)
        assert_states(state, ref_state, **DP_TOL)


def test_hidden_over_four_ranks_trains_as_one_process(world4, state16):
    """JAX's hidden-16 model over a 1 x 4 mesh, 3 epochs: one process's
    run bitwise."""
    m16 = MA.shared16(state16)
    from njode_tpu_torch.utils import Trainer, make_adam
    tr = Trainer(m16, make_adam(m16.parameters(), R.LR, R.WD),
                 ignore_first_continuity=True, moment_weights=R.MW, seed=5)
    hist, _ = R.train_fixed(tr)
    got = world4[0]["hidden_train"]
    assert got[0]["train_loss"] == hist["train_loss"]
    assert_states(got[1], R.state_of(tr), exact=True)


def test_dropout_draws_a_stream_a_network(world, init_state):
    """Each separate network draws its dropout from a stream of its own
    index: rank r's network r draws under "moments" what network r draws
    in a default one-process Trainer, "hidden" draws every network's
    stream as one process does, and the masks keep 1 - p of the units by
    law (5 standard errors over 20,000 draws)."""
    tr = R.trainer_from(init_state, model_kw=dict(dropout_rate=0.2))
    gens = tr._dropout_generator(0)
    assert len(gens) == 2
    ref = [torch.rand(8, generator=g) for g in gens]
    for rank in (0, 1):
        draws = world[rank][("dropout_draws", "moments")]
        assert len(draws) == 1
        assert torch.equal(draws[0], ref[rank])
        hidden = world[rank][("dropout_draws", "hidden")]
        assert all(torch.equal(a, b) for a, b in zip(hidden, ref, strict=True))
    for g in tr._dropout_generator(1):
        keep = (torch.rand(20_000, generator=g) >= 0.2).double().mean()
        assert abs(float(keep) - 0.8) < 5 * (0.8 * 0.2 / 20_000) ** 0.5


@pytest.mark.parametrize("mode", ["moments", "hidden"])
def test_a_dropout_epoch_matches_a_default_one_process_run(world,
                                                           init_state, mode):
    """An epoch with dropout on a 1 x 2 mesh against a one-process Trainer
    built with the defaults (``model_shard="none"``): placement changes no
    mask, so "hidden" is bitwise and "moments" within the data axis's
    tolerance, as without dropout (test_training_matches_one_process)."""
    tr = R.trainer_from(init_state, model_kw=dict(dropout_rate=0.2))
    hist, _ = R.train_fixed(tr, n_epochs=1)
    ref_state = R.state_of(tr)
    got, state = world[0][("dropout", mode)][:2]
    if mode == "hidden":
        assert got["train_loss"] == hist["train_loss"]
        assert_states(state, ref_state, exact=True)
    else:
        np.testing.assert_allclose(got["train_loss"], hist["train_loss"],
                                   **DP_TOL)
        assert_states(state, ref_state, **DP_TOL)


@pytest.mark.parametrize("mode,shard,n", [
    ("step", "moments", 1), ("step", "hidden", 2), (True, "moments", 1),
    (True, "hidden", 2)])
def test_kernel_routes_take_each_ranks_networks(world, init_state, mode,
                                                shard, n):
    """use_pallas "step" and True on the mesh: each rank's plain fused step
    (rows 9-10) and fused cell (row 6) take its networks, Kn = 1 under
    "moments" and the two gathered networks under "hidden": a launch a
    step forward and backward (and a forward a validation) on a card.  The
    run matches one process's in the same mode."""
    hist, state, _, text, seen = world[0][("pallas", mode, shard)]
    ref_hist, ref_state, _ = single(init_state, n_epochs=2,
                                    model_kw=dict(use_pallas=mode))
    if mode == "step":
        assert seen["step_fwd"] == [n] * (2 * 3 + 2)
        assert seen["step_bwd"] == [n] * (2 * 3)
        assert "composed (fused-step kernels), model axis of 2" in text
        assert f"Kn={n} a rank" in text
    else:
        assert seen["cell"] and set(seen["cell"]) == {n}
        assert "composed (forced fused Euler cell), model axis of 2" in text
    np.testing.assert_allclose(hist["train_loss"], ref_hist["train_loss"],
                               **DP_TOL)
    assert_states(state, ref_state, **DP_TOL)


# ------------------------------------------------------------ checkpoints

@pytest.mark.parametrize("mode", ["moments", "hidden"])
def test_a_one_process_checkpoint_resumes_on_the_mesh(world, init_state,
                                                      mode):
    """A checkpoint one process wrote after 2 epochs resumes on the 1 x 2
    mesh to 3: the uninterrupted one-process run (bitwise under
    "hidden")."""
    hist, state, osd, text = world[0][("from_one", mode)]
    ref_hist, ref_state, ref_osd = single(init_state)
    assert "Resuming from epoch 2" in text
    if mode == "hidden":
        assert hist["train_loss"] == ref_hist["train_loss"]
        assert_states(state, ref_state, exact=True)
        assert_adam(osd, ref_osd, exact=True)
    else:
        np.testing.assert_allclose(hist["train_loss"],
                                   ref_hist["train_loss"], **DP_TOL)
        assert_states(state, ref_state, **DP_TOL)


@pytest.mark.parametrize("mode", ["moments", "hidden"])
@pytest.mark.parametrize("backend", ["msgpack", "orbax"])
def test_resume_on_the_mesh_and_load_in_one_process(world, workdir, mode,
                                                    backend):
    """2 epochs, then a third from the checkpoint, on the 1 x 2 mesh: the
    uninterrupted 3 epochs bitwise.  The file holds the one-process layout
    (gathered); the torch.distributed.checkpoint directory each rank's own
    part (blocks as key#lo:hi).  Either loads into one process here: the
    mesh's last state and Adam state, bitwise."""
    written, hist, state, osd, text = world[0][("resume", mode, backend)]
    full = world[0][("train", mode, R.BS)]
    assert "Resuming from epoch 2" in text
    assert hist["train_loss"] == full[0]["train_loss"]
    assert hist["val_loss"] == full[0]["val_loss"]
    assert_states(state, full[1], exact=True)
    path = workdir / f"{mode}_{backend}" / "model.ckpt"
    assert path.is_dir() == (backend == "orbax")
    tr = R.trainer_from(None)
    tr.load_model(str(path))
    assert_states(R.state_of(tr), state, exact=True)
    assert_adam(tr.optimizer.state_dict(), osd, exact=True)
    assert tr.train_losses == hist["train_loss"]


# --------------------------------------------------------- run_experiment

@pytest.mark.parametrize("mode", ["moments", "hidden"])
def test_run_experiment_model_parallel_matches_jax(world, tmp_path,
                                                   monkeypatch, mode):
    """run_experiment(model_parallel=2) inside the 2-rank group against the
    JAX package's run_experiment(model_parallel=2) (its EP config, on a 4 x
    2 mesh of its devices) on the same fixed data and initial weights:
    per-epoch train, validation and relative losses; the Distributed line
    names the axes and what the model axis holds; rank 0 alone prints."""
    (tt, tv), (vt, vv) = fixed_data()
    monkeypatch.setattr(jax_training, "create_data_loaders", lambda **kw: (
        lambda: (jnp.asarray(tt), jnp.asarray(tv)),
        lambda: (jnp.asarray(vt), jnp.asarray(vv))))
    cfg = {k: v for k, v in EXPERIMENTS[mode].items() if k != "device"}
    cfg["checkpoint_backend"] = "msgpack"
    ref = jax_training.run_experiment(cfg, save_dir=str(tmp_path))["history"]
    res, text = world[0][("experiment", mode)]
    ours = res["history"]
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(ours[key], ref[key], **LOSS_TOL)
    np.testing.assert_allclose(ours["relative_loss"], ref["relative_loss"],
                               rtol=1e-4)
    assert world[1][("experiment", mode)][0]["history"]["train_loss"] == \
        ours["train_loss"]
    assert ("Distributed: 2 ranks (data axis 1, model axis 2), backend "
            f"gloo, rank 0 on cpu; {mode}:") in text
    assert text.count("Kernels: ") == 1
    assert world[1][("experiment", mode)][1] == ""
    assert os.path.isdir(os.path.join(res["save_path"], "model.ckpt"))


def test_multihost_run_takes_the_global_mesh(world):
    """--multihost inside a 2-rank group with --model-parallel 2: the run
    over global_mesh(model=2), each rank on the device its launcher set
    (the CPU here), is the EP run on the 1 x 2 mesh bitwise."""
    res, text = world[0][("experiment", "multihost")]
    ref = world[0][("experiment", "moments")][0]["history"]
    assert res["history"]["train_loss"] == ref["train_loss"]
    assert res["history"]["val_loss"] == ref["val_loss"]
    assert ("Distributed: 2 ranks (data axis 1, model axis 2), backend "
            "gloo, rank 0 on cpu; moments:") in text


def test_run_experiment_refuses_as_jax(tmp_path):
    """An unknown mode: JAX's ValueError (before any rank starts); a model
    axis the cards cannot hold: JAX's "mesh DxM needs N devices" (here no
    card: device auto)."""
    with pytest.raises(ValueError) as ours:
        run_experiment(ep_config(model_parallel_mode="experts"),
                       save_dir=str(tmp_path / "port"))
    cfg = {k: v for k, v in ep_config(model_parallel_mode="experts").items()
           if k != "device"}
    cfg["checkpoint_backend"] = "msgpack"
    with pytest.raises(ValueError) as ref:
        jax_training.run_experiment(cfg, save_dir=str(tmp_path / "jax"))
    assert str(ours.value) == str(ref.value)
    pattern = r"mesh \d+x\d+ needs \d+ devices, have \d+"
    with pytest.raises(ValueError, match=pattern) as ours:
        run_experiment(ep_config(device="auto"),
                       save_dir=str(tmp_path / "port"))
    assert str(ours.value) == "mesh 1x2 needs 2 devices, have 0"
    cfg["model_parallel_mode"], cfg["model_parallel"] = "moments", 16
    with pytest.raises(ValueError, match=pattern) as ref:
        jax_training.run_experiment(cfg, save_dir=str(tmp_path / "jax"))
    assert str(ref.value) == "mesh 1x16 needs 16 devices, have 8"


# -------------------------------------------------------------- ensembles

def test_shard_ensemble_cuts_the_seed_axis_on_the_model_axis(world):
    """shard_ensemble's default axis is JAX's, the model axis: on a 1 x 2
    mesh each rank keeps its block of K=4 (a stack or a list); the data
    axis (one rank) keeps all four."""
    stack = torch.arange(12.).reshape(4, 3)
    for rank in (0, 1):
        w, items, whole = world[rank]["shard_ensemble"]
        assert torch.equal(w, stack[2 * rank:2 * rank + 2])
        assert items == [2 * rank, 2 * rank + 1]
        assert torch.equal(whole, stack)


def test_ensemble_over_the_model_axis_is_the_single_process_one(world):
    """train_ensemble_full over the 1 x 2 mesh (one member a rank): every
    rank returns the single-process stack, Adam states and loss rows,
    bitwise."""
    ref = train_ensemble_full(NeuralJumpODE(device="cpu", **ENS_MODEL_KW),
                              "black_scholes", n_seeds=2, **ENS_TRAIN_KW)
    for rank in (0, 1):
        stack, opts, hist = world[rank]["ensemble"]
        for k, v in ref[0].items():
            assert torch.equal(stack[k], v), k
        for k, v in ref[2].items():
            assert torch.equal(hist[k], v), k
        for a, b in zip(opts, ref[1]):
            for i in b["state"]:
                assert torch.equal(a["state"][i]["exp_avg"],
                                   b["state"][i]["exp_avg"])


# ------------------------------------------------------------------ misc

def test_trainer_refuses_an_unknown_model_shard():
    """JAX's ValueError for any other model_shard (njode_tpu/utils/
    training.py:273-275)."""
    model = NeuralJumpODE(1, 8, 1, device="cpu")
    from njode_tpu_torch.utils import Trainer
    with pytest.raises(ValueError) as ours:
        Trainer(model, model_shard="experts")
    with pytest.raises(ValueError) as ref:
        JaxTrainer(JaxModel(1, 8, 1), model_shard="experts")
    assert str(ours.value) == str(ref.value)


def test_compile_time_counts_the_first_call():
    """compile_time: the seconds of one first call, whatever it builds at
    first use (here a 0.2 s stand-in for a kernel's build), and the call
    runs once."""
    import time
    from njode_tpu_torch.utils.profiling import compile_time
    calls = []

    def fn(x, scale=1.0):
        if not calls:
            time.sleep(0.2)
        calls.append(x)
        return torch.ones(3) * scale
    secs = compile_time(fn, 1, scale=2.0)
    assert calls == [1]
    assert 0.2 <= secs < 5.0
    assert compile_time(fn, 2) < 0.2
    assert re.search(r"ahead of time", compile_time.__doc__)
