"""The port's d-dimensional processes (``black_scholes_nd``,
``ornstein_uhlenbeck_nd``) against the JAX package on the CPU, and the
routes a d_x 2 model takes on the card (the fused step, rows 9-10, for the
scaled d=2 recipe; the serving gap kernel, row 1, for ``predict_at``).

Transforms get the JAX package's own normals (rtol 1e-5 / atol 1e-6);
laws are held within 5 standard errors over 20,000 paths; moments on
identical inputs at rtol 1e-5 / atol 1e-6.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from njode_tpu.simulation import moments as jmom
from njode_tpu.simulation import multidim as jmd
from njode_tpu.simulation import sde as jsde
from njode_tpu_torch.models import NeuralJumpODE
from njode_tpu_torch.ops import fused_step as fs
from njode_tpu_torch.ops import gap_scan
from njode_tpu_torch.simulation import (bs_paths_nd, moments_at_obs,
                                        ou_paths_nd, simulate_batch,
                                        supports_obs_only)
from njode_tpu_torch.simulation import multidim as md
from njode_tpu_torch.utils import run_experiment

TOL = dict(rtol=1e-5, atol=1e-6)
Z = 5.0
N_LAW = 20000
CORR = [[1.0, 0.6, -0.2], [0.6, 1.0, 0.3], [-0.2, 0.3, 1.0]]
BS_KW = dict(mu=[0.1, -0.2, 0.05], sigma=[0.5, 0.3, 0.2], x0=[1.0, 2.0, 0.5])
OU_KW = dict(theta=[1.0, 0.0, 3.0], mu=[0.5, 0.0, -0.3],
             sigma=[0.3, 0.2, 0.4], x0=[0.0, 1.0, 0.2])


def gen(seed):
    return torch.Generator().manual_seed(seed)


def t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("corr", [None, CORR], ids=["iid", "corr"])
@pytest.mark.parametrize("family", ["bs", "ou"])
def test_nd_path_transforms_match_jax(family, corr):
    key = jax.random.PRNGKey(1)
    kw = dict(BS_KW if family == "bs" else OU_KW, corr=corr, T=1.0,
              n_steps=50)
    jfn = jmd.bs_paths_nd if family == "bs" else jmd.ou_paths_nd
    ours_fn = (md._bs_nd_from_normals if family == "bs"
               else md._ou_nd_from_normals)
    _, X = jfn(key, 16, dims=3, **kw)
    z = jax.random.normal(key, (16, 50, 3))
    np.testing.assert_allclose(ours_fn(t(z), **kw).numpy(), np.asarray(X),
                               **TOL)


@pytest.mark.parametrize("family", ["bs", "ou"])
def test_nd_values_at_transforms_match_jax(family):
    key = jax.random.PRNGKey(2)
    idx = jsde.sample_obs_indices(jax.random.PRNGKey(3), 16, 101, 0.08)
    times = jnp.asarray(idx, jnp.float32) * (jnp.float32(1.0)
                                             / jnp.float32(100))
    kw = dict(BS_KW if family == "bs" else OU_KW, corr=CORR)
    jfn = jmd.bs_nd_values_at if family == "bs" else jmd.ou_nd_values_at
    ours_fn = (md._bs_nd_values_from_normals if family == "bs"
               else md._ou_nd_values_from_normals)
    ref = jfn(key, times, dims=3, **kw)
    z = jax.random.normal(key, (16, times.shape[1] - 1, 3))
    np.testing.assert_allclose(ours_fn(t(times), t(z), **kw).numpy(),
                               np.asarray(ref), **TOL)


def test_bs_nd_has_the_correlated_lognormal_law():
    """Each component's log-return at T is N((mu - sigma^2/2) T, sigma^2 T);
    the log-returns' correlation is rho (SE (1 - rho^2) / sqrt(n))."""
    mu, sig = np.array(BS_KW["mu"]), np.array(BS_KW["sigma"])
    _, X = bs_paths_nd(N_LAW, dims=3, corr=CORR, generator=gen(0), **BS_KW)
    r = torch.log(X[:, -1] / X[:, 0]).double()
    for j in range(3):
        m_true, v_true = mu[j] - 0.5 * sig[j] ** 2, sig[j] ** 2
        assert abs(float(r[:, j].mean()) - m_true) < Z * math.sqrt(
            v_true / N_LAW)
        assert abs(float(r[:, j].var()) - v_true) < Z * v_true * math.sqrt(
            2.0 / (N_LAW - 1))
    c = np.corrcoef(r.numpy().T)
    for i, j in ((0, 1), (0, 2), (1, 2)):
        rho = CORR[i][j]
        assert abs(c[i, j] - rho) < Z * (1 - rho ** 2) / math.sqrt(N_LAW)


def test_ou_nd_has_the_componentwise_ou_law():
    _, X = ou_paths_nd(N_LAW, dims=3, corr=CORR, generator=gen(1), **OU_KW)
    assert X.shape == (N_LAW, 101, 3)
    for j in range(3):
        th, mu, sg, x0 = (OU_KW[k][j] for k in ("theta", "mu", "sigma", "x0"))
        e = math.exp(-th)
        mean = x0 * e + mu * (1 - e)
        var = sg ** 2 / (2 * th) * (1 - e * e) if th > 0 else sg ** 2
        x = X[:, -1, j].double()
        assert abs(float(x.mean()) - mean) < Z * math.sqrt(var / N_LAW)
        assert abs(float(x.var()) - var) < Z * var * math.sqrt(
            2.0 / (N_LAW - 1))


@pytest.mark.parametrize("process", ["black_scholes_nd",
                                     "ornstein_uhlenbeck_nd"])
def test_nd_obs_only_has_the_law_of_grid_then_subsample(process):
    kw = dict(dims=2, corr=[[1.0, 0.5], [0.5, 1.0]])
    assert supports_obs_only(process)
    grid = simulate_batch(N_LAW, process, 1.0, generator=gen(4), **kw)
    obs = simulate_batch(N_LAW, process, 1.0, obs_only=True,
                         generator=gen(5), **kw)
    assert grid.values.shape == obs.values.shape == (N_LAW, 101, 2)
    assert grid.paths.shape == (N_LAW, 101, 2) and obs.paths is None
    for k in (30, 100):
        for j in range(2):
            a, b = (v[:, k, j].double() for v in (grid.values, obs.values))
            va, vb = float(a.var()), float(b.var())
            assert abs(float(a.mean() - b.mean())) < Z * math.sqrt(
                (va + vb) / N_LAW)
            m4 = float(((a - a.mean()) ** 4).mean() + ((b - b.mean()) ** 4)
                       .mean())
            assert abs(va - vb) < Z * math.sqrt((m4 - va ** 2 - vb ** 2)
                                                / N_LAW)


@pytest.mark.parametrize("K,method", [(1, "direct"), (2, "direct"),
                                      (2, "second_moment"), (3, "direct")])
@pytest.mark.parametrize("process,kw", [
    ("black_scholes_nd", dict(mu=[0.1, -0.2], sigma=[0.5, 0.3])),
    ("ornstein_uhlenbeck_nd", dict(theta=[1.0, 0.0], mu=[0.5, 0.0],
                                   sigma=[0.3, 0.2]))])
def test_nd_moments_match_jax(process, kw, K, method):
    """Through the registry dispatch of moments_at_obs, with a mask."""
    rng = np.random.default_rng(K)
    times = np.sort(rng.uniform(0, 1, (5, 6)), axis=1).astype(np.float32)
    times[:, 0] = 0.0
    values = rng.lognormal(0, 0.3, (5, 6, 2)).astype(np.float32)
    mask = np.ones((5, 6), bool)
    mask[0, 4:] = False
    args = dict(num_moments=K, variance_method=method, dims=2, n_train=9,
                **kw)
    ours = moments_at_obs(torch.tensor(times), torch.tensor(values), process,
                          mask=torch.tensor(mask), **args)
    ref = jmom.moments_at_obs(times, values, process, mask=mask, **args)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# ------------------------------------------- the d_x 2 routes on the card

SCALED_ND2 = (256, 2, 1, 2, 2, 2)    # (H, N, L, d_x, d_y, K)


def test_fused_step_plans_admit_the_scaled_d2_shape():
    """Rows 9-10's f32 and bf16 plans and the gate at the scaled d=2
    recipe's shape (bench.py --process black_scholes_nd --dims 2
    --scaled)."""
    assert fs.f32_plan(*SCALED_ND2) is not None
    assert fs.launch_plan(*SCALED_ND2) is not None
    assert fs.fused_step_fits(*SCALED_ND2)


def nd_model(use_pallas="step", **kw):
    cfg = dict(input_dim=2, hidden_dim=16, output_dim=2, num_moments=2,
               device="cpu", use_pallas=use_pallas)
    cfg.update(kw)
    return NeuralJumpODE(**cfg)


def test_nd_models_reach_the_fused_step_under_step(monkeypatch):
    """Under use_pallas 'step' a d_x 2 model routes apply through rows 9-10
    (here their plain versions); 'auto' keeps to the one measured shape,
    which is d_x 1."""
    model = nd_model()
    assert model._step_eligible and model._use_fused_step(2, 4096)
    calls = []
    real = fs.FusedStep.apply
    monkeypatch.setattr(fs.FusedStep, "apply",
                        lambda *a: calls.append(1) or real(*a))
    b = simulate_batch(8, "black_scholes_nd", 0.02, obs_only=True,
                       generator=gen(0), dims=2)
    model.apply(b.times, b.values)
    assert calls == [1]
    assert not nd_model("auto")._use_fused_step(2, 4096)


def test_nd_serving_takes_the_gap_kernel_route():
    """A production-d=2 model (shared network, dt_ode_step 0.01) sends its
    predict_at gaps to row 1 (the plain version on the CPU), at a width
    row 1's plan admits, and answers as the JAX package's predict_at on the
    same weights (rtol 1e-4 / atol 1e-5, row 1's tolerance)."""
    from njode_tpu import NeuralJumpODE as JaxModel
    from njode_tpu_torch.utils import state_dict_from_jax
    cfg = dict(input_dim=2, hidden_dim=50, output_dim=2, num_moments=2,
               shared_network=True, dt_ode_step=0.01)
    jm = JaxModel(use_pallas=False, **cfg)
    params = jm.init(jax.random.PRNGKey(0))
    model = NeuralJumpODE(**cfg, use_pallas="auto", device="cpu")
    model.load_state_dict(state_dict_from_jax(
        params, num_moments=2, shared_network=True, n_hidden_layers=1))
    assert model._use_gap_scan(inference=True)
    assert gap_scan.gap_plan(50) is not None
    calls = []
    real = gap_scan.integrate_gap_fused

    def counted(*a, **k):
        calls.append(a[1].shape)
        return real(*a, **k)
    import njode_tpu_torch.models.jump_ode as jo
    b = simulate_batch(4, "black_scholes_nd", 0.1, obs_only=True,
                       generator=gen(1), dims=2)
    q = torch.tensor([[0.0, 0.05, 0.5, 0.95]] * 4)
    saved, jo.integrate_gap_fused = jo.integrate_gap_fused, counted
    try:
        out = model.predict_at(b.times, b.values, q)
    finally:
        jo.integrate_gap_fused = saved
    assert calls and calls[0][-1] == 2          # d_x 2 observations
    ref = jm.predict_at(params, jnp.asarray(b.times.numpy()),
                        jnp.asarray(b.values.numpy()),
                        jnp.asarray(q.numpy()))
    assert out["mean"].shape == (4, 4, 2)
    for key in ("mean", "var", "raw"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("process", ["black_scholes_nd",
                                     "ornstein_uhlenbeck_nd"])
def test_run_experiment_scaled_nd_on_the_fused_step(tmp_path, process,
                                                    capsys):
    """Two epochs of a cut scaled d=2 config ('step'): input_dim and
    output_dim follow dims, the fused step's plain versions carry it, and
    the relative loss has the registry's truths."""
    cfg = {
        "experiment_name": process, "hidden_dim": 16, "n_hidden_layers": 1,
        "activation": "relu", "learning_rate": 1e-3, "weight_decay": 5e-4,
        "n_epochs": 2, "batch_size": 32, "print_every": 1, "device": "cpu",
        "ignore_first_continuity": True, "num_moments": 2,
        "moment_weights": [1.0, 10.0], "use_pallas": "step", "seed": 0,
        "data": {"process_type": process, "n_train": 64, "n_val": 16,
                 "obs_fraction": 0.02, "cache_data": False, "obs_only": True,
                 "T": 1.0, "n_steps": 100, "dims": 2}}
    res = run_experiment(cfg, save_dir=str(tmp_path))
    assert "composed (fused-step kernels)" in capsys.readouterr().out
    hist = res["history"]
    assert np.isfinite(hist["train_loss"] + hist["val_loss"]
                       + hist["relative_loss"]).all()
