"""The port's activations, scalings, MLPs and weight bridge held against the
JAX package on the CPU.

Weights are the JAX package's own init, carried over by
``state_dict_from_jax``; inputs come from numpy with a fixed seed.  The
networks compute the same f32 algebra on both sides, so they are held to
rtol = atol = 1e-6; the bridge is held exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from njode_tpu import NeuralJumpODE as JaxModel
from njode_tpu.models import activations as jax_act
from njode_tpu.models.mlp import jump_nn_apply, ode_func_apply, output_nn_apply
from njode_tpu.utils.torch_compat import (_sequential_linear_indices,
                                          params_to_torch_state_dict)
from njode_tpu_torch import NeuralJumpODE
from njode_tpu_torch.models import activations as port_act
from njode_tpu_torch.models.mlp import JumpNN, ODEFunc, OutputNN, linear_indices
from njode_tpu_torch.utils import state_dict_from_jax

ACTS = ("relu", "tanh", "sigmoid", "elu", "leaky_relu", "selu")
TOL = dict(rtol=1e-6, atol=1e-6)


def _x(shape, seed=0, scale=2.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


@pytest.mark.parametrize("name", ACTS + ("ReLU", "Tanh", "identity", "gelu"))
def test_activations_match_jax(name):
    """All six activations, case-insensitive lookup, and the reference's
    silent ReLU fallback for unknown names."""
    x = _x((64,), seed=len(name))
    x[:4] = [0.0, -0.0, 1e-30, -1e-30]
    ours = port_act.get_activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jax_act.get_activation(name)(
        jnp.asarray(x))), **TOL)
    assert port_act.canonical_activation(name) == jax_act.canonical_activation(
        name)


@pytest.mark.parametrize("name", ["identity", "none", "tanh", "sigmoid"])
def test_input_scalings_match_jax(name):
    x = _x((32,), seed=3)
    np.testing.assert_allclose(
        port_act.get_input_scaling(name)(torch.from_numpy(x)).numpy(),
        np.asarray(jax_act.get_input_scaling(name)(jnp.asarray(x))), **TOL)
    assert (port_act.canonical_input_scaling(name)
            == jax_act.canonical_input_scaling(name))


def test_unknown_input_scaling_raises_like_jax():
    with pytest.raises(ValueError, match="Unknown input_scaling"):
        jax_act.get_input_scaling("relu")
    with pytest.raises(ValueError, match="Unknown input_scaling"):
        port_act.get_input_scaling("relu")


def _bridged(act, n_hidden_layers, shared, hidden=12, d_x=2, d_y=3, K=2):
    """A JAX model's params and the port model loaded with them."""
    kw = dict(input_dim=d_x, hidden_dim=hidden, output_dim=d_y, num_moments=K,
              n_hidden_layers=n_hidden_layers, activation=act,
              shared_network=shared)
    params = JaxModel(**kw).init(jax.random.PRNGKey(n_hidden_layers))
    port = NeuralJumpODE(**kw)
    port.load_state_dict(state_dict_from_jax(
        params, num_moments=K, shared_network=shared,
        n_hidden_layers=n_hidden_layers))
    return params, port.eval()


@pytest.mark.parametrize("n_hidden_layers", [1, 2])
@pytest.mark.parametrize("act", ACTS)
def test_mlps_match_jax(act, n_hidden_layers):
    """JumpNN, ODEFunc and OutputNN with weights carried across."""
    params, port = _bridged(act, n_hidden_layers, shared=True)
    f = jax_act.get_activation(act)
    x, h, inp = _x((7, 2), 1), _x((7, 12), 2, 1.0), _x((7, 16), 3, 1.0)
    t = torch.from_numpy
    with torch.no_grad():
        pairs = [
            (port.jump_nn(t(x)), jump_nn_apply(params["jump"], x, f)),
            (port.ode_func(t(inp)), ode_func_apply(params["ode"], inp, f)),
            (port.output_nn(t(h)), output_nn_apply(params["out"], h, f)),
        ]
    for ours, ref in pairs:
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("n_hidden_layers", [1, 2])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "separate"])
def test_weight_bridge_matches_params_to_torch_state_dict(shared,
                                                          n_hidden_layers):
    params, port = _bridged("tanh", n_hidden_layers, shared)
    ours = state_dict_from_jax(params, num_moments=2, shared_network=shared,
                               n_hidden_layers=n_hidden_layers)
    ref = params_to_torch_state_dict(params, 2, shared, n_hidden_layers)
    assert list(ours) == list(ref)
    assert set(ours) == set(port.state_dict())
    for k in ref:
        assert ours[k].dtype == ref[k].dtype == torch.float32
        torch.testing.assert_close(ours[k], ref[k], rtol=0, atol=0)


@pytest.mark.parametrize("n_hidden_layers", [1, 2, 3])
@pytest.mark.parametrize("kind,cls,args", [
    ("jump", JumpNN, (2, 8)), ("ode", ODEFunc, (8, 2)),
    ("out", OutputNN, (8, 3))])
def test_linear_positions_match_the_reference_layout(kind, cls, args,
                                                     n_hidden_layers):
    net = cls(*args, n_hidden_layers=n_hidden_layers, dropout_rate=0.1)
    at = [i for i, m in enumerate(net.net) if isinstance(m, torch.nn.Linear)]
    assert at == linear_indices(kind, n_hidden_layers)
    assert at == _sequential_linear_indices(kind, n_hidden_layers)


def test_init_is_torch_default_law_from_the_generator():
    def model(seed):
        return NeuralJumpODE(input_dim=1, hidden_dim=50, output_dim=1,
                             num_moments=2, shared_network=True,
                             generator=torch.Generator().manual_seed(seed))
    a, b, c = model(0), model(0), model(1)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
        assert not torch.equal(pa, pc), name
    for layer in [m for m in a.modules() if isinstance(m, torch.nn.Linear)]:
        bound = layer.in_features ** -0.5
        w, b = layer.weight.detach(), layer.bias.detach()
        assert float(w.abs().max()) <= bound and float(b.abs().max()) <= bound
        # U(-b, b) over >= 50 draws reaches past half the bound
        assert float(w.abs().max()) > 0.5 * bound
