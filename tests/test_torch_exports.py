"""The port's package roots against the JAX package's: every name that
``njode_tpu`` and ``njode_tpu.utils`` export and whose function the port
defines is exported by the port's root under the same name; a name the port
does not define yet (ROADMAP, Queue 1) is not exported at all."""

import importlib
import pkgutil

import pytest

import njode_tpu_torch

# (JAX package, name): the JAX roots' __all__, less the plotting names that
# njode_tpu.utils exports only where matplotlib imports
NAMES = [("njode_tpu", n) for n in (
    "NeuralJumpODE", "nj_ode_loss", "NJODEFilter", "sample_paths",
    "__version__")] + [("njode_tpu.utils", n) for n in (
        "DataLoader", "Trainer", "as_dense", "create_data_loaders",
        "make_adam", "run_experiment", "checkpoint_exists", "load_checkpoint",
        "save_checkpoint", "params_from_torch_checkpoint",
        "params_from_torch_state_dict", "relative_loss",
        "conditional_moment_mse", "train_ensemble", "init_ensemble",
        "ensemble_predict", "ensemble_mean_std", "shard_ensemble")]
PORT_ROOT = {"njode_tpu": "njode_tpu_torch",
             "njode_tpu.utils": "njode_tpu_torch.utils"}


def port_definition(name):
    """The object the port defines under ``name`` in any of its modules,
    or None."""
    if name == "__version__":
        return njode_tpu_torch.__version__
    for info in pkgutil.walk_packages(njode_tpu_torch.__path__,
                                      "njode_tpu_torch."):
        obj = getattr(importlib.import_module(info.name), name, None)
        if obj is not None and getattr(obj, "__module__", "").startswith(
                "njode_tpu_torch"):
            return obj
    return None


@pytest.mark.parametrize("jax_root,name", NAMES)
def test_root_exports_follow_the_jax_package(jax_root, name):
    assert name in importlib.import_module(jax_root).__all__
    root = importlib.import_module(PORT_ROOT[jax_root])
    obj = port_definition(name)
    if obj is None:
        assert name not in root.__all__ and not hasattr(root, name)
    else:
        assert name in root.__all__ and getattr(root, name) is obj
