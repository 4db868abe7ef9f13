"""The port's entry points (graft_entry_torch.py) on the CPU: the flagship
forward against the JAX package's ``__graft_entry__.entry`` on the same
weights and batch, and ``dryrun_multichip(4)``: the JAX dry run's six
passes over four gloo ranks on a 2 x 2 mesh, each printing "... OK"."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
import graft_entry_torch as G
from njode_tpu_torch.utils import state_dict_from_jax


def test_entry_is_the_flagship_forward():
    """entry(): a callable and its batch; on the JAX flagship's weights and
    batch (through the bridge) its outputs equal JAX's at rtol 1e-5 /
    atol 1e-6."""
    fn, (times, values, mask) = G.entry(device="cpu")
    preds, before = fn(times, values, mask)
    assert preds.shape == (32, times.shape[1], 1, 2)
    assert torch.isfinite(preds).all() and torch.isfinite(before).all()
    jfn, (params, jt, jv, jm) = jax_entry.entry()
    ref_p, ref_b = jax.jit(jfn)(params, jt, jv, jm)
    model = G._flagship("cpu")
    model.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), num_moments=2,
        shared_network=False, n_hidden_layers=1))
    with torch.no_grad():
        p, b = model.apply(torch.as_tensor(np.array(jt)),
                           torch.as_tensor(np.array(jv)),
                           torch.as_tensor(np.array(jm)))
    np.testing.assert_allclose(p.numpy(), np.asarray(ref_p), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(ref_b), rtol=1e-5,
                               atol=1e-6)


def test_dryrun_multichip_over_four_ranks(capsys):
    """dryrun_multichip(4) asked for the CPU: a 2 x 2 mesh of gloo ranks;
    every pass of the JAX dry run prints its "OK" line."""
    G.dryrun_multichip(4, devices=["cpu"] * 4)
    out = capsys.readouterr().out
    assert ("mesh: data=2 model=2 (4 ranks, backend=gloo, devices="
            f"{['cpu'] * 4})") in out
    for name in ("production DP step OK", "EP pass OK", "TP pass OK",
                 "trainer OK", "checkpoint resume OK",
                 "sharded ensemble + obs_only OK",
                 "sharded lr-population OK"):
        assert f"dryrun_multichip(4): {name}" in out, name


@pytest.mark.parametrize("cards,expected", [
    (0, ["cpu"] * 4),
    (1, ["cuda:0"] * 4),
    (2, ["cuda:0", "cuda:1", "cuda:0", "cuda:1"]),
    (4, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"])])
def test_the_dry_run_takes_the_cards_there_are(monkeypatch, cards, expected):
    """Without ``devices`` the ranks take the cards in turn, however few
    (gloo where they share one, as choose_backend picks); the CPU only
    where there is no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert G.default_devices(4) == expected
