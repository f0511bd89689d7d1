"""``numpyro_tpu_torch.checkpoint`` on the model of the JAX package's
``tests/test_checkpoint.py``.

- ``post_warmup_state`` saved and restored equals the original leaf for
  leaf, the generator's state included, and a run resumed from the restored
  state equals the run resumed from memory bit for bit; the posterior mean
  meets that test's gate (0.35 around the exact 2 * 25 / 26).
- The same for four vectorized chains and for an ``SVIState`` with ``Adam``
  (two more steps from each state give the same losses and params).
- A target of another structure raises ``ValueError`` with the JAX
  package's messages (the count of leaves, then a leaf's shape); a target on
  the ``meta`` device gets its tensors there; the file loads with
  ``torch.load(..., weights_only=True)``.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import numpyro_tpu.checkpoint as jcheckpoint
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
from numpyro_tpu_torch.infer import MCMC, NUTS, SVI, Trace_ELBO, autoguide
from numpyro_tpu_torch.optim import Adam
from numpyro_tpu_torch.util import tree_map

torch.set_num_threads(1)


def model(y):
    mu = npt.sample("mu", dist.Normal(0.0, 5.0))
    npt.sample("y", dist.Normal(mu, 1.0), obs=y)


def _leaves(tree):
    """Every leaf of a state, generators and numbers included (``None`` is
    structure)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _assert_same_state(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert type(x) is type(y)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device
            assert torch.equal(x, y)
        elif isinstance(x, torch.Generator):
            assert x.device == y.device and x is not y
            assert torch.equal(x.get_state(), y.get_state())
        else:
            assert x == y


def test_checkpoint_roundtrip_and_resume(tmp_path):
    y = torch.tensor(2.0)
    m = MCMC(NUTS(model), num_warmup=80, num_samples=60, device="cpu")
    m.warmup(0, y)
    path = save_checkpoint(tmp_path / "warm", m.post_warmup_state)
    assert os.path.isfile(path)
    restored = restore_checkpoint(path, m.post_warmup_state)
    _assert_same_state(m.post_warmup_state, restored)
    # resumed in memory: the state's generator advances as the run draws
    m.run(1, y)
    from_memory = m.get_samples()["mu"]
    m.post_warmup_state = restored
    m.run(1, y)
    from_disk = m.get_samples()["mu"]
    assert torch.equal(from_memory, from_disk)
    # the JAX package's gate: the posterior of mu is N(2 * 25 / 26, 25 / 26)
    assert abs(from_disk.mean().item() - 2 * 25 / 26) < 0.35


def test_vectorized_chains_resume_bit_for_bit(tmp_path):
    y = torch.tensor(2.0)
    m = MCMC(NUTS(model), num_warmup=20, num_samples=10, num_chains=4, device="cpu")
    m.warmup(0, y)
    path = save_checkpoint(tmp_path / "sub" / "chains.pt", m.post_warmup_state)
    restored = restore_checkpoint(path, m.post_warmup_state)
    _assert_same_state(m.post_warmup_state, restored)
    m.run(1, y, extra_fields=("potential_energy",))
    want = (m.get_samples(group_by_chain=True)["mu"], m.get_extra_fields()["potential_energy"])
    m.post_warmup_state = restored
    m.run(1, y, extra_fields=("potential_energy",))
    got = (m.get_samples(group_by_chain=True)["mu"], m.get_extra_fields()["potential_energy"])
    assert got[0].shape == (4, 10)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _svi_model(y):
    loc = npt.sample("loc", dist.Normal(0.0, 3.0))
    scale = npt.sample("scale", dist.HalfNormal(2.0))
    with npt.plate("N", y.shape[0]):
        npt.sample("y", dist.Normal(loc, scale), obs=y)


def test_svi_state_with_adam_round_trips(tmp_path):
    y = torch.tensor(np.random.default_rng(0).normal(1.0, 0.5, 30), dtype=torch.float32)
    svi = SVI(_svi_model, autoguide.AutoNormal(_svi_model), Adam(0.05), Trace_ELBO(),
              device="cpu")
    state = svi.init(0, y)
    for _ in range(3):
        state, _ = svi.update(state, y)
    path = save_checkpoint(tmp_path / "svi.pt", state)
    restored = restore_checkpoint(path, state)
    _assert_same_state(state, restored)

    def two_steps(s):
        losses = []
        for _ in range(2):
            s, loss = svi.update(s, y)
            losses.append(loss)
        return torch.stack(losses), svi.get_params(s)

    want_losses, want_params = two_steps(state)
    got_losses, got_params = two_steps(restored)
    assert torch.equal(got_losses, want_losses)
    for k in want_params:
        assert torch.equal(got_params[k], want_params[k])


def test_a_target_of_another_structure_raises_as_in_jax(tmp_path):
    y = torch.tensor(2.0)
    m = MCMC(NUTS(model), num_warmup=5, num_samples=5, num_chains=2, device="cpu")
    m.warmup(0, y)
    path = save_checkpoint(tmp_path / "two_chains.pt", m.post_warmup_state)
    with pytest.raises(ValueError, match="leaves but the target state has"):
        restore_checkpoint(path, {"mu": torch.zeros(2)})
    one = MCMC(NUTS(model), num_warmup=5, num_samples=5, device="cpu")
    one.warmup(0, y)
    with pytest.raises(ValueError, match=r"has shape \(2,\) but the target expects \(\)"):
        restore_checkpoint(path, one.post_warmup_state)
    # the JAX package's check gives the same messages on the same leaves
    with pytest.raises(ValueError, match="leaves but the target state has"):
        jcheckpoint._rebuild_like({"mu": jnp.zeros(2)}, [np.zeros(2), np.zeros(2)])
    with pytest.raises(ValueError, match=r"has shape \(2,\) but the target expects \(\)"):
        jcheckpoint._rebuild_like({"mu": jnp.zeros(())}, [np.zeros(2)])
    swapped = m.post_warmup_state._replace(rng_key=torch.zeros(()), i=torch.Generator())
    with pytest.raises(ValueError, match="generator"):
        restore_checkpoint(path, swapped)


def test_a_target_on_the_meta_device_gets_its_leaves_there(tmp_path):
    y = torch.tensor(2.0)
    m = MCMC(NUTS(model), num_warmup=5, num_samples=5, num_chains=3, device="cpu")
    m.warmup(0, y)
    path = save_checkpoint(tmp_path / "meta.pt", m.post_warmup_state)
    target = tree_map(lambda x: x.to("meta"), m.post_warmup_state)
    restored = restore_checkpoint(path, target)
    tensors = [leaf for leaf in _leaves(restored) if isinstance(leaf, torch.Tensor)]
    assert tensors and all(t.device.type == "meta" for t in tensors)
    assert restored.z["mu"].shape == (3,)
    assert torch.equal(restored.rng_key.get_state(), m.post_warmup_state.rng_key.get_state())


def test_the_file_holds_only_tensors_and_plain_containers(tmp_path):
    state = {"w": torch.arange(3.0), "n": 4, "g": torch.Generator().manual_seed(5),
             "none": None, "t": (torch.ones(2), [1.5, "tag"])}
    path = save_checkpoint(tmp_path / "plain.pt", state)
    payload = torch.load(path, weights_only=True)
    assert payload["format"].startswith("numpyro_tpu_torch.checkpoint")
    restored = restore_checkpoint(path, state)
    _assert_same_state(state, restored)
    assert restored["none"] is None and restored["t"][1] == [1.5, "tag"]
    with pytest.raises(TypeError, match="cannot save"):
        save_checkpoint(tmp_path / "bad.pt", {"f": lambda: 0})
    assert not os.path.exists(tmp_path / "bad.pt")


def test_restoring_runs_no_code(tmp_path):
    """A file that is not a checkpoint of this module (a pickled object) is
    refused by ``weights_only`` loading before anything in it runs."""
    import pickle

    class Boom:
        def __reduce__(self):
            return (os.getcwd, ())

    path = tmp_path / "evil.pt"
    with open(path, "wb") as f:
        pickle.dump({"format": "numpyro_tpu_torch.checkpoint/1", "leaves": [Boom()]}, f,
                    protocol=2)
    with pytest.raises(Exception, match="[Ww]eights"):
        restore_checkpoint(path, {"x": torch.zeros(())})
