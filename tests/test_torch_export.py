"""The port's export against the JAX package's, on the CPU, in fp32, at small
size: the port's ``graph.pt2`` (``torch_export``) run through
``load_exported_graph`` gives the outputs of JAX's exported ``stablehlo``
graph, run through JAX's ``load_exported_graph``, on the same observations
(and memories), for three actors with the same weights and observation
statistics: the MLP entry with normalization, the GRU entry and the
transformer ring.  Tolerance 1e-5 (fp32 to summation order).  Also:
``manifest.yaml``, parsed with ``yaml``, equals JAX's apart from ``format``;
``ExportedStatefulPolicy`` and ``InferencePolicy`` hold the memory and
``reset(indices)`` as JAX's do; the ``package`` format round-trips.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from cusrl_tpu import export as jax_export
from cusrl_tpu.environment.locomotion import VelocityLocomotionEnv as JaxEnv
from cusrl_tpu.utils import misc as jax_misc
from cusrl_tpu.utils.config import CONFIG as JAX_CONFIG
from cusrl_tpu.zoo.registry import get_experiment as jax_get_experiment
from cusrl_tpu_torch import export
from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
from cusrl_tpu_torch.utils.config import CONFIG
from cusrl_tpu_torch.utils.interop import load_jax_state
from cusrl_tpu_torch.zoo.registry import get_experiment

N, OBS, BATCH = 8, 48, 4
TOL = dict(rtol=1e-5, atol=1e-5)
ENTRIES = {
    "mlp": ("ppo", dict(actor_hidden_dims=(32, 32), critic_hidden_dims=(32, 32))),
    "gru": ("recurrent_ppo", dict(rnn_hidden_size=32, mlp_hidden_dims=(32,))),
    "transformer": ("transformer_ppo", dict(embed_dim=32, num_heads=2, attention_window=4, mlp_hidden_dims=(32,))),
}


@pytest.fixture(scope="module", params=list(ENTRIES))
def exported(request, tmp_path_factory):
    """Both agents (the port's with the JAX agent's weights and random
    observation statistics) and both ``torch_export``/``stablehlo`` exports."""
    algorithm, small = ENTRIES[request.param]
    with pytest.MonkeyPatch.context() as patch:
        for config in (JAX_CONFIG, CONFIG):
            patch.setattr(config, "compute_dtype", None)
        patch.setattr(JAX_CONFIG, "seed", 0)
        patch.setattr(jax_misc, "_KEY_COUNTER", [0])
        jf = jax_get_experiment("Velocity-Flat", algorithm).make_agent_factory()
        tf = get_experiment("Velocity-Flat", algorithm).make_agent_factory()
        for f in (jf, tf):
            for key, value in small.items():
                setattr(f, key, value)
        jax_agent = jf(JaxEnv(num_instances=N).spec)
        rng = np.random.default_rng(3)
        hook = jax_agent.get_hook("observation_normalization")
        rms = hook.observation_rms.replace(mean=jnp.asarray(rng.standard_normal(OBS) * 0.3, jnp.float32),
                                           var=jnp.asarray(rng.random(OBS) + 0.5, jnp.float32))
        jax_agent.update_hook(hook.hook_name, hook.replace(observation_rms=rms))
        agent = tf(VelocityLocomotionEnv(num_instances=N, device="cpu").spec, device="cpu")
        load_jax_state(agent, jax_agent.state_dict()["agent_state"])
        root = tmp_path_factory.mktemp(request.param)
        jax_agent.export(str(root / "jax"), target_format="stablehlo", batch_size=BATCH, verbose=False)
        agent.export(str(root / "port"), target_format="torch_export", batch_size=BATCH, verbose=False)
        yield request.param, jax_agent, agent, root


def _observations(seed):
    return np.tanh(np.random.default_rng(seed).standard_normal((BATCH, OBS))).astype(np.float32)


def test_graph_matches_jax(exported):
    """Three steps, each side feeding its own memory back."""
    name, _, _, root = exported
    jax_call, _ = jax_export.load_exported_graph(str(root / "jax"))
    call, manifest = export.load_exported_graph(str(root / "port"))
    assert isinstance(call, torch.nn.Module)
    recurrent = manifest["is_recurrent"]
    assert recurrent == (name != "mlp")
    jax_memory = memory = None
    if recurrent:
        with open(root / "jax" / "initial_memory.pkl", "rb") as f:
            jax_memory = pickle.load(f)
        with open(root / "port" / "initial_memory.pkl", "rb") as f:
            memory = pickle.load(f)
    for step in range(3):
        obs = _observations(step)
        jax_out = jax_call({"observation": jnp.asarray(obs), **({"memory_in": jax_memory} if recurrent else {})})
        out = call({"observation": torch.from_numpy(obs),
                    **({"memory_in": _to_torch(memory, manifest)} if recurrent else {})})
        assert set(out) == set(jax_out)
        for key in ("action", "actor.backbone.output"):
            np.testing.assert_allclose(out[key].float().numpy(), np.asarray(jax_out[key], np.float32),
                                       err_msg=f"{key} at step {step}", **TOL)
        if recurrent:
            jax_memory, memory = jax_out["memory_out"], out["memory_out"]
            jax_flat, flat = _flat(jax_memory), _flat(memory)
            assert set(flat) == set(jax_flat)
            for path, value in flat.items():
                np.testing.assert_allclose(value.float().numpy(), np.asarray(jax_flat[path], np.float32),
                                           err_msg=f"memory_out.{path} at step {step}", **TOL)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(_flat(value, f"{prefix}{key}."))
        return out
    return {prefix[:-1]: tree}


def _to_torch(memory, manifest):
    flat = {path: torch.as_tensor(np.asarray(value)) for path, value in _flat(memory).items()}
    dtypes = {k[len("memory_in."):]: v["dtype"] for k, v in manifest["inputs"].items() if k.startswith("memory_in.")}
    flat = {path: value.to(getattr(torch, dtypes[path])) for path, value in flat.items()}
    return export._unflatten(flat)


def test_manifest_matches_jax(exported):
    _, _, _, root = exported
    jax_manifest = yaml.safe_load((root / "jax" / "manifest.yaml").read_text())
    manifest = yaml.safe_load((root / "port" / "manifest.yaml").read_text())
    assert manifest.pop("format") == "torch_export" and jax_manifest.pop("format") == "stablehlo"
    assert manifest == jax_manifest


def test_stateful_policies_match_jax(exported):
    """``ExportedStatefulPolicy`` (recurrent exports) and ``InferencePolicy``
    on both sides, with a ``reset(indices)`` between steps; a single
    observation gets its batch dim added and removed."""
    name, jax_agent, agent, root = exported
    policies = [(jax_export.InferencePolicy(jax_agent.state.actor, num_instances=BATCH),
                 export.InferencePolicy(agent.actor, num_instances=BATCH))]
    if name != "mlp":
        policies.append((jax_export.ExportedStatefulPolicy(str(root / "jax")),
                         export.ExportedStatefulPolicy(str(root / "port"))))
    else:
        with pytest.raises(ValueError, match="stateless"):
            export.ExportedStatefulPolicy(str(root / "port"))
    for jax_policy, policy in policies:
        # JAX's ExportedStatefulPolicy.reset(indices) broadcasts the ring's
        # rank-0 cursor to [N], and its next call then fails; the port keeps
        # rank-0 leaves (as reset_memory does), checked on its own below.
        reset_both = not (name == "transformer" and isinstance(policy, export.ExportedStatefulPolicy))
        for step in range(3):
            obs = _observations(10 + step)
            np.testing.assert_allclose(policy(obs), np.asarray(jax_policy(obs)), err_msg=f"step {step}", **TOL)
            if step == 1 and reset_both:
                jax_policy.reset([0, 2])
                policy.reset([0, 2])
        if not reset_both:
            policy.reset([0, 2])
            for path, value in _flat(policy.memory).items():
                initial = _flat(policy._initial_memory)[path]
                if value.dim() == 0:
                    assert path.endswith("cursor") and value.item() == 3 % 5  # 3 steps on a ring of W + 1 = 5
                else:
                    assert torch.equal(value[[0, 2]], initial[[0, 2]]) and not torch.equal(value[1], initial[1])
        policy.reset()
        jax_policy.reset()
        if isinstance(policy, export.InferencePolicy):
            single = _observations(20)[0]
            action = export.InferencePolicy(agent.actor)(single)
            assert action.shape == (12,)
            np.testing.assert_allclose(action, np.asarray(jax_export.InferencePolicy(jax_agent.state.actor)(single)),
                                       **TOL)


def test_package_round_trip(exported, tmp_path):
    """The ``package`` format: the pickled actor gives the JAX package's
    actions (the actor alone, as in JAX: no normalization)."""
    name, jax_agent, agent, _ = exported
    agent.export(str(tmp_path / "port"), target_format="package", verbose=False)
    jax_agent.export(str(tmp_path / "jax"), target_format="package", verbose=False)
    actor = export.load_exported_policy(str(tmp_path / "port"))
    jax_actor = jax_export.load_exported_policy(str(tmp_path / "jax"))
    obs = _observations(30)
    memory, jax_memory = actor.init_memory(BATCH), jax_actor.init_memory(BATCH)
    with torch.no_grad():
        dist, _, _ = actor(torch.from_numpy(obs), memory)
    jax_action, _ = jax_actor.act_deterministic(jnp.asarray(obs), jax_memory)
    np.testing.assert_allclose(dist["mean"].numpy(), np.asarray(jax_action), **TOL)
    assert yaml.safe_load((tmp_path / "port" / "manifest.yaml").read_text())["format"] == "package"
