"""The port's CLI, ``cusrl_tpu_torch.__main__.main([... "--device", "cpu"])``,
on the CPU: counterparts of the JAX package's CLI tests
(``tests/test_cli_zoo.py``, ``tests/test_cli_errors_and_lr.py``) on the zoo's
Velocity-Flat/ppo entry, with overrides that shrink it (32 environments x 8
steps, hidden 32-32): train and resume, the run directory and ``find-trial``
against the JAX package's ``Trial`` and ``find-trial`` on the same
directory, ``play``, ``benchmark``, ``export``, ``--inherit-args``, and the
errors (an unknown subcommand, experiment, override path or trial directory,
and CUDA asked for where there is none)."""

import json
import os

import numpy as np
import pytest
import torch

from cusrl_tpu.__main__ import main as jax_main
from cusrl_tpu.template.trial import Trial as JaxTrial
from cusrl_tpu_torch.__main__ import main
from cusrl_tpu_torch.cli.common import resolve_overrides
from cusrl_tpu_torch.template.trial import Trial
from cusrl_tpu_torch.zoo.registry import get_experiment

SHRINK = ["--environment_kwargs.num_instances", "32", "--agent.actor_hidden_dims", "(32, 32)",
          "--agent.critic_hidden_dims", "(32, 32)", "--agent.num_steps_per_update", "8"]
ENTRY = ["-env", "Velocity-Flat", "-alg", "ppo", "--device", "cpu"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Two iterations with a checkpoint each and the jsonl logger; returns
    the log directory and the Trainer."""
    logs = tmp_path_factory.mktemp("cli") / "logs"
    trainer = main(["train", *ENTRY, "--num-iterations", "2", "--logger", "jsonl", "--seed", "0",
                    "--log-dir", str(logs), "--quiet", "--", *SHRINK, "--checkpoint_interval", "1"])
    return logs, trainer


def test_train_writes_the_run_directory(run):
    logs, trainer = run
    run_dir = os.path.realpath(logs / "latest")
    assert os.path.basename(run_dir).endswith("_Velocity-Flat_ppo")
    assert sorted(os.listdir(os.path.join(run_dir, "ckpt"))) == ["ckpt_1.npz", "ckpt_2.npz"]
    for name in ("metadata.json", "agent_info.txt", "workspace.txt"):
        assert os.path.isfile(os.path.join(run_dir, "info", name))
    metadata = json.load(open(os.path.join(run_dir, "info", "metadata.json")))
    assert metadata["experiment"] == "Velocity-Flat_ppo" and metadata["overrides"]["checkpoint_interval"] == "1"
    rows = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    assert [r["iteration"] for r in rows] == [0, 1]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert trainer.agent.device.type == "cpu" and trainer.environment.num_instances == 32


@pytest.mark.parametrize("what", ["checkpoint", "dir", "iteration"])
def test_trial_and_find_trial_match_jax(run, what, capsys):
    logs, _ = run
    for checkpoint in (None, "1"):
        trial, jax_trial = Trial(str(logs), checkpoint=checkpoint), JaxTrial(str(logs), checkpoint=checkpoint)
        for name in ("trial_dir", "checkpoint_path", "iteration", "name", "environment_name", "algorithm_name"):
            assert getattr(trial, name) == getattr(jax_trial, name), name
        assert trial.load_metadata() == jax_trial.load_metadata()
        argv = ["find-trial", "--log-dir", str(logs), "--what", what] + ([] if checkpoint is None else
                                                                       ["--checkpoint", checkpoint])
        main(argv)
        ours = capsys.readouterr().out
        jax_main(argv)
        assert ours == capsys.readouterr().out
    named = Trial(str(logs), "Velocity-Flat_ppo", checkpoint=str(logs / "latest"))
    assert (named.environment_name, named.algorithm_name, named.iteration) == ("Velocity-Flat", "ppo", 2)


def test_train_resumes_from_the_checkpoint(run, tmp_path):
    logs, trainer = run
    resumed = main(["train", *ENTRY, "--num-iterations", "3", "--logger", "none", "--log-dir", str(tmp_path),
                    "--checkpoint", str(logs / "latest"), "--quiet", "--inherit-args"])
    assert resumed.environment.num_instances == 32  # the recorded overrides replayed
    assert resumed.agent.iteration == 3 and resumed.stats.total_steps == 3 * 8 * 32
    assert Trial(str(tmp_path)).iteration == 3
    saved = trainer.agent.state_dict()["agent_state"]
    first = resumed.agent.actor.backbone.layers[0].weight
    assert not np.array_equal(first.detach().numpy(), saved["actor.backbone.layers.0.weight"])


def test_play_and_benchmark(run, capsys):
    logs, _ = run
    for command, extra in (("play", ["--num-steps", "5", "--stochastic"]), ("play", ["--num-episodes", "1"]),
                           ("benchmark", ["--num-steps", "12"])):
        # play: the trained 32 environments, unpaced, 6-step episodes; benchmark: the entry's 64.
        overrides = SHRINK + ["--timestep", "0", "--environment_kwargs.episode_length", "6"] if command == "play" \
            else SHRINK[2:]
        player = main([command, *ENTRY, "--log-dir", str(logs), "--checkpoint", str(logs / "latest"), *extra,
                       "--", *overrides])
        out = capsys.readouterr().out
        assert "step_reward" in out and "┌" in out
        assert player.agent.inference_mode and player.agent.deterministic == ("--stochastic" not in extra)
        assert player.environment.num_instances == (32 if command == "play" else 64)
        assert player.steps_taken == {"play": 5 if "--num-steps" in extra else 6, "benchmark": 12}[command]


def test_export_formats(run, tmp_path):
    logs, trainer = run
    for fmt, files in (("torch_export", {"graph.pt2", "manifest.yaml"}), ("package", {"policy.pkl", "manifest.yaml"})):
        main(["export", *ENTRY, "--log-dir", str(logs), "--checkpoint", str(logs / "latest"), "-o",
              str(tmp_path / fmt), "--format", fmt, "--batch-size", "8", "--", *SHRINK])
        assert set(os.listdir(tmp_path / fmt)) == files
    from cusrl_tpu_torch.export import load_exported_graph

    call, manifest = load_exported_graph(str(tmp_path / "torch_export"))
    assert manifest["inputs"]["observation"]["shape"] == [8, 48]
    obs = torch.tanh(torch.randn(8, 48, generator=torch.Generator().manual_seed(0)))
    agent = trainer.agent
    with torch.no_grad():
        normalized = agent.get_hook("observation_normalization").observation_rms.normalize(obs)
        want = agent.actor(normalized)[0]["mean"]
    torch.testing.assert_close(call({"observation": obs})["action"], want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ImportError, match="onnx"):
        main(["export", *ENTRY, "--log-dir", str(logs), "-o", str(tmp_path / "onnx"), "--format", "onnx",
              "--", *SHRINK])


def test_inherit_args_replays_recorded_overrides(run):
    logs, _ = run
    factory = get_experiment("Velocity-Flat", "ppo").to_training_factory()
    replayed, applied = resolve_overrides(factory, ["--num_iterations", "4"], Trial(str(logs)), inherit=True)
    assert replayed.agent.actor_hidden_dims == (32, 32) and replayed.environment_kwargs["num_instances"] == 32
    assert (replayed.checkpoint_interval, replayed.num_iterations) == (1, 4)
    assert applied["agent.num_steps_per_update"] == "8" and applied["num_iterations"] == "4"


@pytest.mark.parametrize("case", ["unknown_subcommand", "unknown_experiment", "bad_override_path",
                                  "missing_trial_dir", "cuda_without_a_card"])
def test_cli_errors(case, tmp_path, capsys):
    logs = str(tmp_path / "logs")
    argv, error = {
        "unknown_subcommand": (["frobnicate"], SystemExit),
        "unknown_experiment": (["train", "-env", "NoSuchEnv-v99", "--device", "cpu", "--num-iterations", "1",
                                "--logger", "none", "--log-dir", logs], KeyError),
        "bad_override_path": (["train", *ENTRY, "--num-iterations", "1", "--logger", "none", "--log-dir", logs,
                               "--quiet", "--", "--agent.no_such_field", "5"], AttributeError),
        "missing_trial_dir": (["find-trial", "--log-dir", str(tmp_path / "does_not_exist")], FileNotFoundError),
        "cuda_without_a_card": (["train", "-env", "Velocity-Flat", "--num-iterations", "1", "--logger", "none",
                                 "--log-dir", logs], RuntimeError),
    }[case]
    if case == "cuda_without_a_card" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(error):
        main(argv)
    if case != "cuda_without_a_card":  # the JAX CLI raises the same
        with pytest.raises(error):
            jax_main([a for a in argv if a not in ("--device", "cpu")])


def test_list_experiments_prints_the_registry(capsys):
    main(["list-experiments"])
    listed = capsys.readouterr().out.split()
    jax_main(["list-experiments"])
    assert listed == capsys.readouterr().out.split() and len(listed) == 42  # the IsaacLab, mjlab and robot_lab ones too
    assert {"Acrobot-v1_ppo", "BipedalWalker-v3_ppo", "CartPole-v1_ppo", "LunarLanderContinuous-v3_ppo",
            "MountainCar-v0_ppo", "MountainCarContinuous-v0_ppo", "Pendulum-v1_ppo", "Velocity-Flat_amp",
            "Velocity-Flat_ppo", "Velocity-Flat_recurrent_ppo", "Velocity-Flat_transformer_ppo",
            "Velocity-Rough_ppo", "Isaac-Velocity-Rough-Anymal-C-v0_ppo"} <= set(listed)
