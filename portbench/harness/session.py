"""One run of a cell: set-up, the measured window, the traced chunk, and
what the check reads.

Set-up builds the Trainer that ``get_experiment(env, alg)
.to_training_factory()`` gives, with the cell's environments, the
harness's window hook (a ``TrainerHook``) and two agent hooks registered
through the agent factory's ``register_hook`` (``FirstUpdateCapture``
last, ``LayerSpans`` first), writes the weights and the environment's
fixed matrices made from the seed (``make_inputs``), and runs the first
chunk through ``Trainer.run_training_loop``: that chunk warms up every
shape the cell uses, and its first update is recorded for the check.  The
window then measures whole chunks, each ending in the chunk's one host
transfer, until ``seconds`` have passed: a run that is not traced records
the device's activity over the whole window (``trace.DeviceTime``), and a
traced run leaves the window unprofiled and profiles one more chunk after
it.  The loop is left by ``StopWindow`` from the hook.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time

import torch

from cusrl_tpu_torch.template.hook import Hook

__all__ = ["FirstUpdateCapture", "LayerSpans", "Run", "StopWindow", "WindowHook", "make_inputs", "make_weights",
           "process_age_s", "run"]


def process_age_s() -> float:
    """Seconds since this process started (the kernel's record of it)."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


class StopWindow(Exception):
    """Raised by the window hook to leave the training loop."""


def make_inputs(config: dict, seed: int, device):
    """``(generator, environment matrices)`` from ``seed``, on ``device``:
    the environment's actuation ``[2, A]`` and observation projection
    ``[8 + A, D]``, ``N(0, 1) / sqrt(fan)``; the generator goes on to
    ``make_weights``."""
    generator = torch.Generator(device=device).manual_seed(seed)
    obs_dim, act_dim = config["observation_dim"], config["action_dim"]
    raw_dim = 8 + act_dim
    env = torch.randn(2 * act_dim + raw_dim * obs_dim, generator=generator, device=device)
    matrices = {"actuation": (env[:2 * act_dim].reshape(2, act_dim) / math.sqrt(act_dim)).cpu(),
                "obs_proj": (env[2 * act_dim:].reshape(raw_dim, obs_dim) / math.sqrt(raw_dim)).cpu()}
    return generator, matrices


def make_weights(model: torch.nn.Module, config: dict, generator: torch.Generator, device) -> dict:
    """Every leaf of ``model`` from ``generator`` in one draw: a matrix
    ``N(0, 1) * gain / sqrt(fan_in)`` (``config["init"]``: a default gain
    and gains by path prefix), a vector named ``weight`` or ``scale`` (a
    norm's gain) 1, any other leaf 0."""
    named = list(model.named_parameters())
    mats = [(name, p) for name, p in named if p.dim() == 2]
    flat = torch.randn(sum(p.numel() for _, p in mats), generator=generator, device=device)
    init = config["init"]
    weights, offset = {}, 0
    for name, p in mats:
        gain = init["gain"]
        for prefix, value in init.get("gains", {}).items():
            if name == prefix or name.startswith(prefix + "."):
                gain = value
        weights[name] = flat[offset:offset + p.numel()].reshape(p.shape) * (gain / math.sqrt(p.shape[1]))
        offset += p.numel()
    for name, p in named:
        if p.dim() != 2:
            gain = name.endswith(("weight", "scale"))
            weights[name] = torch.full(p.shape, 1.0 if gain else 0.0, device=device)
    return weights


class FirstUpdateCapture(Hook):
    """An agent hook, last in the agent's list, that records the first
    update: the rollout it takes (raw and normalized observations, actions,
    the rollout policy's mean, rewards, flags), the values, advantages and
    returns once the other hooks' ``pre_update`` has run, the minibatch plan
    (drawn again from a copy of the agent's generator as the update is about
    to draw it), the first ``steps`` minibatch losses (the sum of the other
    hooks' objectives, read through their ``objective`` callbacks), the
    first gradient as the optimizer takes it (``pre_optim`` of the first
    step) and the parameters after ``steps`` steps (``pre_optim`` of the
    next).  It also counts the first steps whose minibatch is not the plan's
    rows (``plan_steps_differ``).  Once done it turns itself off; the copies
    stay on the device until ``to_host``."""

    FIELDS = {"raw_observation": "original_observation", "raw_next_observation": "original_next_observation",
              "observation": "observation", "action": "action", "reward": "reward", "terminated": "terminated",
              "truncated": "truncated"}

    def __init__(self, temporal: bool, steps: int = 3):
        super().__init__(name="portbench_first_update")
        self.temporal = temporal
        self.steps = steps
        self.rollout: dict = {}
        self.update: dict = {}
        self.losses: list = []
        self.plan = None
        self.first_grads: dict = {}
        self.params: dict = {}
        self.plan_steps_differ = 0
        self._terms: list = []
        self._observed: list = []
        self._optimizer_steps = 0

    def pre_update(self, agent, rollout: dict) -> dict:
        self.rollout = {key: rollout[field].detach().clone() for key, field in self.FIELDS.items()}
        self.rollout["mean"] = rollout["action_dist"]["mean"].detach().clone()
        self.update = {key: rollout[key].detach().float().clone() for key in ("value", "advantage", "return")}
        generator = torch.Generator(device=agent.device)
        generator.set_state(agent.generator.get_state())
        capacity, parallelism = rollout["action"].shape[:2]
        plan = agent.sampler.resolve(rollout).make_epoch_plan(capacity, parallelism, generator, agent.device)
        self.plan = (plan.perms.clone(), plan.block, plan.num_mini_batches)
        for hook in agent.hooks:
            if hook is not self and hook.active:
                self._observe(hook)
        return {}

    def _observe(self, hook) -> None:
        inner = hook.objective

        def objective(agent, metadata, batch):
            objectives, metrics = inner(agent, metadata, batch)
            scale = batch.get("__objective_scales__", {}).get(hook.hook_name)
            for value in (objectives or {}).values():
                self._terms.append(value.detach().float() * (1.0 if scale is None else scale))
            return objectives, metrics

        hook.objective = objective
        self._observed.append(hook)

    def objective(self, agent, metadata: dict, batch: dict):
        step = len(self.losses)
        if step == self.steps:
            return None, {}
        perms, block, mini_batches = self.plan
        per = perms.shape[1] // mini_batches
        units = perms[step // mini_batches][(step % mini_batches) * per:(step % mini_batches + 1) * per]
        rows = (units[:, None] * block + torch.arange(block, device=units.device)).reshape(-1)
        observation = self.rollout["observation"]
        want = observation[:, rows] if self.temporal else observation.reshape(-1, observation.shape[-1])[rows]
        have = batch["observation"]
        if have.shape != want.shape or not torch.equal(have, want):
            self.plan_steps_differ += 1
        self.losses.append(sum(self._terms))
        self._terms = []
        if len(self.losses) == self.steps:
            for hook in self._observed:
                del hook.objective  # the class's callback again
            self._observed = []
        return None, {}

    def pre_optim(self, agent) -> dict:
        self._optimizer_steps += 1
        if self._optimizer_steps == 1:
            self.first_grads = {name: p.grad.detach().clone() for name, p in agent.model.named_parameters()
                                if p.grad is not None}
        if self._optimizer_steps == self.steps + 1:
            self.params = {name: p.detach().clone() for name, p in agent.model.named_parameters()}
            self.active = False
        return {}

    def to_host(self) -> None:
        """Moves every copy to the host, so that none counts in the window's
        device memory."""
        def host(value):
            return value.cpu() if isinstance(value, torch.Tensor) else value
        self.rollout = {k: host(v) for k, v in self.rollout.items()}
        self.update = {k: host(v) for k, v in self.update.items()}
        self.losses = [host(v) for v in self.losses]
        self.plan = None if self.plan is None else (host(self.plan[0]), *self.plan[1:])
        self.first_grads = {k: host(v) for k, v in self.first_grads.items()}
        self.params = {k: host(v) for k, v in self.params.items()}

    @property
    def complete(self) -> bool:
        return bool(self.rollout and self.update and self.plan is not None and self.first_grads and self.params
                    and len(self.losses) == self.steps)


class LayerSpans(Hook):
    """An agent hook, first in the agent's list and on only for the traced
    chunk, that opens ``record_function`` ranges at the agent's lifecycle
    points: ``portbench.rollout`` (the first ``pre_act`` of a rollout to
    ``pre_update``), ``portbench.act`` (``pre_act`` to ``post_act``: the
    policy step), ``portbench.env_step`` (``post_act`` to ``post_step``:
    the environment's step), ``portbench.update`` (``pre_update`` to
    ``post_update``) and ``portbench.minibatch`` (``objective`` to
    ``post_objective``: a minibatch's forward, backward and optimizer
    step).  The trace's idle gaps are named by them."""

    def __init__(self):
        super().__init__(name="portbench_spans", active=False)
        self._open: list = []

    def _enter(self, label: str) -> None:
        from torch.profiler import record_function

        span = record_function(label)
        span.__enter__()
        self._open.append((label, span))

    def _exit(self, label: str) -> None:
        if self._open and self._open[-1][0] == label:
            self._open.pop()[1].__exit__(None, None, None)

    def close(self) -> None:
        while self._open:
            self._open.pop()[1].__exit__(None, None, None)

    def pre_act(self, agent, transition: dict) -> None:
        if not self._open:
            self._enter("portbench.rollout")
        self._enter("portbench.act")

    def post_act(self, agent, transition: dict) -> None:
        self._exit("portbench.act")
        self._enter("portbench.env_step")

    def post_step(self, agent, transition: dict) -> None:
        self._exit("portbench.env_step")

    def pre_update(self, agent, rollout: dict) -> dict:
        self._exit("portbench.rollout")
        self._enter("portbench.update")
        return {}

    def objective(self, agent, metadata: dict, batch: dict):
        self._enter("portbench.minibatch")
        return None, {}

    def post_objective(self, agent, metadata: dict, batch: dict) -> dict:
        self._exit("portbench.minibatch")
        return {}

    def post_update(self, agent, rollout: dict, snapshot=None) -> dict:
        self._exit("portbench.update")
        return {}


class WindowHook:
    """A ``TrainerHook`` that tells chunks apart by the Trainer's host
    transfers and counts the iterations in each: the warm-up chunk, then
    the window's chunks until ``seconds`` have passed since the window's
    start (the end of set-up, after the warm-up's transfer; the window's
    end calls ``on_window_end``), then (traced) one chunk under the
    profiler; ``seconds`` None stops after the warm-up."""

    def __init__(self, seconds: float | None, traced: bool, on_window_start, on_window_end, on_trace_start,
                 on_trace_end):
        self.seconds = seconds
        self.traced = traced
        self.on_window_start = on_window_start
        self.on_window_end = on_window_end
        self.on_trace_start = on_trace_start
        self.on_trace_end = on_trace_end
        self.iterations = 0
        self.transfers = 0
        self.phase = "warmup"
        self.t_start = self.t_end = None
        self.window_from = self.trace_from = 0
        self.window_iterations = 0
        self.chunk_ends: list[float] = []
        self.failed = 0

    def init(self, trainer) -> None:
        pass

    def pre_iteration(self, trainer) -> None:
        if self.phase == "trace_next":  # the first iteration after a transfer
            self.phase = "traced"
            self.trace_from = self.iterations
            self.on_trace_start()
        self.iterations += 1

    def post_iteration(self, trainer, metrics: dict) -> None:
        if self.phase == "window" and not all(math.isfinite(float(v)) for v in metrics.values()):
            self.failed += 1
        if trainer.host_transfers == self.transfers:
            return
        self.transfers = trainer.host_transfers
        if self.phase == "warmup":
            self.phase = "window"
            self.window_from = self.iterations
            self.on_window_start()  # set-up's last work: the clock starts after it
            self.t_start = self.t_end = time.perf_counter()
            if self.seconds is None:  # set-up only: the check's readings
                raise StopWindow
            return
        now = time.perf_counter()
        if self.phase == "window":
            self.window_iterations = self.iterations - self.window_from
            self.t_end = now
            self.chunk_ends.append(now - self.t_start)
            if now - self.t_start >= self.seconds:
                self.on_window_end()
                if not self.traced:
                    raise StopWindow
                self.phase = "trace_next"
        elif self.phase == "traced":
            self.on_trace_end(self.iterations - self.trace_from)
            raise StopWindow


@dataclasses.dataclass
class Run:
    """What a run measured and recorded."""
    setup_s: float
    window_s: float
    window_iterations: int
    failed: int
    env_steps: int                 # environment steps in the window
    memory_peak_bytes: int
    capture: FirstUpdateCapture
    initial_weights: dict
    trace: object = None           # trace.Trace of the traced chunk
    chunk_ends: list = dataclasses.field(default_factory=list)  # seconds from the window's start to each transfer
    window_device_s: float | None = None  # the device's busy seconds over the window (runs not traced, on a card)
    window_device_events: int = 0


def _agent_factory(config: dict):
    """The zoo entry's training factory, its agent factory checked against
    the configuration file."""
    from cusrl_tpu_torch.zoo import get_experiment

    experiment = config["experiment"]
    factory = get_experiment(experiment["environment"], experiment["algorithm"]).to_training_factory()
    for key, value in config.get("overrides", {}).items():
        setattr(factory.agent, key, tuple(value) if isinstance(value, list) else value)
    for key, value in config["agent"].items():
        have = getattr(factory.agent, key)
        want = tuple(value) if isinstance(value, list) else value
        if have != want:
            raise ValueError(f"the zoo entry's {key} is {have!r}, the configuration file's {want!r}")
    return factory


def run(cell, seed: int, seconds: float | None, traced: bool, device) -> tuple[Run, object]:
    """Runs the cell; returns ``(Run, trainer)``."""
    from cusrl_tpu_torch.nn.kernels import banded_attention, fused_block, fused_mlp, lane_attention

    from portbench.harness import trace as trace_module

    on_card = torch.device(device).type == "cuda"
    config, traffic = cell.config, cell.traffic
    factory = _agent_factory(config)
    factory.num_iterations = 10 ** 9  # the loop ends by the window, not by the entry's iteration count
    factory.iterations_per_dispatch = traffic["iterations_per_dispatch"]
    capture, spans = FirstUpdateCapture(temporal=config["kind"] != "mlp"), LayerSpans()
    factory.agent = factory.agent.to_underlying().register_hook(capture).register_hook(spans, index=0)
    counters = (fused_mlp.LAUNCHES, fused_block.LAUNCHES, lane_attention.LAUNCHES, banded_attention.LAUNCHES)
    state = {}

    def launches():
        return {key: value for table in counters for key, value in table.items()}

    def window_start():
        if not capture.complete:
            raise RuntimeError("the first update was not recorded whole: the check has nothing to compare")
        capture.to_host()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        state["setup_s"] = process_age_s()
        if on_card and not traced and seconds is not None:
            state["device_time"] = trace_module.DeviceTime().__enter__()

    def window_end():
        device_time = state.pop("device_time", None)
        if device_time is not None:
            state["window_device"] = device_time.finish()

    def trace_start():
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        state["launches"] = launches()
        state["session"] = trace_module.record(lambda: profile(activities=activities)).__enter__()
        state["trace_t0"] = time.perf_counter()
        spans.active = True

    def trace_end(iterations: int):
        window_s = time.perf_counter() - state["trace_t0"]
        spans.active = False
        spans.close()
        after = launches()
        state["trace"] = state["session"].finish(window_s, iterations,
                                                 {k: after[k] - state["launches"][k] for k in after})

    hook = WindowHook(seconds, traced, window_start, window_end, trace_start, trace_end)
    factory.trainer_hooks = (hook,)
    generator, matrices = make_inputs(config, seed, device)
    factory.environment_kwargs = {**factory.environment_kwargs, "num_instances": traffic["environments_per_chip"],
                                  "seed": seed, **matrices}
    trainer = factory(logger_factory=None, verbose=False, device=device, seed=seed)
    weights = make_weights(trainer.agent.model, config, generator, device)
    with torch.no_grad():
        for name, p in trainer.agent.model.named_parameters():
            p.copy_(weights[name])
    try:
        trainer.run_training_loop()
    except StopWindow:
        pass
    iterations = hook.window_iterations
    steps = iterations * trainer.agent.num_steps_per_update * trainer.environment.num_instances
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    result = Run(setup_s=state["setup_s"], window_s=hook.t_end - hook.t_start, window_iterations=iterations,
                 failed=hook.failed, env_steps=steps, memory_peak_bytes=peak, capture=capture,
                 initial_weights={k: v.detach().cpu() for k, v in weights.items()}, trace=state.get("trace"),
                 chunk_ends=list(hook.chunk_ends),
                 window_device_s=state.get("window_device", (None, 0))[0],
                 window_device_events=state.get("window_device", (None, 0))[1])
    return result, trainer
