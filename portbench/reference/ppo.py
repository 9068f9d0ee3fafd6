"""The plain first PPO update, which the benchmark's check follows.

From the first rollout's raw observations, actions, rewards and flags, the
initial parameters and the minibatch plan, ``first_update`` works out, in
fp32 unless the model is told otherwise:

1. the running observation statistics step by step (every row of the
   first observation, then each step's next observation, then the rows of
   an observation that follows an episode's end), Chan's merge of
   population moments, and each step's normalized observation
   ``clamp((x - mean) / sqrt(var + 1e-8), -10, 10)``;
2. the rollout's policy: the distribution's mean at every step, and the
   log-probability of the recorded action;
3. the values and the next values (the truncation bootstrap, zero where
   an episode terminated), GAE, the returns, and the advantages
   standardized over the whole rollout (population variance, 1e-8);
4. the first ``steps`` minibatch steps of the plan: the value loss
   (``0.5 * mean((v - R)^2)``), the clipped surrogate, the entropy bonus,
   their gradients, one global-norm clip, and Adam (``torch.optim.Adam``'s
   arithmetic).

The model (``mlp.MlpActorCritic``, ``encoder.TransformerActorCritic``)
gives the networks; a temporal model's minibatches are whole environments
over all steps, another's are rows of the flattened rollout.  Imports
nothing of the program.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["FirstUpdate", "Hyper", "first_update", "normalize_observations", "gae"]

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class Hyper:
    gamma: float = 0.99
    lamda: float = 0.95
    clip_ratio: float = 0.2
    value_loss_weight: float = 0.5
    entropy_loss_weight: float = 0.005
    max_grad_norm: float = 1.0
    lr: float = 1e-3
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-8
    obs_clamp: float = 10.0
    obs_epsilon: float = 1e-8


@dataclasses.dataclass
class FirstUpdate:
    observation: torch.Tensor   # [T, N, D] normalized as each step acted on it
    mean: torch.Tensor          # [T, N, A] the rollout policy's mean
    logp: torch.Tensor          # [T, N, 1] of the recorded actions
    value: torch.Tensor         # [T, N, 1]
    advantage: torch.Tensor     # [T, N, 1] standardized
    returns: torch.Tensor       # [T, N, 1]
    losses: list                # per step: the total loss (0-d fp32)
    first_grads: dict           # the first step's gradients as the optimizer takes them (clipped)
    params: dict                # the parameters after ``steps`` steps


def _moments(x: torch.Tensor, mask: torch.Tensor | None):
    x = x.reshape(-1, x.shape[-1]).double()
    if mask is None:
        count = torch.tensor(float(x.shape[0]), dtype=torch.float64, device=x.device)
        mean = x.mean(0)
        return mean, (x - mean).square().mean(0), count
    m = mask.reshape(-1, 1).double()
    count = m.sum()
    mean = (x * m).sum(0) / count.clamp(min=1.0)
    return mean, ((x - mean).square() * m).sum(0) / count.clamp(min=1.0), count


def _merge(stats, batch):
    mean, var, count = stats
    b_mean, b_var, b_count = batch
    if float(b_count) == 0:
        return stats
    total = count + b_count
    w_new, w_old = b_count / total, count / total
    delta = b_mean - mean
    return mean + delta * w_new, var + (b_var - var) * w_new + delta.square() * (w_old * w_new), total


def normalize_observations(raw_obs, raw_next_obs, done, hp: Hyper):
    """``(observation, next_observation)`` ``[T, N, D]`` normalized with the
    statistics as they stood when each was used (see the module's list)."""
    steps, _, dim = raw_obs.shape
    stats = (torch.zeros(dim, dtype=torch.float64, device=raw_obs.device),
             torch.ones(dim, dtype=torch.float64, device=raw_obs.device),
             torch.zeros((), dtype=torch.float64, device=raw_obs.device))

    def apply(x):
        mean, var, _ = stats
        y = (x.double() - mean) / torch.sqrt(var + hp.obs_epsilon)
        return y.clamp(-hp.obs_clamp, hp.obs_clamp).float()

    obs, next_obs = [], []
    for t in range(steps):
        mask = None if t == 0 else done[t - 1].reshape(-1)
        if t == 0 or bool(mask.any()):
            stats = _merge(stats, _moments(raw_obs[t], mask))
        obs.append(apply(raw_obs[t]))
        stats = _merge(stats, _moments(raw_next_obs[t], None))
        next_obs.append(apply(raw_next_obs[t]))
    return torch.stack(obs), torch.stack(next_obs)


def gae(reward, done, value, next_value, gamma: float, lamda: float):
    delta = reward.float() + gamma * next_value - value
    not_done = 1.0 - done.float()
    advantage = torch.empty_like(delta)
    carry = torch.zeros_like(delta[0])
    for t in reversed(range(delta.shape[0])):
        carry = delta[t] + not_done[t] * gamma * lamda * carry
        advantage[t] = carry
    return advantage


def _normal_logp(mean, std, x):
    z = (x.float() - mean) / std
    return torch.sum(-0.5 * z.square() - torch.log(std) - _LOG_SQRT_2PI, dim=-1, keepdim=True)


def _minibatch_index(plan_perms: torch.Tensor, block: int, batch_size: int, epoch: int, index: int) -> torch.Tensor:
    per = batch_size // block
    units = plan_perms[epoch][index * per:(index + 1) * per]
    return (units[:, None] * block + torch.arange(block, device=units.device)).reshape(-1)


BLOCK_ROWS = 1 << 20  # rows a block of the reference's passes holds at once


def _env_blocks(envs: int, steps: int, block_rows: int) -> list[slice]:
    per = max(1, block_rows // max(steps, 1))
    return [slice(i, min(i + per, envs)) for i in range(0, envs, per)]


def _by_envs(fn, tensors, steps: int, block_rows: int):
    """``fn`` over blocks of environments (axis 1) of ``tensors``, its
    outputs (a tensor, a dict or a tuple of tensors) joined again."""
    outs = [fn(*(t[:, cut] for t in tensors)) for cut in _env_blocks(tensors[0].shape[1], steps, block_rows)]
    first = outs[0]
    if isinstance(first, dict):
        return {key: torch.cat([o[key] for o in outs], 1) for key in first}
    if isinstance(first, tuple):
        return tuple(torch.cat([o[i] for o in outs], 1) for i in range(len(first)))
    return torch.cat(outs, 1)


def first_update(model, params: dict, rollout: dict, plan_perms: torch.Tensor, block: int, mini_batches: int,
                 hp: Hyper, steps: int = 3, batch_fraction: float = 1.0, block_rows: int = BLOCK_ROWS) -> FirstUpdate:
    """``rollout``: ``raw_observation`` and ``raw_next_observation`` ``[T, N,
    D]``, ``action`` ``[T, N, A]``, ``reward``, ``terminated`` and
    ``truncated`` ``[T, N, 1]``.  ``plan_perms`` ``[epochs, units]`` orders
    the units of ``block`` rows (environments for a temporal model) of the
    first epoch's ``mini_batches`` minibatches.  ``batch_fraction`` below 1
    keeps only the first part of each minibatch (a planted fault).  Every
    pass runs over blocks of at most ``block_rows`` rows (whole
    environments), the minibatch's gradient summed over its blocks."""
    reward, terminated, truncated = rollout["reward"], rollout["terminated"], rollout["truncated"]
    done = terminated | truncated
    obs, next_obs = normalize_observations(rollout["raw_observation"], rollout["raw_next_observation"], done, hp)
    action = rollout["action"]
    params = {name: p.detach().float().clone() for name, p in params.items()}
    steps_count, envs = obs.shape[:2]
    with torch.no_grad():
        dist = _by_envs(lambda o, d: model.actor(params, o, d), (obs, done), steps_count, block_rows)
        rollout_mean = dist["mean"]
        logp = _normal_logp(rollout_mean, dist["std"], action)
        value, bootstrap = _by_envs(lambda o, n, d: model.critic_values(params, o, n, d), (obs, next_obs, done),
                                    steps_count, block_rows)
        next_value = torch.cat([value[1:], bootstrap[-1:]], 0)
        next_value = torch.where(truncated, bootstrap, next_value)
        next_value = torch.where(terminated, 0.0, next_value)
        advantage = gae(reward, done, value, next_value, hp.gamma, hp.lamda)
        returns = value + advantage
        flat = advantage.reshape(-1).double()
        advantage = ((advantage.double() - flat.mean()) / torch.sqrt(flat.var(unbiased=False) + 1e-8)).float()

    fields = {"observation": obs, "action": action, "logp": logp, "advantage": advantage, "returns": returns,
              "done": done}
    total = envs if model.temporal else steps_count * envs
    batch_size = total // mini_batches
    names = sorted(params)
    leaves = [params[name].requires_grad_(True) for name in names]
    exp_avg = [torch.zeros_like(p) for p in leaves]
    exp_avg_sq = [torch.zeros_like(p) for p in leaves]
    b1, b2 = hp.betas
    losses, first_grads = [], {}
    for step in range(steps):
        index = _minibatch_index(plan_perms, block, batch_size, step // mini_batches, step % mini_batches)
        index = index[:max(1, int(len(index) * batch_fraction))]
        current = dict(zip(names, leaves))
        grads = [torch.zeros_like(p) for p in leaves]
        loss_sum = torch.zeros((), dtype=torch.float64, device=obs.device)
        per = max(1, block_rows // steps_count) if model.temporal else block_rows
        for start in range(0, len(index), per):
            part = index[start:start + per]
            if model.temporal:
                batch = {key: value[:, part] for key, value in fields.items()}
            else:
                batch = {key: value.reshape(1, -1, value.shape[-1])[:, part] for key, value in fields.items()}
            loss = _minibatch_loss(model, current, batch, hp) * (len(part) / len(index))
            for g, d in zip(grads, torch.autograd.grad(loss, leaves)):
                g.add_(d)
            loss_sum += loss.detach().double()
        with torch.no_grad():
            norm = torch.sqrt(sum(g.double().square().sum() for g in grads))
            scale = min(1.0, hp.max_grad_norm / max(float(norm), 1e-12))
            grads = [g * scale for g in grads]
            if step == 0:
                first_grads = {name: g.clone() for name, g in zip(names, grads)}
            t = step + 1
            for p, g, m, v in zip(leaves, grads, exp_avg, exp_avg_sq):
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v / (1 - b2 ** t)).sqrt().add_(hp.eps)
                p.sub_(hp.lr * (m / (1 - b1 ** t)) / denom)
        losses.append(loss_sum.float())
    return FirstUpdate(obs, rollout_mean, logp, value, advantage, returns, losses, first_grads,
                       {name: p.detach() for name, p in zip(names, leaves)})


def _minibatch_loss(model, current: dict, batch: dict, hp: Hyper) -> torch.Tensor:
    """The PPO loss over the rows of ``batch``: the value loss, the clipped
    surrogate and the entropy bonus, each a mean over the rows."""
    dist = model.actor(current, batch["observation"], batch["done"])
    curr_value = model.critic(current, batch["observation"], batch["done"])
    value_loss = (curr_value - batch["returns"]).square().mean() * hp.value_loss_weight
    ratio = torch.exp(_normal_logp(dist["mean"], dist["std"], batch["action"]) - batch["logp"])
    adv = batch["advantage"]
    surrogate = -torch.minimum(adv * ratio, adv * ratio.clamp(1 - hp.clip_ratio, 1 + hp.clip_ratio)).mean()
    entropy = torch.sum(torch.log(dist["std"]) + 0.5 + _LOG_SQRT_2PI, dim=-1, keepdim=True)
    return value_loss + surrogate - entropy.mean() * hp.entropy_loss_weight
