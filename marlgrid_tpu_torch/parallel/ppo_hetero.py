"""Heterogeneous-agent PPO (PyTorch port): one policy per observation group.

Counterpart of ``marlgrid_tpu/parallel/ppo_hetero.py`` on one device. The
reference builds one ``GridAgentInterface`` per agent, each with its own
view size, offset and visibility flags; the agents that share a config form
an observation group (``vector.obs_groups``), and each group trains its own
``ActorCritic``. All groups' parameters sit under one Adam optimizer and one
global-norm clip, as the JAX package keeps them in one list pytree.

- The board is painted once per step (``pack_grid_with_agents``) and each
  group renders only its own observers against it, so a step's window work
  is that of one full render (kernel K1 launches once per group).
- Observations stay feature-major ``(n_g, F_g, B)`` uint8 end to end, as on
  the homogeneous encode path: the policy reads them as they come, the
  trajectory stores them, and the update cuts ``(G_g, F_g, c)`` blocks.
- Actions come from ``categorical(fold_in(step key, g), logits_g)``, and a
  static row permutation puts the groups' (n_g, B) rows back into agent
  order for the env step and the trajectory's (T, N, B) labels.
- GAE folds the agents into the batch as the homogeneous path does. Every
  epoch shuffles each group's (agent, step, env-chunk) blocks with its own
  ``permutation(fold_in(pk, g), G_g)``; a minibatch takes an equal share
  of every group's blocks, and the advantages are normalized over the union
  of the groups' samples, as one flat minibatch would be.

This module also holds what the recurrent (``ppo_hetero_rnn.py``) and the
mixed-style (``ppo_hetero_mixed.py``) trainers share: the group
observations, the rollout and the union-normalized loss. The network and
the optimizer are stateful torch objects, updated in place, as in
``ppo.py``.

Each trainer's ``make_train_step_*`` takes ``mesh=`` (a
``parallel/mesh.py`` Mesh), the JAX step's ``mesh=``: each rank steps its
slice of the global env batch (its rows of the unsharded rollout's pool,
draws and autoreset), the update gathers the trajectory in global env
order, and each minibatch's blocks are split over the ranks
(``ppo.Share``), so that the ranks compute the unsharded step of the
global batch together, as ``ppo.make_train_step(mesh=...)`` does.
"""
from __future__ import annotations

import contextlib
import warnings

import torch
from torch.nn import functional as F

from ..core import obs as obs_mod, rng, step as step_mod
from ..core.state import EnvParams
from ..device import const, resolve
from ..models import ActorCritic
from ..utils.profiling import stage
from ..vector import obs_groups
from .graph import GraphedStep
from .mesh import Mesh, gather_env
from .ppo import (PPOConfig, Share, _stack_states, block_size,
                  capture_error_mode, episode_metrics, local_batch,
                  make_optimizer, obs_blocks, pool_size, ppo_terms, rich_aux,
                  run_epochs, sample_actions, step_labels)

_LABELS = ("act", "logp", "val", "adv", "ret")


def hetero_groups(env_params: EnvParams):
    """The trainable observation groups of the all-encode trainer; exits
    naming the agents of a group with another style."""
    groups = obs_groups(env_params)
    for idxs, gp in groups:
        if gp.observation_style != "encode":
            raise SystemExit(
                f"hetero PPO trains 'encode' obs groups only; agents "
                f"{list(idxs)} use {gp.observation_style!r} (mixed styles "
                f"train through parallel/ppo_hetero_mixed.py)")
    return groups


def init_state_hetero(env_params: EnvParams, cfg: PPOConfig, generator=None,
                      device="cuda"):
    """``(nets, optimizer)``: one ActorCritic (mlp torso) per observation
    group, in a ``ModuleList``, with weights drawn from ``generator`` group
    after group, and Adam over all of them (``ppo.make_optimizer``)."""
    if not env_params.has_hetero_obs:
        raise ValueError("init_state_hetero: the params hold no per-agent "
                         "observation configs")
    if cfg.torso != "mlp":
        # the JAX trainer's nets assert the feature-major mlp path
        raise ValueError(f"all-encode hetero groups train with the mlp "
                         f"torso on feature-major codes, not "
                         f"torso={cfg.torso!r}")
    nets = torch.nn.ModuleList(
        ActorCritic(cfg, gp.view_size, generator, device=device)
        for _, gp in hetero_groups(env_params))
    return nets, make_optimizer(nets, cfg)


def styled(parent, gp: EnvParams):
    """The stage of a group's work under ``parent``: ``<parent>.encode``
    for codes, ``<parent>.pixels`` for image and rich views; no stage where
    ``parent`` is None."""
    if parent is None:
        return contextlib.nullcontext()
    return stage(f"{parent}.encode" if gp.observation_style == "encode"
                 else f"{parent}.pixels")


def group_obs(env_params: EnvParams, groups, torsos, state,
              pixels_only=False, span=None):
    """The policies' inputs, one ``(x, aux)`` per group, from one painted
    board (with the prestige levels when a group renders pixels): encode
    groups' feature-major codes (n_g, F_g, B) uint8, the pixel groups'
    (n_g, B, ...) images (s2d when the group's torso is 'cnn_s2d') with the
    'rich' features (n_g, B, d) or None. Each group renders only its own
    observers; B comes from the state. ``pixels_only``: None in place of
    every encode group's input (the update re-renders the pixel groups
    only). ``span``: each group renders in the stage ``<span>.encode`` or
    ``<span>.pixels`` (:func:`styled`); the shared board is painted
    outside them."""
    B = state.batch_size
    pixels = any(gp.observation_style != "encode" for _, gp in groups)
    packed = obs_mod.pack_grid_with_agents(env_params, state,
                                           with_lvl=pixels)
    out = []
    for (idxs, gp), torso in zip(groups, torsos):
        if gp.observation_style == "encode" and pixels_only:
            out.append(None)
            continue
        with styled(span, gp):
            if gp.observation_style == "encode":
                bm = obs_mod.all_obs_encode_b(gp, state, bminor=True,
                                              observers=idxs, packed=packed)
                out.append((bm.permute(1, 0, 2, 3, 4).reshape(
                    len(idxs), -1, B).to(torch.uint8), None))
            else:
                pov = obs_mod.all_obs_image_b(gp, state, bminor=True,
                                              s2d=torso == "cnn_s2d",
                                              observers=idxs, packed=packed)
                aux = (rich_aux(gp, state)
                       if gp.observation_style == "rich" else None)
                if aux is not None:
                    cols = const(idxs, torch.int64, aux.device)
                    aux = aux[:, cols].permute(1, 0, 2)
                out.append((pov, aux))
    return out


def group_loss(parts, cfg: PPOConfig, mesh: Mesh = None,
               count: float = None):
    """The clipped PPO objective over several groups' samples: ``parts``
    is a list of ``(logits, value, lab)``, one per group, each aligned
    sample for sample (``lab`` as in ``ppo.ppo_terms``, with ``adv``). The
    advantages are normalized with the mean and population std of the union
    of the groups' samples; each term is summed over every sample of every
    group and divided by their total count -> ``(total, {pg_loss, vf_loss,
    entropy, ratio_dev})``.

    ``mesh`` (the mesh path, as ``ppo.ppo_loss``'s ``share``): the samples
    are this rank's share of a global minibatch of ``count`` samples, and
    each ``lab`` holds ``w``, its samples' weights (1, or 0 on a padding
    block) broadcast against its terms. The union's mean and variance are
    each one ``psum`` of this rank's weighted sums over ``count``, every
    term is a weighted sum over ``count``, and the returned loss is this
    rank's part of the global one, which ``ppo.run_epochs`` sums."""
    advs = [lab["adv"] for _, _, lab in parts]
    if mesh is None:
        n = sum(a.numel() for a in advs)
        mean = sum(a.sum() for a in advs) / n
        std = torch.sqrt(sum(((a - mean) ** 2).sum() for a in advs)
                         / n) + 1e-8

        def wsum(x, lab):
            return x.sum()
    else:
        n = count

        def wsum(x, lab):
            return (lab["w"] * x).sum()

        labs = [lab for _, _, lab in parts]
        mean, = mesh.psum([sum(wsum(a, lab) for a, lab in zip(advs, labs))
                           / n])
        var, = mesh.psum([sum(wsum((a - mean) ** 2, lab)
                              for a, lab in zip(advs, labs)) / n])
        std = torch.sqrt(var) + 1e-8
    sums = [0.0] * 4
    for logits, value, lab in parts:
        terms = ppo_terms(logits, value, lab, (lab["adv"] - mean) / std, cfg)
        sums = [s + wsum(x, lab) for s, x in zip(sums, terms)]
    pg, vf, ent, dev = (s / n for s in sums)
    total = pg + cfg.vf_coef * vf - cfg.ent_coef * ent
    return total, dict(pg_loss=pg, vf_loss=vf, entropy=ent, ratio_dev=dev)


def label_rows(x, idxs):
    """Rows ``idxs`` (a group's agents) of a (T, N, B) label table."""
    return x[:, const(idxs, torch.int64, x.device)]


def make_rollout_hetero(env_params: EnvParams, cfg: PPOConfig, nets,
                        device="cuda", groups=None, torsos=None,
                        store_states=False, mesh: Mesh = None):
    """Build ``rollout(env_state, key, h=None) -> (env_state, key, traj,
    last_value, h)``, the JAX hetero trainers' ``rollout`` on one device.
    ``groups`` and ``torsos`` (per group) default to the all-encode
    trainer's (:func:`hetero_groups`, mlp).

    Per step t: every group's policy acts on its observations
    (:func:`group_obs`), group g samples its actions from
    ``categorical(fold_in(step key, g), logits_g)``, the groups' (n_g, B)
    rows go back into agent order, and the envs step with the pool autoreset
    (``board_pool`` layouts, rotated by t, salt t). With recurrent ``nets``
    ``h`` is the carry dict ``{g: (n_g, B, H) leaves}``, and a done flag
    zeroes its env's carry after the step.

    ``traj``: ``obs``, a list over groups of (T, n_g, F_g, B) uint8 codes
    (None for a pixel group); ``act``/``logp``/``val``/``rew`` (T, N, B);
    ``done``/``ep_*`` (T, B); with ``store_states``, ``state``, the pre-step
    EnvStates with (T, B, ...) leaves, which the update re-renders.
    ``last_value`` is (N, B). The stages run under the homogeneous
    rollout's stage spans (``ppo.make_rollout``); inside ``rollout.obs``
    and ``rollout.policy`` each group's render and forward run in a child
    stage named for its style, ``.encode`` or ``.pixels`` (:func:`styled`;
    the shared board is painted in ``rollout.obs`` itself).

    ``mesh``: on this rank's B = n_envs / D envs (and its slice of the
    carry), this rank's rows of the unsharded rollout of the global batch,
    as ``ppo.make_rollout``'s mesh path: the pool size K from the global
    batch and the pool's rows of this rank's envs, its rows of each
    group's global draw (``ppo.sample_actions``), ``env_offset = rank * B``;
    no collective.
    """
    from .ppo_rnn import mask_carry_env1

    dev = resolve(device)
    if groups is None:
        groups = hetero_groups(env_params)
    if torsos is None:
        torsos = ["mlp"] * len(groups)
    B, T = local_batch(cfg, mesh), cfg.rollout_len
    K = pool_size(cfg, cfg.n_envs)
    offset = 0 if mesh is None else mesh.data_index * B
    perm = [i for idxs, _ in groups for i in idxs]
    inv = const(sorted(range(len(perm)), key=perm.__getitem__), torch.int64,
                dev)
    encode = [gp.observation_style == "encode" for _, gp in groups]

    def rows(parts):
        """Per-group (n_g, B) parts -> (N, B) in agent order."""
        return torch.cat(parts, 0)[inv]

    def obs_of(state):
        with stage("rollout.obs"):
            return group_obs(env_params, groups, torsos, state,
                             span="rollout.obs")

    def policy(obs, h):
        """(logits, values, new carries) per group, each group's forward in
        ``rollout.policy.<style>``."""
        with stage("rollout.policy"):
            outs = []
            for g, (net, (x, aux)) in enumerate(zip(nets, obs)):
                with styled("rollout.policy", groups[g][1]):
                    outs.append(net(x, aux) if h is None
                                else net(x, h[g], aux))
            return ([o[0] for o in outs], [o[1] for o in outs],
                    None if h is None
                    else {g: o[2] for g, o in enumerate(outs)})

    @torch.no_grad()
    @stage("rollout")
    def rollout(env_state, key, h=None):
        key = key.to(dev)
        obs = obs_of(env_state)
        ks = rng.split(key)
        key, fk = ks[0], ks[1]
        with stage("rollout.fresh_pool"):
            pool = step_mod.fresh_pool(env_params, fk, K)
        names = ("act", "logp", "val", "rew", "done", "ep_ret", "ep_len",
                 "ep_cyc")
        steps = {k: [] for k in names}
        codes = [[] for _ in groups]
        states = []
        for t in range(T):
            logits, values, h_new = policy(obs, h)
            with stage("rollout.sample"):
                ks = rng.split(key)
                key, ak = ks[0], ks[1]
                acts, logps = [], []
                for g, lg in enumerate(logits):
                    a = sample_actions(rng.fold_in(ak, g), lg, None, B, 1,
                                       mesh)                      # (n_g, B)
                    acts.append(a)
                    logps.append(F.log_softmax(lg, -1).gather(
                        -1, a[..., None])[..., 0])
                act = rows(acts)
            with stage("rollout.env_step"):
                fresh_t = step_mod.fresh_pool_rows(pool, t, offset, B)
                stepped, rew, done, info = \
                    step_mod.step_autoreset_with_fresh_batch(
                        env_params, env_state, act.T, fresh_t,
                        env_offset=offset, salt=t)
                if h is not None:
                    h = {g: mask_carry_env1(hg, done, cfg.dtype)
                         for g, hg in h_new.items()}
            with stage("rollout.store"):
                # the stored obs is the PRE-step one, paired with the action
                for g, (x, _) in enumerate(obs):
                    if encode[g]:
                        codes[g].append(x)
                if store_states:
                    states.append(env_state)
                for k, v in zip(names, (
                        act.to(torch.int32), rows(logps), rows(values),
                        rew.T, done, info["episode_return"],
                        info["episode_length"], info["episode_cycles"])):
                    steps[k].append(v)
            env_state = stepped
            obs = obs_of(env_state)
        _, values, _ = policy(obs, h)
        with stage("rollout.store"):
            traj = {k: torch.stack(v) for k, v in steps.items()}
            traj["obs"] = [torch.stack(c) if c else None for c in codes]
            if store_states:
                traj["state"] = _stack_states(states)
            last_value = rows(values)
        return env_state, key, traj, last_value, h

    return rollout


def warn_dropped(what: str, G: int, used: int):
    if used < G:
        warnings.warn(
            f"{what}: {G} blocks do not divide into the minibatches; "
            f"dropping {G - used} block(s) per epoch", stacklevel=3)


def make_update_hetero(env_params: EnvParams, cfg: PPOConfig, nets,
                       optimizer, device="cuda", mesh: Mesh = None):
    """Build ``update(traj, last_value, key) -> metrics``, the update half
    of the JAX ``make_train_step_hetero``: GAE on (T, N*B), then per group
    the feature-major blocks ``(G_g, F_g, c)`` with G_g = n_g*T*(B//c)
    (agent, step, env-chunk) blocks (``ppo.block_size``) and their (G_g, c)
    labels. Per epoch, with ``pk = split(key)[1]``, group g's blocks are
    shuffled by ``permutation(fold_in(pk, g), G_g)`` and cut into
    ``n_minibatches`` equal shares; each minibatch is every group's share,
    one :func:`group_loss`, a backward pass, the global-norm clip over all
    groups' gradients and one Adam step. A group whose blocks do not divide
    into the minibatches drops the rest, with a warning.

    ``mesh``: the unsharded update of the global batch, as
    ``ppo.make_update``'s mesh path computes it: GAE on this rank's
    trajectory, then its labels and every group's codes gathered in global
    env order (one all-gather), the global trajectory's blocks (c and G_g
    from the global B), the same permutations on every rank, and each
    group's share of a minibatch split over the ranks (one ``ppo.Share``
    per group, padded at weight 0 where D does not divide it), the union's
    statistics and the gradients ``psum``'d."""
    dev = resolve(device)
    groups = hetero_groups(env_params)
    B, T, N = cfg.n_envs, cfg.rollout_len, env_params.n_agents
    c = block_size(B, T, N)
    G_gs = [len(idxs) * T * (B // c) for idxs, _ in groups]
    for g, G_g in enumerate(G_gs):
        if G_g < cfg.n_minibatches:
            raise SystemExit(
                f"hetero PPO: group {g} has {G_g} trajectory blocks (agents "
                f"x rollout x env chunks of {c}), fewer than --minibatches "
                f"{cfg.n_minibatches}")
    used_gs = [G_g // cfg.n_minibatches * cfg.n_minibatches for G_g in G_gs]
    params = [p for p in nets.parameters() if p.requires_grad]
    shares = [None] * len(groups)
    count = reduce = None
    if mesh is not None:
        shares = [Share(mesh, used // cfg.n_minibatches, c,
                        lambda w: w[:, None], dev) for used in used_gs]
        count = sum(sh.count for sh in shares)
        reduce = mesh.psum

    def minibatches(blocked):
        def gen(pk):
            with stage("update.minibatch"):
                perms = [rng.permutation(rng.fold_in(pk, g), G_g)[
                    :used].reshape(cfg.n_minibatches, -1)
                    for g, (G_g, used) in enumerate(zip(G_gs, used_gs))]
            for i in range(cfg.n_minibatches):
                batch = []
                with stage("update.minibatch"):
                    for g, sh in enumerate(shares):
                        idx = (perms[g][i] if sh is None
                               else perms[g][i][sh.pos])
                        b = {k: v[idx] for k, v in blocked[g].items()}
                        if sh is not None:
                            b["w"] = sh.w
                        batch.append(b)
                yield batch
        return gen

    def loss_fn(batch):
        with stage("update.forward"):
            # feature-major blocks (mb_g, F_g, c): logits (mb_g, c, A)
            parts = [net(b["obs"]) + (b,) for net, b in zip(nets, batch)]
            return group_loss(parts, cfg, mesh, count)

    @stage("update")
    def update(traj, last_value, key):
        with stage("update.gae"):
            per_step = step_labels(traj, last_value, cfg, False)
            codes = traj["obs"]
            if mesh is not None:
                with stage("update.all_gather"):
                    per_step, codes = gather_env(mesh, [(per_step, 2),
                                                        (tuple(codes), 3)])
            blocked = []
            for g, (idxs, _) in enumerate(groups):
                d = {k: label_rows(v, idxs).permute(1, 0, 2).reshape(
                    G_gs[g], c) for k, v in per_step.items()}
                d["obs"] = obs_blocks(codes[g], c)
                blocked.append(d)
        for g, (G_g, used) in enumerate(zip(G_gs, used_gs)):
            warn_dropped(f"hetero PPO minibatching, group {g}", G_g, used)
        return run_epochs(minibatches(blocked), loss_fn, params, optimizer,
                          key, cfg, dev, reduce)

    return update


def make_train_step_hetero(env_params: EnvParams, cfg: PPOConfig, nets,
                           optimizer, device="cuda", jit=True,
                           mesh: Mesh = None):
    """Build ``train_step(env_state, key) -> (env_state, key, metrics)``, the
    JAX ``make_train_step_hetero`` on one device: :func:`make_rollout_hetero`
    then :func:`make_update_hetero`, with the JAX step's key plumbing (the
    update takes the key the rollout returns; the key after the step is
    ``fold_in(that key, 1)``). ``nets`` and ``optimizer`` come from
    :func:`init_state_hetero` and are updated in place. ``jit`` as in
    ``ppo.make_train_step``: True (the default) gives one CUDA graph of the
    whole step on the card, its returned tensors donated; False the raw
    eager step (for ``ppo.multi_step``).

    ``mesh`` (the JAX ``mesh=``, the GSPMD step): this rank's part of the
    step over the global batch of ``cfg.n_envs`` envs, every rank with the
    same key, weights and optimizer state and its own B = n_envs / D envs
    (``ppo.init_env_batch(..., mesh=mesh)``): what the ranks compute
    together is the unsharded step of the global batch, up to the order of
    float sums; the episode tallies are ``psum``'d, and with ``jit=True``
    the collectives are captured in the graph."""
    dev = resolve(device)
    rollout = make_rollout_hetero(env_params, cfg, nets, device=dev,
                                  mesh=mesh)
    update = make_update_hetero(env_params, cfg, nets, optimizer, device=dev,
                                mesh=mesh)

    def train_step(env_state, key):
        env_state, key, traj, last_value, _ = rollout(env_state, key)
        metrics = episode_metrics(update(traj, last_value, key), traj, mesh)
        return env_state, rng.fold_in(key, 1), metrics

    return graphed(train_step, "ppo_hetero.make_train_step_hetero", mesh,
                   jit)


def graphed(train_step, name: str, mesh: Mesh, jit: bool):
    """A hetero trainer's step as ``make_train_step_*`` returns it: the raw
    step (``jit=False``) with the ``capture_error_mode`` that
    ``ppo.multi_step`` captures it in, or a ``GraphedStep`` of it named
    ``name`` (with ``(mesh=...)`` under a mesh)."""
    train_step.capture_error_mode = capture_error_mode(mesh)
    if not jit:
        return train_step
    if mesh is not None:
        name += "(mesh=...)"
    return GraphedStep(train_step, name, train_step.capture_error_mode)
