"""Entry points of the PyTorch port, the counterpart of
``__graft_entry__.py``: the flagship policy's forward, and a dry run of
every train family over a ('data', 'model') mesh of ``torch.distributed``
ranks. Imports torch and ``marlgrid_tpu_torch`` only.

    fn, (params, obs) = entry()            # on the card; entry("cpu")
    logits, value = fn(params, obs)

    # in every rank of a process group of world size n:
    dryrun_multichip(n)                    # NCCL ranks, one card each
    dryrun_multichip(n, device="cpu")      # gloo ranks on the host
"""
import dataclasses

import torch


def _env_and_cfg(n_envs, rollout_len):
    from marlgrid_tpu_torch.core.state import EnvParams, default_agent_colors
    from marlgrid_tpu_torch.parallel import ppo

    ep = EnvParams(width=13, height=13, n_agents=4, scenario="goal_cycle",
                   n_clutter=10, n_bonus_tiles=3, reward_decay=False,
                   max_steps=50, view_size=7, observation_style="encode",
                   agent_colors=default_agent_colors(4))
    cfg = ppo.PPOConfig(n_envs=n_envs, rollout_len=rollout_len,
                        n_epochs=1, n_minibatches=2)
    return ep, cfg, ppo


def feature_major(obs: torch.Tensor) -> torch.Tensor:
    """Row-major encode codes (B, N, vs, vs, 3) -> the mlp torso's
    feature-major (B, 3*vs*vs, N) uint8 codes, feature ``p * vs*vs + cell``
    for plane p of cell ``vi * vs + vj``, as flax's OneHotEmbed indexes its
    per-cell weights in either layout."""
    B, N, vs = obs.shape[:3]
    return obs.reshape(B, N, vs * vs, 3).permute(0, 3, 2, 1).reshape(
        B, 3 * vs * vs, N).to(torch.uint8)


def entry(device="cuda"):
    """``(fn, (params, obs))``: the forward of the flagship model, the
    shared feedforward ``ActorCritic`` policy (mlp torso) on a batch of 32
    envs' egocentric encode observations, (32, 4, 7, 7, 3) int32 zeros
    (the inner op of every rollout step). ``params`` is the net's
    state_dict (weights drawn from seed 0) and ``fn(params, obs) ->
    (logits (32, 4, 7), value (32, 4))`` calls the net through
    ``torch.func.functional_call`` on it."""
    from marlgrid_tpu_torch.device import resolve

    dev = resolve(device)
    ep, cfg, ppo = _env_and_cfg(n_envs=32, rollout_len=8)
    net, _ = ppo.init_state(ep, cfg, torch.Generator().manual_seed(0),
                            device=dev)
    params = {k: v.detach() for k, v in net.state_dict().items()}
    obs = torch.zeros((32, ep.n_agents, ep.view_size, ep.view_size, 3),
                      dtype=torch.int32, device=dev)

    def fn(params, obs):
        return torch.func.functional_call(net, params, (feature_major(obs),))

    return fn, (params, obs)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run ONE full training step (rollout + PPO update) of each train
    family over an ``n_devices``-rank mesh, with real dp (the env batch
    over 'data') and, for the feedforward family, tp (the policy over
    'model'), on tiny shapes; returns each family's loss.

    Call it in every rank of an initialized default process group of world
    size ``n_devices`` (NCCL ranks with ``device="cuda"``, one card each;
    gloo ranks with ``device="cpu"``). As in ``__graft_entry__.py``: a
    'model' axis of 2 when ``n_devices`` is even and above 1, envs
    ``max(8, 2 * n_devices)``, ``rollout_len=4``, the keys ``fold_in(key,
    1..14)``, and seven families: feedforward, tensor-parallel under the
    JAX dry run's rule (``tensor_parallel.TensorParallelActorCritic``);
    GRU; hetero; GRU with ``bptt_window=2`` through the explicit-collective
    step; image GRU (``cnn_s2d``); hetero recurrent; mixed style. All but
    the first hold replicated weights (rank 0's). Each asserts a finite
    loss."""
    import torch.distributed as dist

    from marlgrid_tpu_torch.core import rng
    from marlgrid_tpu_torch.device import resolve
    from marlgrid_tpu_torch.parallel import (ppo_hetero, ppo_hetero_mixed,
                                             ppo_hetero_rnn, ppo_rnn,
                                             tensor_parallel)
    from marlgrid_tpu_torch.parallel.mesh import broadcast_from, make_mesh
    from marlgrid_tpu_torch.parallel.train import local_carry

    dev = resolve(device)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) runs in every rank "
                         f"of a default process group of world size "
                         f"{n_devices}, not {world or 'none'}")
    n_model = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(n_data=n_devices // n_model, n_model=n_model,
                     device=dev)

    n_envs = max(8, 2 * n_devices)
    ep, cfg, ppo = _env_and_cfg(n_envs=n_envs, rollout_len=4)
    key = rng.PRNGKey(0, device=dev)

    def gen():
        return torch.Generator().manual_seed(0)

    def replicated(net, opt):
        broadcast_from(mesh, list(net.state_dict().values()), world=True)
        return net, opt

    def env(ep_, i):
        return ppo.init_env_batch(ep_, n_envs, rng.fold_in(key, i),
                                  device=dev, mesh=mesh)

    losses = {}

    def check(name, metrics, what):
        loss = float(metrics["loss"])
        assert torch.isfinite(torch.tensor(loss)).item(), \
            f"non-finite loss in {what}"
        losses[name] = loss

    # tensor-parallel params: the torso/head matmuls sharded over 'model'
    net = tensor_parallel.TensorParallelActorCritic(cfg, ep.view_size, mesh,
                                                    gen(), device=dev)
    opt = ppo.make_optimizer(net, cfg)
    tensor_parallel.broadcast_state(mesh, net, opt)
    step = ppo.make_train_step(ep, cfg, net, opt, device=dev, mesh=mesh)
    *_, metrics = step(env(ep, 1), rng.fold_in(key, 2))
    check("feedforward", metrics, "dryrun")

    # recurrent family (GRU): same dp mesh, hidden state sharded over
    # 'data' alongside the env batch
    cfg_r = dataclasses.replace(cfg, rnn="gru", hidden=32)
    net_r, opt_r, h = ppo_rnn.init_state_rnn(ep, cfg_r, gen(), device=dev)
    replicated(net_r, opt_r)
    step_r = ppo_rnn.make_train_step_rnn(ep, cfg_r, net_r, opt_r,
                                         device=dev, mesh=mesh)
    *_, metrics = step_r(env(ep, 3), local_carry(mesh, h, 1),
                         rng.fold_in(key, 4))
    check("gru", metrics, "recurrent dryrun")

    # heterogeneous agent family: per-obs-group torsos in one program
    ep_h = ep.replace(agent_view_sizes=(5, 7, 5, 5))
    nets_h, opt_h = replicated(*ppo_hetero.init_state_hetero(
        ep_h, cfg, gen(), device=dev))
    step_h = ppo_hetero.make_train_step_hetero(ep_h, cfg, nets_h, opt_h,
                                               device=dev, mesh=mesh)
    *_, metrics = step_h(env(ep_h, 5), rng.fold_in(key, 6))
    check("hetero", metrics, "hetero dryrun")

    # recurrent + truncated BPTT under EXPLICIT collectives: the shard_map
    # step with the carry partitioned over 'data' alongside the env batch
    cfg_w = dataclasses.replace(cfg_r, bptt_window=2)
    net_w, opt_w, h_w = ppo_rnn.init_state_rnn(ep, cfg_w, gen(), device=dev)
    replicated(net_w, opt_w)
    step_w = ppo_rnn.make_train_step_rnn_shard_map(ep, cfg_w, net_w, opt_w,
                                                   mesh, device=dev)
    *_, metrics = step_w(env(ep, 7), local_carry(mesh, h_w, 1),
                         rng.fold_in(key, 8))
    check("gru_bptt_shard_map", metrics, "recurrent shard_map dryrun")

    # rendered-obs recurrent family (image POV + GRU + EnvState store):
    # the carry (B, N, H), env-leading, sharded over 'data'
    ep_i = ep.replace(observation_style="image", view_size=5,
                      view_tile_size=4)
    cfg_i = dataclasses.replace(cfg_r, torso="cnn_s2d")
    net_i, opt_i, h_i = ppo_rnn.init_state_rnn(ep_i, cfg_i, gen(),
                                               device=dev)
    replicated(net_i, opt_i)
    step_i = ppo_rnn.make_train_step_rnn(ep_i, cfg_i, net_i, opt_i,
                                         device=dev, mesh=mesh)
    *_, metrics = step_i(env(ep_i, 9), local_carry(mesh, h_i, 0),
                         rng.fold_in(key, 10))
    check("gru_image", metrics, "image-recurrent dryrun")

    # heterogeneous RECURRENT family: per-group memory policies, per-group
    # carries sharded over 'data' alongside the env batch
    nets_hr, opt_hr, h_hr = ppo_hetero_rnn.init_state_hetero_rnn(
        ep_h, cfg_r, gen(), device=dev)
    replicated(nets_hr, opt_hr)
    step_hr = ppo_hetero_rnn.make_train_step_hetero_rnn(
        ep_h, cfg_r, nets_hr, opt_hr, device=dev, mesh=mesh)
    *_, metrics = step_hr(env(ep_h, 11), local_carry(mesh, h_hr, 1),
                          rng.fold_in(key, 12))
    check("hetero_gru", metrics, "hetero-recurrent dryrun")

    # mixed-STYLE hetero family (encode + image groups training together):
    # pixel groups re-render from the dp-sharded EnvState store
    ep_m = ep.replace(view_size=5, view_tile_size=4,
                      agent_view_sizes=(5, 5, 5, 5),
                      agent_obs_styles=("encode", "image", "encode",
                                        "encode"))
    nets_m, opt_m = replicated(*ppo_hetero_mixed.init_state_hetero_mixed(
        ep_m, cfg, gen(), device=dev))
    step_m = ppo_hetero_mixed.make_train_step_hetero_mixed(
        ep_m, cfg, nets_m, opt_m, device=dev, mesh=mesh)
    *_, metrics = step_m(env(ep_m, 13), rng.fold_in(key, 14))
    check("mixed", metrics, "mixed-style hetero dryrun")
    return losses
