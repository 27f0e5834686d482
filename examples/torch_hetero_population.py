"""Heterogeneous population training on the PyTorch port: the per-agent
GridAgentInterface surface end to end.

The counterpart of ``examples/hetero_population.py``. Every agent picks
its own view geometry and observation style, and the population trains in
one step on the card: encode groups on the feature-major mlp path, pixel
groups on the sprite pipeline with a shared EnvState store
(``parallel/ppo_hetero_mixed.py``). Equivalent CLI:

    python -m marlgrid_tpu_torch.parallel.train --scenario goal_cycle \\
      --grid-size 13 --agent-config '[
        {"view_size": 7},
        {"view_size": 5, "observe_rewards": true,
         "observation_style": "rich"},
        {"view_size": 7, "observation_style": "image"},
        {"view_size": 5}]' --envs 4096 --iters 100

Recurrent populations (``--rnn gru|lstm``) use
``parallel/ppo_hetero_rnn.py`` (encode obs). This example runs small
shapes; it runs on the card unless given ``--device cpu``:

    python examples/torch_hetero_population.py [--device cpu] [--envs 64]
"""
import argparse

import torch

from marlgrid_tpu_torch.agents import (GridAgentInterface,
                                       agents_to_params_fields)
from marlgrid_tpu_torch.core import rng
from marlgrid_tpu_torch.core.state import EnvParams
from marlgrid_tpu_torch.parallel import ppo, ppo_hetero_mixed


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--envs", type=int, default=64)
    ap.add_argument("--rollout", type=int, default=16)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)
    agents = [
        GridAgentInterface(color="red", view_size=7),
        GridAgentInterface(color="blue", view_size=5,
                           observation_style="rich", observe_rewards=True),
        GridAgentInterface(color="purple", view_size=5, view_tile_size=4,
                           observation_style="image"),
    ]
    ep = EnvParams(width=11, height=11, scenario="goal_cycle",
                   n_bonus_tiles=3, max_steps=50, reward_decay=False,
                   **agents_to_params_fields(agents))
    cfg = ppo.PPOConfig(n_envs=args.envs, rollout_len=args.rollout,
                        n_epochs=1, n_minibatches=2)

    key = rng.PRNGKey(0, device=args.device)
    nets, opt = ppo_hetero_mixed.init_state_hetero_mixed(
        ep, cfg, torch.Generator().manual_seed(0), device=args.device)
    env_state = ppo.init_env_batch(ep, cfg.n_envs, rng.fold_in(key, 1),
                                   device=args.device)
    step = ppo_hetero_mixed.make_train_step_hetero_mixed(
        ep, cfg, nets, opt, device=args.device)

    losses = []
    for it in range(args.iters):
        env_state, key, m = step(env_state, key)
        losses.append(float(m["loss"]))
        print(f"iter {it}: loss {losses[-1]:+.4f} "
              f"entropy {float(m['entropy']):.3f} "
              f"return {float(m['episode_return']):.2f}")
    print(f"{len(nets)} groups (encode / rich / image) trained in one step.")
    return losses


if __name__ == "__main__":
    main()
