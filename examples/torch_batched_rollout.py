"""Batched usage demo on the PyTorch port: 16k envs stepping in lockstep on
the card.

The counterpart of ``examples/batched_rollout.py``: the first-class
batched API and the throughput counter, with the actions drawn by the
port's threefry (``core/rng.py``), as ``jax.random.randint`` draws them.
Runs on the card unless given ``--device cpu``:

    python examples/torch_batched_rollout.py [--device cpu] [--envs 16384]
"""
import argparse

import torch

from marlgrid_tpu_torch import EnvParams, default_agent_colors
from marlgrid_tpu_torch.core import rng
from marlgrid_tpu_torch.utils.metrics import Throughput
from marlgrid_tpu_torch.vector import VectorEnv


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--envs", type=int, default=16384)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    params = EnvParams(width=15, height=15, n_agents=3, scenario="cluttered",
                       observation_style="encode",
                       agent_colors=default_agent_colors(3))
    env = VectorEnv(params, n_envs=args.envs, device=args.device)
    key = rng.PRNGKey(0, device=args.device)
    state, obs = env.reset(key)

    thr = Throughput()
    ended = 0
    for t in range(args.iters):
        ks = rng.split(key)
        key, ak = ks[0], ks[1]
        actions = rng.randint(ak, (env.n_envs, params.n_agents), 0, 7)
        state, obs, rew, done, info = env.step(state, actions)
        n_done = int(done.sum())          # waits for the step, as
        ended += n_done                   # block_until_ready does
        print(f"iter {t}: {thr.update(env.n_envs):,.0f} env-steps/s, "
              f"{n_done} episodes ended")
    return dict(obs=tuple(obs.shape), ended=ended,
                finite=bool(torch.isfinite(rew.float()).all()))


if __name__ == "__main__":
    main()
