"""Custom-environment demo on the PyTorch port: the reference's
``_gen_grid``-subclass workflow.

The counterpart of ``examples/custom_env.py``: a custom scenario
registered with WorldObj placement events (drawn inside the batched reset),
and interactive host-side board editing with ``place_obj``. Agents carry
prestige (sprite dims as they collect bonus rewards) and staggered spawn
delays. Runs on the card unless given ``--device cpu``:

    python examples/torch_custom_env.py [--device cpu] [--max-steps 60]
"""
import argparse
import importlib.util
import os
import tempfile

import numpy as np

from marlgrid_tpu_torch import objects as O
from marlgrid_tpu_torch.agents import GridAgentInterface
from marlgrid_tpu_torch.core import grid_gen
from marlgrid_tpu_torch.utils.video import GridRecorder
from marlgrid_tpu_torch.wrapper import MultiGridEnv


def lava_maze(params, layers, split_x, door_y):
    """8 lava hazards, 3 cyclic bonus tiles, placed via WorldObj events."""
    events = [O.Lava() for _ in range(8)]
    events += [O.BonusTile(bonus_id=b) for b in range(3)]
    return layers, events, None


grid_gen.register_scenario("lava_maze", lava_maze, 11)


class LavaMazeEnv(MultiGridEnv):
    scenario = "lava_maze"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-steps", type=int, default=60)
    args = ap.parse_args(argv)
    agents = [
        GridAgentInterface(color="red", prestige_scale=0.5),
        GridAgentInterface(color="blue", prestige_scale=0.5, spawn_delay=5),
    ]
    env = LavaMazeEnv(agents=agents, grid_size=13, max_steps=args.max_steps,
                      n_bonus_tiles=3, reward_decay=False, seed=3,
                      device=args.device)
    env.reset()
    env.place_obj(O.Ball("purple"))      # interactive host-side edit
    print(env)                           # ASCII board (str_render codes)

    rec = GridRecorder(env, tile_size=16)
    rng = np.random.default_rng(0)
    done, total = False, np.zeros(env.num_agents)
    while not done:
        _, rewards, done, _ = rec.step(rng.integers(0, 7, env.num_agents))
        total += rewards
    print("episode returns:", total,
          "| prestige:", [round(a.prestige, 2) for a in env.agents])
    if importlib.util.find_spec("imageio") is None:
        print("video: not written (imageio is not installed)")
    else:
        print("video:", rec.export_video(os.path.join(
            tempfile.gettempdir(), "marlgrid_custom.gif"), fps=8))
    return total


if __name__ == "__main__":
    main()
