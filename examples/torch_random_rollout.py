"""Reference-style usage demo on the PyTorch port: gym-classic loop + video
export.

The counterpart of ``examples/random_rollout.py``: make a named env, run
random actions through the per-agent list API, export a gif (when imageio
is installed). Runs on the card unless given ``--device cpu``:

    python examples/torch_random_rollout.py [--device cpu] [--max-steps 20]
"""
import argparse
import importlib.util
import os
import tempfile

import numpy as np

from marlgrid_tpu_torch.envs import make
from marlgrid_tpu_torch.utils.video import GridRecorder


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-steps", type=int, default=None,
                    help="episode length (default: the registered env's)")
    args = ap.parse_args(argv)
    over = {} if args.max_steps is None else dict(max_steps=args.max_steps)
    env = make("MarlGrid-3AgentCluttered15x15-v0", seed=7, device=args.device,
               **over)
    rec = GridRecorder(env, tile_size=16)
    rng = np.random.default_rng(0)

    rec.reset()
    done = False
    total = np.zeros(env.num_agents)
    while not done:
        actions = rng.integers(0, 7, env.num_agents)
        _, rewards, done, _ = rec.step(actions)
        total += rewards
    print("episode returns:", total)
    if importlib.util.find_spec("imageio") is None:
        print("video: not written (imageio is not installed)")
    else:
        print("video:", rec.export_video(os.path.join(
            tempfile.gettempdir(), "marlgrid_episode.gif"), fps=8))
    return total


if __name__ == "__main__":
    main()
