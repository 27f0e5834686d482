"""EnvParams (static config) and the batched EnvState (PyTorch port).

Counterpart of ``marlgrid_tpu/core/state.py``. ``EnvParams`` is a copy with
the same fields and the same dict round trip. ``EnvState`` holds a whole
batch of environments: every tensor carries the batch dim B first, where the
JAX package vmaps a per-env pytree.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EnvParams:
    """Static env configuration — hashable, passed as a jit-static argument.

    Mirrors the reference ctor surface ``MultiGridEnv.__init__`` +
    ``GridAgentInterface`` kwargs (SURVEY §2.1, §3.1) as one frozen config.
    """

    # board
    width: int = 9
    height: int = 9
    n_agents: int = 1
    max_steps: int = 100
    # reference MultiGridEnv kwargs (SURVEY §3.1 [M])
    reward_decay: bool = True
    respawn: bool = False
    ghost_mode: bool = True
    # agent observation config (GridAgentInterface kwargs, SURVEY §2.1)
    view_size: int = 7            # odd
    view_tile_size: int = 8       # pixels per tile in the POV render
    view_offset: int = 0
    observation_style: str = "image"   # 'image' | 'rich' | 'encode'
    observe_rewards: bool = False
    observe_position: bool = False
    observe_orientation: bool = False
    see_through_walls: bool = False
    # type indices hidden from observations (visual-only: occlusion still
    # honors the true cell; ``GridAgentInterface(hide_item_types=…)`` [M])
    hide_item_types: Tuple[int, ...] = ()
    # heterogeneous per-agent observation configs (the reference builds one
    # GridAgentInterface per agent with independent view_size /
    # observation_style — ``marlgrid/agents.py — §GridAgentInterface``,
    # SURVEY §2.1): empty tuples mean all agents share the fields above;
    # otherwise len == n_agents and agent i observes with its own config.
    # The host wrapper compiles one obs program per distinct config group
    # (static shapes per group); the batched VectorEnv/training APIs
    # require homogeneous configs.
    agent_view_sizes: Tuple[int, ...] = ()
    agent_view_tile_sizes: Tuple[int, ...] = ()
    agent_obs_styles: Tuple[str, ...] = ()
    # … and the remaining per-agent obs knobs (``GridAgentInterface`` allows
    # every agent its own values — SURVEY §2.1 [M]); same convention:
    # empty = homogeneous (the scalar fields above), else len == n_agents
    agent_view_offsets: Tuple[int, ...] = ()
    agent_see_through_walls: Tuple[bool, ...] = ()
    agent_hide_item_types: Tuple[Tuple[int, ...], ...] = ()
    agent_observe_rewards: Tuple[bool, ...] = ()
    agent_observe_positions: Tuple[bool, ...] = ()
    agent_observe_orientations: Tuple[bool, ...] = ()
    # prestige display (``GridAgentInterface(prestige_beta/prestige_scale)``
    # [M]): per-step multiplicative decay of the prestige accumulator and the
    # scale mapping prestige to sprite dim levels (SPEC §8). The agent_*
    # tables allow per-agent values (observed-agent-side: they ride the
    # engine/sprite paths, not the per-observer obs groups).
    prestige_beta: float = 0.95
    prestige_scale: float = 2.0
    agent_prestige_betas: Tuple[float, ...] = ()
    agent_prestige_scales: Tuple[float, ...] = ()
    # per-agent spawn delays (``GridAgentInterface(spawn_delay)`` [L]):
    # () means all agents spawn at reset; otherwise len == n_agents and agent
    # i activates when step_count reaches spawn_delays[i] (SPEC §5)
    spawn_delays: Tuple[int, ...] = ()
    # rewards (SPEC §5)
    goal_reward: float = 1.0
    lava_penalty: float = 0.0
    bonus_reward: float = 1.0
    bonus_penalty: float = 0.5
    # per-object reward tables (``marlgrid/objects.py — §Goal(reward)`` [H] /
    # ``§BonusTile(reward, penalty)`` [M]): when non-empty, a goal cell's
    # state field indexes goal_rewards (scenarios place ``Goal(reward=r)``
    # by looking r up here — see grid_gen.encode_obj_cell), and a bonus
    # tile's bonus_id indexes bonus_rewards/bonus_penalties. Empty tuples
    # mean the uniform scalars above apply to every object.
    goal_rewards: Tuple[float, ...] = ()
    bonus_rewards: Tuple[float, ...] = ()
    bonus_penalties: Tuple[float, ...] = ()
    # scenario knobs (SPEC §6)
    scenario: str = "empty"       # 'empty' | 'cluttered' | 'doorkey' | 'goal_cycle'
    n_clutter: int = 25
    n_bonus_tiles: int = 3
    # end the episode when any agent completes a full bonus cycle
    # (``ClutteredGoalCycleEnv(reset_on_cycle)`` [L] — pinned reconstruction:
    # n_bonus_tiles consecutive in-order rewarded visits = one cycle)
    reset_on_cycle: bool = False
    # agent spawn region (``MultiGridEnv(agent_spawn_kwargs={'top': …,
    # 'size': …})`` [M]): static rectangle agents must spawn in; size None
    # means the whole board. ANDed with any scenario agent mask.
    agent_spawn_top: Tuple[int, int] = (0, 0)
    agent_spawn_size: Tuple[int, int] = None
    # per-agent colors, as color indices (len == n_agents)
    agent_colors: Tuple[int, ...] = (0,)
    # placement rejection-sampling budget (SPEC §4)
    max_place_tries: int = 100

    def __post_init__(self):
        assert self.view_size % 2 == 1, "view_size must be odd"
        assert len(self.agent_colors) == self.n_agents, (
            f"agent_colors {self.agent_colors} must have n_agents="
            f"{self.n_agents} entries"
        )
        assert not self.spawn_delays or \
            len(self.spawn_delays) == self.n_agents, (
                f"spawn_delays {self.spawn_delays} must be empty or have "
                f"n_agents={self.n_agents} entries"
            )
        for name in ("agent_view_sizes", "agent_view_tile_sizes",
                     "agent_obs_styles", "agent_view_offsets",
                     "agent_see_through_walls", "agent_hide_item_types",
                     "agent_observe_rewards", "agent_observe_positions",
                     "agent_observe_orientations", "agent_prestige_betas",
                     "agent_prestige_scales"):
            tab = getattr(self, name)
            assert not tab or len(tab) == self.n_agents, (
                f"{name} {tab} must be empty or have n_agents="
                f"{self.n_agents} entries"
            )
        assert all(v % 2 == 1 for v in self.agent_view_sizes), \
            "all agent view sizes must be odd"
        for name in ("bonus_rewards", "bonus_penalties"):
            tab = getattr(self, name)
            assert not tab or len(tab) >= self.n_bonus_tiles, (
                f"{name} {tab} must be empty or have at least "
                f"n_bonus_tiles={self.n_bonus_tiles} entries (indexed by "
                f"bonus_id)"
            )
        assert len(self.goal_rewards) < 256, "goal state field is uint8"

    def spawn_delay_tuple(self) -> Tuple[int, ...]:
        """spawn_delays normalized to length n_agents (() -> all zero)."""
        return self.spawn_delays or (0,) * self.n_agents

    def prestige_beta_tuple(self) -> Tuple[float, ...]:
        return self.agent_prestige_betas \
            or (self.prestige_beta,) * self.n_agents

    def prestige_scale_tuple(self) -> Tuple[float, ...]:
        return self.agent_prestige_scales \
            or (self.prestige_scale,) * self.n_agents

    @property
    def has_spawn_delays(self) -> bool:
        return any(d > 0 for d in self.spawn_delays)

    # --- heterogeneous per-agent obs accessors ------------------------------
    def agent_view_size(self, i: int) -> int:
        return self.agent_view_sizes[i] if self.agent_view_sizes \
            else self.view_size

    def agent_view_tile_size(self, i: int) -> int:
        return self.agent_view_tile_sizes[i] if self.agent_view_tile_sizes \
            else self.view_tile_size

    def agent_obs_style(self, i: int) -> str:
        return self.agent_obs_styles[i] if self.agent_obs_styles \
            else self.observation_style

    def agent_view_offset(self, i: int) -> int:
        return self.agent_view_offsets[i] if self.agent_view_offsets \
            else self.view_offset

    def agent_sees_through_walls(self, i: int) -> bool:
        return self.agent_see_through_walls[i] \
            if self.agent_see_through_walls else self.see_through_walls

    def agent_hidden_types(self, i: int) -> Tuple[int, ...]:
        return tuple(self.agent_hide_item_types[i]) \
            if self.agent_hide_item_types else self.hide_item_types

    def agent_observes_rewards(self, i: int) -> bool:
        return self.agent_observe_rewards[i] \
            if self.agent_observe_rewards else self.observe_rewards

    def agent_observes_position(self, i: int) -> bool:
        return self.agent_observe_positions[i] \
            if self.agent_observe_positions else self.observe_position

    def agent_observes_orientation(self, i: int) -> bool:
        return self.agent_observe_orientations[i] \
            if self.agent_observe_orientations \
            else self.observe_orientation

    @property
    def has_hetero_obs(self) -> bool:
        return bool(self.agent_view_sizes or self.agent_view_tile_sizes
                    or self.agent_obs_styles or self.agent_view_offsets
                    or self.agent_see_through_walls
                    or self.agent_hide_item_types
                    or self.agent_observe_rewards
                    or self.agent_observe_positions
                    or self.agent_observe_orientations)

    def agent_obs_params(self, i: int) -> "EnvParams":
        """Homogeneous params as seen by agent i's obs program — the
        per-group compile key for the host wrapper (and VectorEnv's
        per-group batched obs programs)."""
        return self.replace(
            view_size=self.agent_view_size(i),
            view_tile_size=self.agent_view_tile_size(i),
            observation_style=self.agent_obs_style(i),
            view_offset=self.agent_view_offset(i),
            see_through_walls=self.agent_sees_through_walls(i),
            hide_item_types=self.agent_hidden_types(i),
            observe_rewards=self.agent_observes_rewards(i),
            observe_position=self.agent_observes_position(i),
            observe_orientation=self.agent_observes_orientation(i),
            agent_view_sizes=(), agent_view_tile_sizes=(),
            agent_obs_styles=(), agent_view_offsets=(),
            agent_see_through_walls=(), agent_hide_item_types=(),
            agent_observe_rewards=(), agent_observe_positions=(),
            agent_observe_orientations=())

    def replace(self, **kw) -> "EnvParams":
        return dataclasses.replace(self, **kw)

    # --- JSON round-trip (self-describing checkpoints, SURVEY §5) ----------
    def to_dict(self) -> dict:
        """JSON-serializable dict of every field (tuples become lists)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "EnvParams":
        """Inverse of :meth:`to_dict` — lists revert to tuples (no EnvParams
        field is semantically a list). Unknown keys error loudly: a config
        written by a newer code version must not restore silently wrong."""
        def detuple(v):
            return tuple(detuple(x) for x in v) if isinstance(v, list) else v

        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"EnvParams.from_dict: unknown fields "
                             f"{sorted(unknown)}")
        return cls(**{k: detuple(v) for k, v in d.items()})


def default_agent_colors(n: int) -> Tuple[int, ...]:
    """Reference assigns distinct colors per agent index (SURVEY §2.1 [M])."""
    order = (0, 4, 5, 1, 6, 2, 3, 8)  # red, blue, purple, orange, pink, yellow…
    return tuple(order[i % len(order)] for i in range(n))


@dataclasses.dataclass
class EnvState:
    """A batch of B environments' full state (SPEC §2-§3), B leading.

    Board layers are FLAT ``(B, W*H)`` uint8, cell (x, y) at index
    ``x * H + y`` (the JAX package's layout). ``key`` is ``(B, 2)`` int64
    holding each env's threefry key as two uint32 values (core/rng.py).
    The engine's functions return new states; ``step`` clones its input
    once and then updates the clone in place.
    """

    grid_type: torch.Tensor       # (B, W*H) uint8
    grid_color: torch.Tensor      # (B, W*H) uint8
    grid_state: torch.Tensor      # (B, W*H) uint8
    agent_pos: torch.Tensor       # (B, N, 2) int32, (x, y)
    agent_dir: torch.Tensor       # (B, N) int32
    carry_type: torch.Tensor      # (B, N) int32
    carry_color: torch.Tensor     # (B, N) int32
    carry_state: torch.Tensor     # (B, N) int32
    active: torch.Tensor          # (B, N) bool
    last_bonus: torch.Tensor      # (B, N) int32, -1 = no tile visited yet
    cycle_progress: torch.Tensor  # (B, N) int32
    cycles: torch.Tensor          # (B, N) int32
    prestige: torch.Tensor        # (B, N) float32
    accum_reward: torch.Tensor    # (B, N) float32
    last_reward: torch.Tensor     # (B, N) float32
    step_count: torch.Tensor      # (B,) int32
    key: torch.Tensor             # (B, 2) int64, uint32 values

    @property
    def batch_size(self) -> int:
        return self.step_count.shape[0]

    def map(self, fn) -> "EnvState":
        """A new state with ``fn`` applied to every tensor."""
        return EnvState(**{f: fn(getattr(self, f)) for f in FIELDS})

    def clone(self) -> "EnvState":
        return self.map(torch.clone)

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)


FIELDS = tuple(f.name for f in dataclasses.fields(EnvState))

#: numpy dtype of each field as the JAX package stores it
NP_DTYPES = dict(
    grid_type=np.uint8, grid_color=np.uint8, grid_state=np.uint8,
    agent_pos=np.int32, agent_dir=np.int32, carry_type=np.int32,
    carry_color=np.int32, carry_state=np.int32, active=np.bool_,
    last_bonus=np.int32, cycle_progress=np.int32, cycles=np.int32,
    prestige=np.float32, accum_reward=np.float32, last_reward=np.float32,
    step_count=np.int32, key=np.uint32)

def zeros_state(params: EnvParams, keys: torch.Tensor) -> EnvState:
    """A batch of empty states, one per row of ``keys`` (B, 2)."""
    W, H, N = params.width, params.height, params.n_agents
    B, dev = keys.shape[0], keys.device

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return EnvState(
        grid_type=z((B, W * H), torch.uint8),
        grid_color=z((B, W * H), torch.uint8),
        grid_state=z((B, W * H), torch.uint8),
        agent_pos=z((B, N, 2), torch.int32),
        agent_dir=z((B, N), torch.int32),
        carry_type=z((B, N), torch.int32),
        carry_color=z((B, N), torch.int32),
        carry_state=z((B, N), torch.int32),
        active=z((B, N), torch.bool),
        last_bonus=torch.full((B, N), -1, dtype=torch.int32, device=dev),
        cycle_progress=z((B, N), torch.int32),
        cycles=z((B, N), torch.int32),
        prestige=z((B, N), torch.float32),
        accum_reward=z((B, N), torch.float32),
        last_reward=z((B, N), torch.float32),
        step_count=z((B,), torch.int32),
        key=keys.to(torch.int64),
    )


