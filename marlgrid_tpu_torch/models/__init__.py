from .actor_critic import (  # noqa: F401
    ActorCritic, FusedGRUCell, FusedLSTMCell, OneHotEmbed,
    RecurrentActorCritic, load_flax_params)
