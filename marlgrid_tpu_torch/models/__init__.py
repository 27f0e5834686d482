from .actor_critic import (  # noqa: F401
    MODEL_SPLIT, ActorCritic, FusedGRUCell, FusedLSTMCell, OneHotEmbed,
    RecurrentActorCritic, load_flax_params, load_flax_params_shard)
