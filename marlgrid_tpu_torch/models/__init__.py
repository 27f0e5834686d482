from .actor_critic import ActorCritic, OneHotEmbed, load_flax_params  # noqa: F401
