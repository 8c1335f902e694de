"""The policy models of the port: the feedforward and recurrent
window-embedding actor-critics and the conv actor-critic."""

from .actor_critic import ActorCritic, gather_params, init_params, partition_params
from .embed_actor_critic import EmbedActorCritic, init_embed_params
from .recurrent import RecurrentEmbedActorCritic, init_recurrent_params

__all__ = [
    "ActorCritic",
    "init_params",
    "partition_params",
    "gather_params",
    "EmbedActorCritic",
    "init_embed_params",
    "RecurrentEmbedActorCritic",
    "init_recurrent_params",
]
