"""Framework adapters of the port (upstream: pogema/integrations/),
counterparts of ``pogema_tpu/integrations``: thin host shims over
:class:`pogema_torch.envs.Pogema`, and the batched
:class:`~pogema_torch.integrations.vector.PogemaVectorEnv`."""
