"""gymnasium's base classes where gymnasium is installed, stand-ins where
it is not.

The rim's envs, wrappers and vector env subclass ``Env``, ``Wrapper`` and
``VectorEnv`` from here. With gymnasium they are gymnasium's own classes
(so ``gymnasium.Wrapper`` accepts the port's envs) and ``spaces`` is
``gymnasium.spaces``. Without it the stand-ins keep the surface the rim
uses (``reset``/``step``/``render``/``close``, ``unwrapped``, ``metadata``)
and ``spaces`` is None: the envs then carry ``observation_space = None``
and ``action_space = None`` and run all the same. Like gymnasium 1.x, a
stand-in wrapper forwards the spaces but no other attribute.
"""

from __future__ import annotations

try:
    import gymnasium
except ImportError:
    gymnasium = None

if gymnasium is not None:
    from gymnasium import Env, Wrapper, spaces
    from gymnasium.vector import AutoresetMode, VectorEnv

    SAME_STEP = AutoresetMode.SAME_STEP
else:
    spaces = None
    SAME_STEP = "SameStep"  # the value of gymnasium.vector.AutoresetMode.SAME_STEP

    class Env:
        metadata = {"render_modes": []}
        render_mode = None
        spec = None
        observation_space = None
        action_space = None

        @property
        def unwrapped(self):
            return self

        def render(self):
            return None

        def close(self):
            pass

    class Wrapper(Env):
        def __init__(self, env):
            self.env = env

        @property
        def unwrapped(self):
            return self.env.unwrapped

        @property
        def observation_space(self):
            return self.env.observation_space

        @property
        def action_space(self):
            return self.env.action_space

        @property
        def metadata(self):
            return self.env.metadata

        def reset(self, **kwargs):
            return self.env.reset(**kwargs)

        def step(self, action):
            return self.env.step(action)

        def render(self):
            return self.env.render()

        def close(self):
            return self.env.close()

    class VectorEnv:
        metadata = {}
        spec = None
        render_mode = None
        closed = False

        @property
        def unwrapped(self):
            return self

        def close(self, **kwargs):
            if not self.closed:
                self.close_extras(**kwargs)
            self.closed = True

        def close_extras(self, **kwargs):
            pass

__all__ = ["gymnasium", "Env", "Wrapper", "VectorEnv", "spaces", "SAME_STEP"]
