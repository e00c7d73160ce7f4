"""The system under test, box2d_mt_tpu_torch, as the harness drives it:
its `WorldBuilder`, its state helpers and `step_batched` (the entry the
window times), and the kernels' default entries that the traced run
wraps through `step_batched`'s `middle=` and `toi=`."""

import numpy as np


class Program:
    def __init__(self, device):
        import box2d_mt_tpu_torch as b2
        from box2d_mt_tpu_torch import state
        from box2d_mt_tpu_torch.ops.solve_middle import solve_middle
        from box2d_mt_tpu_torch.ops.toi import time_of_impact_lanes
        self.b2, self.state, self.device = b2, state, device
        self.kernels = {"middle": solve_middle, "toi": time_of_impact_lanes}

    def build_pool(self, scene, config, offsets):
        """One world a row of `offsets` (V, n) float64, each through
        `WorldBuilder.freeze` on the card, as one batch of V worlds."""
        worlds = [scene.build(self.b2, config, row).freeze(device=self.device,
                                                            **config["capacities"])
                  for row in np.asarray(offsets, np.float64)]
        return self.state.concat_worlds(worlds)

    def gather(self, pool, idx):
        """The worlds `idx` (W,) of `pool`: one device copy a leaf."""
        return self.state.map_leaves(lambda t: t.index_select(0, idx), pool)

    def step(self, state, step_kw, **hooks):
        return self.b2.step_batched(state, **step_kw, **hooks)
