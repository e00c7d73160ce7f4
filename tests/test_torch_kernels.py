"""Card-only: the port's CUDA kernels against their plain PyTorch versions.

This file imports neither JAX nor the JAX package, so it runs on a GPU
host without them: `python -m pytest --noconftest tests/test_torch_kernels.py -q`.
Elsewhere every case skips. Inputs are captured from the port's own step
(8 x pyramid(10) after 30 steps); max_colors=3 makes the coloring
overflow, which exercises the kernel's Jacobi chunk path."""

import dataclasses

import pytest
import torch

from box2d_mt_tpu_torch import settings
from box2d_mt_tpu_torch.models import scenes
from box2d_mt_tpu_torch.ops import solve_middle as sm
from box2d_mt_tpu_torch.state import replicate
from box2d_mt_tpu_torch.world import step_batched

DT = 1.0 / 60.0


@pytest.fixture(scope="module")
def rolled():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on a card")
    states = replicate(scenes.pyramid(10, device="cuda"), 8)
    for _ in range(30):
        states, _ = step_batched(states, DT, continuous=False, max_colors=16)
    return states


@pytest.mark.gpu
@pytest.mark.parametrize("max_colors", [16, 3], ids=["colors", "overflow"])
def test_solve_middle_kernel_matches_plain(rolled, max_colors):
    # recolor with this budget: the color cache does not key on max_colors
    states = dataclasses.replace(rolled, cache=dataclasses.replace(
        rolled.cache, valid=torch.zeros_like(rolled.cache.valid)))
    got = {}

    def capture(*args):
        got["args"] = args
        return sm.solve_middle(*args)

    _, ev = step_batched(states, DT, continuous=False, max_colors=max_colors,
                         middle=capture)
    assert (int(ev.color_overflow.min()) > 0) == (max_colors == 3)
    args = got["args"]
    launches = sm.solve_middle.launches
    k_vel, k_pos, k_aux = sm.solve_middle(*args)
    p_vel, p_pos, p_aux = sm.solve_middle_plain(*args)
    torch.cuda.synchronize()
    assert sm.solve_middle.launches == launches + 1
    torch.testing.assert_close(k_pos, p_pos, rtol=0, atol=1e-5)
    torch.testing.assert_close(k_vel, p_vel, rtol=0, atol=1e-4)
    torch.testing.assert_close(k_aux[:, :4], p_aux[:, :4], rtol=0, atol=1e-4)
    slop = -3.0 * settings.LINEAR_SLOP
    assert torch.equal(k_aux[:, 4] >= slop, p_aux[:, 4] >= slop)


def test_kernel_wrapper_checks_arguments():
    """The wrapper refuses malformed arguments before any launch."""
    nw, nc, nb = 1, 4, 3
    args = [torch.zeros(nw, 51, nc), torch.zeros(nw, nc, dtype=torch.int32),
            torch.zeros(nw, 3, dtype=torch.int32),
            torch.zeros(nw, nc, dtype=torch.uint8), torch.zeros(nw, 3, nb),
            torch.zeros(nw, 3, nb), torch.zeros(nw, nb, dtype=torch.bool)]
    vel, pos, aux = sm.solve_middle(*args, DT, 1, 1)
    assert aux.shape == (nw, 5, nc) and torch.equal(vel, args[4])
    bad = list(args)
    bad[1] = bad[1].long()
    with pytest.raises(ValueError, match="perm"):
        sm.solve_middle(*bad, DT, 1, 1)
    bad = list(args)
    bad[4] = torch.zeros(nw, nb, 3).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        sm.solve_middle(*bad, DT, 1, 1)
