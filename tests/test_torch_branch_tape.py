"""The branch tape (``ml_audio_inpainting_torch/utils/branch_tape.py``): a
replay takes the recorded side of each kink whatever its own input says,
its gradient follows that side, and a replay that does not match the
recording raises.  Exact comparisons: the replayed branches are the only
difference between the runs."""

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from ml_audio_inpainting_torch.utils.branch_tape import branch_tape


def _net(x: torch.Tensor) -> torch.Tensor:
    y = F.leaky_relu(x, 0.2)
    y = nn.MaxPool2d(2, 2)(y)
    return nn.ReLU()(y - 0.5)


def test_replay_takes_the_recorded_branches_and_their_gradients():
    x = torch.linspace(-1.0, 1.0, 2 * 3 * 4 * 4, dtype=torch.float64).reshape(2, 3, 4, 4)
    tape = []
    with branch_tape(tape):
        want = _net(x)
    assert len(tape) == 3 and tape[1].dtype == torch.int64
    torch.testing.assert_close(want, _net(x), rtol=0, atol=0)  # recording changes nothing

    other = -x.clone().requires_grad_()  # every sign and every pool's largest input differ
    with branch_tape(tape, replay=True):
        got = _net(other)
    pos = tape[0]
    pooled = torch.where(pos, other, 0.2 * other).flatten(2).gather(2, tape[1].flatten(2))
    expect = torch.where(tape[2], pooled.view(tape[1].shape) - 0.5, torch.zeros(()))
    torch.testing.assert_close(got, expect, rtol=0, atol=0)
    (grad,) = torch.autograd.grad(got.sum(), other)
    taken = torch.zeros_like(other).flatten(2).scatter(
        2, tape[1].flatten(2), tape[2].flatten(2).to(other.dtype)).view_as(other)
    torch.testing.assert_close(grad, taken * torch.where(pos, 1.0, 0.2), rtol=0, atol=0)
    assert F.leaky_relu is not None and F.relu.__name__ == "relu"  # restored


@pytest.mark.parametrize("case", ["shape", "more_calls", "fewer_calls"])
def test_a_replay_that_does_not_match_raises(case):
    x = torch.randn(1, 2, 4, 4, generator=torch.Generator().manual_seed(0))
    tape = []
    with branch_tape(tape):
        _net(x)
    with pytest.raises(RuntimeError, match="branch tape"):
        with branch_tape(tape, replay=True):
            if case == "shape":
                _net(x[:, :1])
            elif case == "more_calls":
                _net(x)
                F.relu(x)
            else:
                F.leaky_relu(x, 0.2)
    assert F.max_pool2d.__name__ != "tape_max_pool2d"
