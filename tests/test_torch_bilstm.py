"""The port's ``BiLSTM`` (``ml_audio_inpainting_torch/ops/lstm.py``) against
the flax ``BiLSTM`` with the same weights carried across.

Tolerance ``atol=2e-5``: the port and XLA sum the input projection
(``x @ W_ih``, D=24 or 32) and the recurrent dots in other orders; two
stacked layers of bounded activations keep the difference at the f32
rounding level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_inpainting_tpu.ops.lstm import BiLSTM as JaxBiLSTM
from ml_audio_inpainting_torch.ops.lstm import BiLSTM
from torch_threads import one_thread  # noqa: F401  (a module fixture)


def _randomised(params, rng, scale):
    """Every leaf replaced by seeded normals (flax zero-inits the bias)."""
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape) * scale, jnp.float32), params
    )


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("num_layers,D,H", [(1, 24, 8), (2, 32, 16)])
def test_bilstm_matches_flax(use_pallas, num_layers, D, H):
    rng = np.random.default_rng(num_layers * 10 + H)
    B, T = 3, 13
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    jmodel = JaxBiLSTM(hidden_dim=H, num_layers=num_layers, use_pallas=use_pallas)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = _randomised(params, rng, 0.3)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))

    model = BiLSTM(D, H, num_layers)
    model.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in params.items()})
    with torch.no_grad():
        got = model(torch.tensor(x)).numpy()
    assert got.shape == want.shape == (B, T, 2 * H)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_bilstm_backward_half_sees_the_future():
    """Changing the last input moves the backward half at t=0 only."""
    rng = np.random.default_rng(4)
    model = BiLSTM(4, 8, 1)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.tensor(rng.standard_normal(tuple(p.shape)).astype(np.float32)))
        x = torch.zeros((1, 10, 4))
        y0 = model(x)
        x[0, -1] = 1.0
        y1 = model(x)
    torch.testing.assert_close(y0[0, 0, :8], y1[0, 0, :8], rtol=0, atol=0)
    assert not torch.allclose(y0[0, 0, 8:], y1[0, 0, 8:])
