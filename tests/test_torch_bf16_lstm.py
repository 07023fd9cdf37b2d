"""The bf16 forms of the port's LSTM recurrence
(``ml_audio_inpainting_torch/ops/cuda/lstm_cell.py``: the plain versions of
``lstm_fwd``, ``lstm_bwd`` and ``lstm_dwhh``, and the ``BiLSTM`` module)
against the JAX package's Pallas kernels run in bf16 (interpret mode on the
CPU), which is what the JAX package's bf16 training runs on the TPU.

The reference is the Pallas kernel, not ``lax.scan``: in bf16 the Pallas
forward carries ``h`` and ``c`` in f32 scratch and rounds them to bf16 only
where it stores them, while ``lax.scan`` carries them in bf16.  The plain
versions compute what the Pallas kernels compute, in f32 on the bf16
inputs, so what is left is f32 rounding in another order (XLA's and
torch's dots and transcendentals), which a rounding to bf16 almost always
hides:

* forward (B=3, H=16, T=29 and 64; B=8, H=32, T=100): ``h`` and ``c``
  equal bit for bit on at least 99.9 % of the entries and within one bf16
  ulp on all, with the floor below (the f32 carries drift by an f32 ulp or
  so between the two libraries' dots and transcendentals, and a value near
  a bf16 rounding boundary can round the other way).  The plain forward
  computes what the bf16 kernel computes: its product takes the f32 ``h``
  as ``FWD_PIECES`` bf16 pieces, the operands of the tensor cores;
* backward: ``dxw`` (bf16) and ``dW_hh`` (bf16, summed in f32 from the
  pair ``(dxw, lo)``, ``lo = bf16(dgates - dxw)``) within one bf16 ulp of
  Pallas's, with a floor of ``1e-6`` of the tensor's largest entry for
  entries that are f32 cancellation noise (entries of ~1e-6 beside a
  maximum of ~2, where one f32 rounding of another order is many bf16 ulps
  of the tiny entry), and equal on at least 99 % of the entries.  The plain
  backward computes what the bf16 kernel computes: its dh carry takes the
  f32 dgates as ``DH_PIECES`` bf16 pieces, the operands of the tensor cores;
* the witnesses: summing the bf16-rounded ``dxw`` alone instead of the
  pair leaves only ~59 % of ``dW_hh``'s entries equal to Pallas's, and
  one bf16 piece in the dh carry (``dgates`` rounded) only 74 % of
  ``dxw``'s (two pieces 99.9 %, three 99.98 %), so the 99 % bound tells
  the designs apart.  In the forward's product (B=8, T=100, H=32, forward
  / reverse direction, ``h`` and ``c`` equal to Pallas's): one piece (``h``
  rounded) 76.6 % and 77.0 % / 77.1 % and 77.6 %, beyond one ulp; two
  pieces 99.895 % and 99.895 % / 99.906 % and 99.883 %, within one ulp but
  below the 99.9 % bound; three 99.973 % and 99.984 % / 99.992 % and
  99.992 %, so the forward takes three;
* the BiLSTM module in bf16 (``x @ W_ih + b`` in bf16, then the
  recurrence) against flax's ``BiLSTM(use_pallas=True)`` on bf16 parameters:
  within two bf16 ulps of the output's largest entry (the projection's bf16
  rounding by torch and by XLA can land one ulp apart and move the
  recurrence's inputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_inpainting_tpu.ops.lstm import BiLSTM as JaxBiLSTM
from ml_audio_inpainting_tpu.ops.lstm import lstm_scan
from ml_audio_inpainting_tpu.ops.pallas import lstm_cell as pallas_cell
from ml_audio_inpainting_torch.ops.cuda import lstm_cell
from ml_audio_inpainting_torch.ops.lstm import BiLSTM
from torch_threads import one_thread  # noqa: F401  (a module fixture)


def _inputs(B, T, H, seed):
    """bf16 xw, W_hh and incoming gradient, as numpy f32 holding bf16 values."""
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((B, T, 4 * H))
    w_hh = rng.standard_normal((H, 4 * H)) * 0.3
    g = rng.standard_normal((B, T, H))
    return [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (xw, w_hh, g)]


def _bf16(*arrays):
    return [torch.tensor(a).to(torch.bfloat16) for a in arrays]


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not isinstance(a, torch.Tensor) \
        else a.float().numpy()


def _pallas_forward(xw, w_hh, reverse):
    """Pallas's h (B, T, H) and its saved time-major (h_seq, c_seq)."""
    out, residuals = pallas_cell._fwd(jnp.asarray(xw, jnp.bfloat16),
                                      jnp.asarray(w_hh, jnp.bfloat16), reverse)
    return out, residuals


def _batch_major(seq, reverse):
    seq = np.swapaxes(_f32(seq), 0, 1)
    return seq[:, ::-1].copy() if reverse else seq


def _ulp(a: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each entry (2^-7 of its binade)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(a), np.finfo(np.float32).tiny))) - 7)


def _within_one_ulp(got, want, floor_of_max=1e-6):
    bound = np.maximum(_ulp(want), floor_of_max * np.abs(want).max())
    return np.abs(got - want) <= bound


def _assert_matches_bf16(got, want, equal_share):
    assert _within_one_ulp(got, want).all()
    assert (got == want).mean() >= equal_share, (got != want).sum()


def _forward_case(B, T, H, seed, reverse, pieces=lstm_cell.FWD_PIECES):
    """The port's plain bf16 forward (its product from ``pieces`` bf16
    pieces of h) and Pallas's h and c, as f32 numpy."""
    xw, w_hh, _ = _inputs(B, T, H, seed)
    out, residuals = _pallas_forward(xw, w_hh, reverse)
    h, c = lstm_cell.lstm_recurrence_reference(*_bf16(xw, w_hh), reverse, return_c=True,
                                               pieces=pieces)
    assert h.dtype == c.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(out), _batch_major(residuals[2], reverse))
    return _f32(h), _f32(c), _f32(out), _batch_major(residuals[3], reverse)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T,seed", [(29, 0), (29, 1), (29, 2), (64, 3), (64, 4)])
def test_plain_bf16_forward_matches_pallas(T, seed, reverse):
    h, c, want_h, want_c = _forward_case(3, T, 16, seed, reverse)
    _assert_matches_bf16(h, want_h, 0.999)
    _assert_matches_bf16(c, want_c, 0.999)


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_bf16_forward_matches_pallas_at_the_witness_shape(reverse):
    """The bound of ``test_plain_bf16_forward_matches_pallas`` at B=8,
    T=100, H=32: the shape where the number of pieces shows."""
    h, c, want_h, want_c = _forward_case(8, 100, 32, 1, reverse)
    _assert_matches_bf16(h, want_h, 0.999)
    _assert_matches_bf16(c, want_c, 0.999)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("pieces,meets", [(1, False), (2, False), (lstm_cell.FWD_PIECES, True)])
def test_h_pieces_decide_the_forward_bound(pieces, meets, reverse):
    """The witness for the forward's product on the tensor cores: with the
    f32 h as one bf16 piece (rounded), h and c equal Pallas's on only ~77 %
    of the entries and leave one bf16 ulp; two pieces stay within one ulp
    but below 99.9 % equal; the kernel's ``FWD_PIECES`` meet the bound of
    ``test_plain_bf16_forward_matches_pallas``."""
    h, c, want_h, want_c = _forward_case(8, 100, 32, 1, reverse, pieces=pieces)
    passed = all(bool(_within_one_ulp(got, want).all() and (got == want).mean() >= 0.999)
                 for got, want in ((h, want_h), (c, want_c)))
    assert passed == meets, ((h == want_h).mean(), (c == want_c).mean())


def test_cpu_wrapper_runs_the_bf16_plain_version():
    """``bilstm_forward`` and the Function on bf16 CPU tensors: bf16 out, the
    plain version's values, no launch counted."""
    B, T, H = 3, 17, 8
    xw_f, w_f, _ = _inputs(B, T, H, 5)
    xw_b, w_b, _ = _inputs(B, T, H, 6)
    layer = _bf16(xw_f, w_f, xw_b, w_b)
    before = lstm_cell.kernel_launches()
    h, c = lstm_cell.bilstm_forward(*layer, with_c=True)
    out = lstm_cell.bilstm_recurrence(*layer)
    assert h.dtype == c.dtype == out.dtype == torch.bfloat16
    assert torch.equal(out, h)
    want = np.concatenate([_f32(_pallas_forward(xw_f, w_f, False)[0]),
                           _f32(_pallas_forward(xw_b, w_b, True)[0])], axis=-1)
    _assert_matches_bf16(_f32(h), want, 0.999)
    assert lstm_cell.kernel_launches() == before


def _backward_case(B, T, H, seed, reverse, pieces=lstm_cell.DH_PIECES):
    """Pallas's bf16 dxw and dW_hh, and the port's plain backward (dxw, the
    f32 dgates and their bf16 residual lo; the dh carry from ``pieces``
    bf16 pieces) on Pallas's own saved h and c."""
    xw, w_hh, g = _inputs(B, T, H, seed)
    _, residuals = _pallas_forward(xw, w_hh, reverse)
    want_dxw, want_dw = pallas_cell._bwd(reverse, residuals, jnp.asarray(g, jnp.bfloat16))
    assert want_dxw.dtype == want_dw.dtype == jnp.bfloat16
    h, c = (torch.tensor(_batch_major(s, reverse)).to(torch.bfloat16) for s in residuals[2:])
    xw_t, w_t, g_t = _bf16(xw, w_hh, g)
    dxw, dgates = lstm_cell.lstm_recurrence_backward_reference(
        xw_t, w_t, h, c, g_t, reverse, return_dgates=True, pieces=pieces)
    lo = lstm_cell.bf16_residual(dgates, dxw)
    return h, dxw, dgates, lo, _f32(want_dxw), _f32(want_dw)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B,T,H,seed", [(3, 29, 16, 0), (8, 100, 32, 1)])
def test_plain_bf16_backward_matches_pallas(B, T, H, seed, reverse):
    h, dxw, dgates, lo, want_dxw, want_dw = _backward_case(B, T, H, seed, reverse)
    assert dxw.dtype == lo.dtype == torch.bfloat16 and dgates.dtype == torch.float32
    _assert_matches_bf16(_f32(dxw), want_dxw, 0.99)
    dw = lstm_cell.dwhh_reference(h, dxw, reverse, lo=lo)
    assert dw.dtype == torch.bfloat16
    _assert_matches_bf16(_f32(dw), want_dw, 0.99)
    # The pair carries the f32 dgates to 16 bits: within 2^-16 of each entry.
    assert (np.abs(_f32(dxw) + _f32(lo) - _f32(dgates))
            <= 2.0 ** -16 * np.abs(_f32(dgates))).all()
    # The CPU wrapper of lstm_dwhh computes the same, from the same pair.
    both = lstm_cell.bilstm_dwhh(torch.cat([h, h], dim=-1), dxw, dxw, lo, lo)
    assert torch.equal(both[1 if reverse else 0], dw)


@pytest.mark.parametrize("reverse", [False, True])
def test_summing_the_rounded_dxw_fails_the_dwhh_bound(reverse):
    """The witness for the dW_hh design: ``_bwd_kernel`` sums the f32
    dgates; the pair ``(dxw, lo)`` meets its dW_hh on 99 % of the entries,
    while the bf16 dxw alone misses it on ~41 %."""
    h, dxw, _, lo, _, want_dw = _backward_case(8, 100, 32, 1, reverse)
    right = _f32(lstm_cell.dwhh_reference(h, dxw, reverse, lo=lo))
    wrong = _f32(lstm_cell.dwhh_reference(h, dxw, reverse))
    assert (right == want_dw).mean() >= 0.99
    assert (wrong == want_dw).mean() < 0.8


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("pieces,meets", [(1, False), (lstm_cell.DH_PIECES, True)])
def test_dh_carry_pieces_decide_the_dxw_bound(pieces, meets, reverse):
    """The witness for the sweep's dh product: with the f32 dgates as one
    bf16 piece (rounded), dxw equals Pallas's on only ~74 % of the entries
    and leaves one bf16 ulp; with the kernel's ``DH_PIECES`` it meets the
    bound of ``test_plain_bf16_backward_matches_pallas``."""
    _, dxw, _, _, want_dxw, _ = _backward_case(8, 100, 32, 1, reverse, pieces=pieces)
    got = _f32(dxw)
    passed = bool(_within_one_ulp(got, want_dxw).all() and (got == want_dxw).mean() >= 0.99)
    assert passed == meets, (got == want_dxw).mean()


def test_split_bf16_pieces():
    """The pieces of an f32 tensor: the first is it rounded, the second its
    bf16 residual, and three sum back to it within f32's own resolution."""
    x = torch.tensor(np.random.default_rng(9).standard_normal(4096).astype(np.float32)) * 3
    p = lstm_cell.split_bf16(x, 3)
    assert all(t.dtype == torch.bfloat16 for t in p)
    assert torch.equal(p[0], x.to(torch.bfloat16))
    assert torch.equal(p[1], lstm_cell.bf16_residual(x, p[0]))
    total = p[2].double() + p[1].double() + p[0].double()
    assert ((total - x.double()).abs() <= 2.0 ** -24 * x.double().abs()).all()


def test_cpu_backward_wrapper_returns_the_bf16_pair():
    """``bilstm_recurrence_backward(..., dgates=True)`` on bf16 CPU tensors:
    bf16 ``lo``, the plain version's residual of its f32 dgates; in f32,
    ``lo`` is None and ``dW_hh`` sums ``dxw``; no launch counted."""
    B, T, H = 3, 17, 8
    xw_f, w_f, g = _inputs(B, T, H, 5)
    xw_b, w_b, _ = _inputs(B, T, H, 6)
    g2 = np.concatenate([g, g[:, ::-1]], axis=-1)
    counts = lstm_cell.kernel_launches()
    for dtype in (torch.bfloat16, torch.float32):
        layer = [torch.tensor(a).to(dtype) for a in (xw_f, w_f, xw_b, w_b)]
        h, c = lstm_cell.bilstm_forward(*layer, with_c=True)
        g_t = torch.tensor(g2.copy()).to(dtype)
        dxw_f, dxw_b, lo_f, lo_b = lstm_cell.bilstm_recurrence_backward(
            *layer, h, c, g_t, dgates=True)
        for sl, xw, w, dxw, lo, reverse in ((slice(0, H), *layer[:2], dxw_f, lo_f, False),
                                            (slice(H, 2 * H), *layer[2:], dxw_b, lo_b, True)):
            want_dxw, dg = lstm_cell.lstm_recurrence_backward_reference(
                xw, w, h[..., sl], c[..., sl], g_t[..., sl], reverse, return_dgates=True)
            assert torch.equal(dxw, want_dxw)
            if dtype == torch.bfloat16:
                assert torch.equal(lo, lstm_cell.bf16_residual(dg, dxw))
            else:
                assert lo is None and dg is want_dxw
        dws = lstm_cell.bilstm_dwhh(h, dxw_f, dxw_b, lo_f, lo_b)
        assert dws[0].dtype == dtype
        assert torch.equal(dws[0], lstm_cell.dwhh_reference(h[..., :H], dxw_f, False, lo=lo_f))
    assert counts == lstm_cell.kernel_launches()


@pytest.mark.parametrize("reverse", [False, True])
def test_bf16_scan_is_further_from_the_port_than_pallas(reverse):
    """Why the Pallas kernel is the reference: JAX's bf16 ``lax.scan``
    carries h and c in bf16 and lies ~1e-2 from the port's bf16 h, on most
    entries, where the Pallas kernel differs from it on at most one in a
    thousand."""
    B, T, H = 3, 29, 16
    xw, w_hh, _ = _inputs(B, T, H, 7)
    port = _f32(lstm_cell.lstm_recurrence_reference(*_bf16(xw, w_hh), reverse))
    pallas = _f32(_pallas_forward(xw, w_hh, reverse)[0])
    z = jnp.zeros((B, H), jnp.bfloat16)
    scan = _f32(lstm_scan(jnp.asarray(xw, jnp.bfloat16), jnp.asarray(w_hh, jnp.bfloat16), z, z,
                          reverse=reverse))
    assert (pallas != port).mean() <= 1e-3
    assert (scan != port).mean() > 0.1 and np.abs(scan - port).max() > 1e-3


@pytest.mark.parametrize("num_layers,D,H", [(1, 24, 8), (2, 32, 16)])
def test_bilstm_bf16_matches_flax_pallas(num_layers, D, H):
    """The module on bf16 parameters and input against flax's ``BiLSTM``
    with the Pallas recurrence on the same bf16 values."""
    rng = np.random.default_rng(num_layers * 10 + H)
    B, T = 3, 13
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    jmodel = JaxBiLSTM(hidden_dim=H, num_layers=num_layers, use_pallas=True)
    params = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape) * 0.3, jnp.bfloat16), params)
    want = _f32(jmodel.apply({"params": params}, jnp.asarray(x, jnp.bfloat16)))

    model = BiLSTM(D, H, num_layers).to(torch.bfloat16)
    model.load_state_dict({k: torch.tensor(_f32(v)).to(torch.bfloat16)
                           for k, v in params.items()})
    with torch.no_grad():
        got = model(torch.tensor(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, 2 * H)
    np.testing.assert_allclose(_f32(got), want, rtol=0, atol=2 * 2.0 ** -8)
