"""The train-mode BatchNorm with its activation (``ops/cuda/batchnorm.py``):
the plain version's forward and explicit backward against autograd through
the eager rule it replaces (``_eager_rule``, the rule
``FlaxBatchNorm2d.forward`` ran before, then ``torch.relu`` or
``F.leaky_relu``), on f32, bf16 and f64 inputs; the module's modes, its
switches and its counters.  The kernels against this plain version on the
card: ``tests/test_torch_gpu.py``; over two data ranks:
``tests/test_torch_parallel.py``.

Tolerances:

* forward ``y`` and the running statistics: bit for bit (the same ops in
  the same order);
* backward in f32 and f64: within 1e-5 (f32) or 1e-12 (f64) of the
  largest entry of each gradient: the explicit formula sums ``g`` and ``g
  (x - mean)`` once per channel where autograd sums each term's gradient
  separately, so the sums run in another order;
* backward in bf16: each entry within one bf16 step of its value plus the
  f32 bound (the f32 values differ as above, and one rounding to bf16 can
  then land a step apart).
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ml_audio_inpainting_torch.models.cnn_blstm import (
    BN_MOMENTUM,
    FlaxBatchNorm2d,
    StackedBLSTMCNN,
    running_stats_frozen,
)
from ml_audio_inpainting_torch.ops.cuda import batchnorm
from ml_audio_inpainting_torch.runtime import profiling
from ml_audio_inpainting_torch.utils.branch_tape import branch_tape
from torch_threads import one_thread  # noqa: F401  (a module fixture)

EPS = 1e-5
SLOPES = [None, 0.0, 0.2]
DTYPES = [torch.float32, torch.bfloat16, torch.float64]
GRAD_OF_MAX = {torch.float32: 1e-5, torch.bfloat16: 1e-5, torch.float64: 1e-12}
BF16_STEP = 2.0 ** -7  # one bf16 step, relative to the value


def _eager_rule(x, weight, bias, running_mean, running_var, update, slope):
    """The train-mode rule as the eager ops computed it before the Function,
    with the activation after it."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    mean, mean_sq = xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))
    var = torch.clamp_min(mean_sq - mean * mean, 0.0)
    if update:
        with torch.no_grad():
            running_mean.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * mean)
            running_var.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * var)
    mul = torch.rsqrt(var + EPS) * weight.to(acc)
    y = ((xf - mean[:, None, None]) * mul[:, None, None] + bias.to(acc)[:, None, None]).to(x.dtype)
    if slope is None:
        return y
    return torch.relu(y) if slope == 0.0 else F.leaky_relu(y, slope)


def _inputs(dtype, shape=(3, 5, 7, 11), seed=0, param_dtype=None):
    rng = np.random.default_rng(seed)
    C = shape[1]
    x = torch.tensor(rng.standard_normal(shape) * 2 + 1).to(dtype)
    dy = torch.tensor(rng.standard_normal(shape)).to(dtype)
    p = param_dtype or (torch.float64 if dtype == torch.float64 else torch.float32)
    weight = torch.tensor(rng.uniform(0.5, 1.5, C)).to(p)
    bias = torch.tensor(rng.standard_normal(C)).to(p)
    return x, dy, weight, bias


def _running(C, dtype=torch.float32):
    return (torch.zeros(C, dtype=dtype), torch.ones(C, dtype=dtype),
            torch.zeros((), dtype=torch.int64))


def _both(x, dy, weight, bias, slope, update=True):
    """(eager, Function): each ``(y, dx, dweight, dbias, running_mean,
    running_var)`` for the same inputs."""
    out = []
    for fused in (False, True):
        xs, w, b = (t.clone().requires_grad_() for t in (x, weight, bias))
        rm, rv, nbt = _running(x.shape[1], torch.float64 if x.dtype == torch.float64
                               else torch.float32)
        if fused:
            y = batchnorm.batch_norm_act(xs, w, b, rm, rv, nbt, update, EPS, BN_MOMENTUM, slope)
        else:
            y = _eager_rule(xs, w, b, rm, rv, update, slope)
        y.backward(dy)
        out.append((y.detach(), xs.grad, w.grad, b.grad, rm, rv))
    return out


def _assert_grad_close(got, want, name):
    assert got.dtype == want.dtype, name
    bound = GRAD_OF_MAX[want.dtype] * want.abs().max().double()
    step = BF16_STEP if want.dtype == torch.bfloat16 else 0.0
    got, want = got.double(), want.double()
    err = (got - want).abs()
    assert (err <= bound + step * want.abs()).all(), f"{name}: {err.max().item()} ({bound})"


@pytest.mark.parametrize("slope", SLOPES, ids=["none", "relu", "leaky"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16", "f64"])
def test_plain_version_matches_the_eager_rule(dtype, slope):
    x, dy, weight, bias = _inputs(dtype)
    (y0, dx0, dw0, db0, rm0, rv0), (y1, dx1, dw1, db1, rm1, rv1) = _both(x, dy, weight, bias,
                                                                         slope)
    assert y1.dtype == dtype and torch.equal(y1, y0)
    assert torch.equal(rm1, rm0) and torch.equal(rv1, rv0)
    for name, got, want in (("dx", dx1, dx0), ("dweight", dw1, dw0), ("dbias", db1, db0)):
        _assert_grad_close(got, want, name)


@pytest.mark.parametrize("slope", SLOPES, ids=["none", "relu", "leaky"])
def test_bf16_parameters_take_bf16_gradients(slope):
    """The bf16 step's form: bf16 ``x``, ``weight`` and ``bias``."""
    x, dy, weight, bias = _inputs(torch.bfloat16, seed=1, param_dtype=torch.bfloat16)
    (y0, dx0, dw0, db0, _, _), (y1, dx1, dw1, db1, _, _) = _both(x, dy, weight, bias, slope)
    assert torch.equal(y1, y0)
    assert dw1.dtype == db1.dtype == torch.bfloat16
    for name, got, want in (("dx", dx1, dx0), ("dweight", dw1, dw0), ("dbias", db1, db0)):
        _assert_grad_close(got, want, name)


@pytest.mark.parametrize("dtype,sign", [(torch.float32, 0), (torch.float32, -1),
                                        (torch.bfloat16, 0)],
                         ids=["f32-var-0", "f32-var-negative", "bf16-var-0"])
def test_constant_channel_clamps_the_variance(dtype, sign):
    """A constant channel: its raw variance ``E[x^2] - mean^2`` comes out 0
    or, for some values in f32, just below it (clamped to 0; clamp_min
    passes the gradient at 0 and stops it below).  The value is the first
    of a few whose raw variance has the case's sign (a bf16 constant's
    sums are exact at this size: its raw variance is 0)."""
    x, dy, weight, bias = _inputs(dtype, seed=2)
    for value in (1.0, 1.3, 1.1, 2.9, 3.3, 5.7, 0.123, 7.1, 2.3):
        x[:, 1] = value
        _, saved = batchnorm.forward_reference(x, weight, bias, *_running(5), False, EPS,
                                               BN_MOMENTUM, 0.2)
        if np.sign(saved[1, 1].item()) == sign:
            break
    else:
        raise AssertionError(f"no value gives a raw variance of sign {sign}")
    (y0, dx0, dw0, db0, _, _), (y1, dx1, dw1, db1, _, _) = _both(x, dy, weight, bias, 0.2)
    assert torch.equal(y1, y0)
    for name, got, want in (("dx", dx1, dx0), ("dweight", dw1, dw0), ("dbias", db1, db0)):
        _assert_grad_close(got, want, name)


def test_module_switches_and_frozen_scope():
    """``update_running`` on and off, and :func:`running_stats_frozen`: the
    running statistics and ``num_batches_tracked`` move only when asked,
    as the eager rule moves them; the output is the same either way."""
    x, _, weight, bias = _inputs(torch.float32, seed=3)
    bn = FlaxBatchNorm2d(5).train()
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    rm, rv, _ = _running(5)
    y = bn(x, 0.0)
    want = _eager_rule(x, weight, bias, rm, rv, True, 0.0)
    assert torch.equal(y, want)
    assert torch.equal(bn.running_mean, rm) and torch.equal(bn.running_var, rv)
    assert bn.num_batches_tracked.item() == 1
    before = [t.clone() for t in (bn.running_mean, bn.running_var)]
    with running_stats_frozen(bn):
        assert torch.equal(bn(x, 0.0), y)
    bn.update_running = False
    assert torch.equal(bn(x, 0.0), y)
    assert all(torch.equal(a, b) for a, b in zip(before, (bn.running_mean, bn.running_var)))
    assert bn.num_batches_tracked.item() == 1


@pytest.mark.parametrize("slope", [0.0, 0.2], ids=["relu", "leaky"])
def test_eval_mode_is_cudnns_rule_then_the_activation(slope):
    x, _, weight, bias = _inputs(torch.float32, seed=4)
    bn = FlaxBatchNorm2d(5).eval()
    with torch.no_grad():
        bn.running_mean.copy_(bias)
        bn.running_var.copy_(weight)
    plain = torch.nn.functional.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                                           False, 0.0, EPS)
    want = torch.relu(plain) if slope == 0.0 else F.leaky_relu(plain, slope)
    assert torch.equal(bn(x, slope), want)
    assert torch.equal(bn(x), plain)


@pytest.mark.parametrize("slope", [0.0, 0.2])
def test_branch_tape_sees_the_activation(slope):
    """Inside a branch tape the fused Function runs as it does outside one
    and records its activation's input's side of 0; the replay normalises
    alone and applies the activation on the recorded sides, whatever its
    own values say."""
    x, dy, weight, bias = _inputs(torch.float32, seed=5)
    bn = FlaxBatchNorm2d(5).train()
    fused = bn(x, slope)
    tape = []
    with branch_tape(tape):
        recorded = bn(x, slope)
    assert len(tape) == 1 and torch.equal(tape[0], recorded > 0)
    assert torch.equal(recorded, fused)
    double = copy.deepcopy(bn).double()
    plain = copy.deepcopy(double)(x.double())
    for branches in (tape, [~tape[0]]):
        with branch_tape(branches, replay=True):
            replayed = copy.deepcopy(double)(x.double(), slope)
        assert replayed.dtype == torch.float64
        assert torch.equal(replayed, torch.where(branches[0], plain, plain * slope))


def test_counters_count_kernel_launches_only():
    """``bn_fwd`` and ``bn_bwd`` (``_bf16`` for bf16 ``x``) count the
    kernels' launches (five each a CNN step on the card:
    ``tests/test_torch_gpu.py``); the plain version, which launches
    nothing, counts nothing."""
    batchnorm.reset_kernel_launches()
    model = StackedBLSTMCNN(num_lstm_layers=1, lstm_hidden_dim=8, freq_bins=9,
                            enc_filters=(2, 3), dec_filters=(4, 2)).train()
    model.init_weights(torch.Generator().manual_seed(0))
    model(torch.randn(2, 9, 6)).sum().backward()
    x, dy, weight, bias = _inputs(torch.bfloat16, seed=6)
    xs = x.requires_grad_()
    batchnorm.batch_norm_act(xs, weight, bias, *_running(5), True, EPS, BN_MOMENTUM,
                             0.0).backward(dy)
    assert batchnorm.kernel_launches() == {"bn_fwd": 0, "bn_fwd_bf16": 0, "bn_bwd": 0,
                                           "bn_bwd_bf16": 0}
    profiling.count("bn_fwd_bf16")
    assert batchnorm.kernel_launches()["bn_fwd_bf16"] == 1
    batchnorm.reset_kernel_launches()
    assert not any(batchnorm.kernel_launches().values())


@pytest.mark.parametrize("P,chunks,chunk", [(1, 1, 1), (77, 1, 77), (16384, 1, 16384),
                                             (16385, 2, 8193), (107169, 7, 15310)])
def test_launch_plan_covers_each_plane(P, chunks, chunk):
    assert batchnorm.plan(P) == (chunks, chunk)
    assert (chunks - 1) * chunk < P <= chunks * chunk


def test_kernel_path_refuses_cpu_tensors():
    x, _, weight, bias = _inputs(torch.float32)
    with pytest.raises(ValueError, match="need CUDA tensors"):
        batchnorm.forward_kernel(x, weight, bias, *_running(5), True, EPS, BN_MOMENTUM, None)
