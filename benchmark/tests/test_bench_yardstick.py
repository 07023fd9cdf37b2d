"""The yardstick's arithmetic: each LSTM form's least time at the shapes
the cells run (the bounds the port's kernel table gives: 0.052 ms for the
f32 forward at B=32, 0.049 ms for the bf16 forward with its cell states at
B=128, 0.090 ms for the bf16 backward as a whole at B=128), the plain
references' FLOP counts, and the kernel classifier on kernel names recorded
from a traced run on an H100."""

import pytest

from benchmark import spec, yardstick
from benchmark.families import cnn_blstm, gan

T, H = 417, 128


@pytest.mark.parametrize("work, dtype, ms, bound_by", [
    (yardstick.lstm_forward_work(32, T, H, "float32", False), "float32", 0.052, "flops"),
    (yardstick.lstm_forward_work(128, T, H, "bfloat16", True), "bfloat16", 0.049, "bytes"),
    (yardstick.lstm_backward_work(128, T, H, "bfloat16"), "bfloat16", 0.090, "bytes"),
])
def test_lstm_bounds(work, dtype, ms, bound_by):
    by, fl = work
    least = yardstick.least_seconds(by, fl, dtype) * 1e3
    assert least == pytest.approx(ms, abs=5e-4)
    by_bytes = by / yardstick.HBM_BYTES_PER_S >= fl / yardstick.PEAK_FLOP_PER_S[dtype]
    assert by_bytes == (bound_by == "bytes")


def test_lstm_bytes_and_flops():
    # The kernel table's 164 MB and 14.0 GFLOP, 301 MB and 42.0 GFLOP, 3.5 GFLOP.
    assert yardstick.lstm_forward_work(128, T, H, "bfloat16", True) == (164_233_216, 13_992_198_144)
    assert yardstick.lstm_backward_work(128, T, H, "bfloat16") == (301_137_920, 41_976_594_432)
    assert yardstick.lstm_forward_work(32, T, H, "float32", False) == (68_845_568, 3_498_049_536)


def test_family_least_times_match_the_yardstick():
    rc = cnn_blstm.ref_config(spec.load_cell("cnn_blstm_serve_f32_b32").config)
    assert cnn_blstm.lstm_least(rc, 32, "float32", False)["fwd_s"] * 1e3 == pytest.approx(0.0522, abs=1e-4)
    train = cnn_blstm.lstm_least(rc, 128, "bfloat16", True)
    assert train["fwd_s"] * 1e3 == pytest.approx(0.0490, abs=1e-4)
    assert train["bwd_s"] * 1e3 == pytest.approx(0.0899, abs=1e-4)


def test_generator_flops_at_b32():
    rc = gan.ref_config(spec.load_cell("gan_serve_bf16_b32").config)
    assert gan.generator_flops(rc, 32) == pytest.approx(2.831e12, rel=1e-3)


def test_cnn_flops_extrapolate_exactly():
    rc = cnn_blstm.ref_config(spec.load_cell("cnn_blstm_serve_f32_b32").config)
    rc = {**rc, "samples": 20 * rc["hop_length"]}  # 21 frames: short enough to count directly
    from torch.utils.flop_counter import FlopCounterMode
    import torch
    from benchmark.reference import cnn_blstm as ref

    sd = cnn_blstm.meta_weights(rc)
    with FlopCounterMode(display=False) as counter:
        ref.forward(sd, torch.empty((4, rc["freq_bins"], 21), device="meta"),
                    rc["num_lstm_layers"], len(rc["enc_filters"]) + 1)
    assert cnn_blstm.model_flops(rc, 4) == counter.get_total_flops()


RECORDED = {  # kernel names of traced runs on an H100 -> kind
    "sm80_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x32x32_stage4_warpsize4x1x1_g1_tensor16x8x16": "convolution",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64_warpgroupsize1x1x1_g1_execute_segmen": "convolution",
    "void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_optimized_bf16_256x64_32x4_nhwc_align8>(cutlass_tensoro": "convolution",
    "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x8_stage3_warpsize2x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cub": "matmul",
    "void (anonymous namespace)::lstm_fwd_kernel<2, 4>(float const*, float const*, float const*, float const*, float*, float*": "lstm_fwd",
    "void (anonymous namespace)::lstm_bwd_mma_kernel<16, 4>(__nv_bfloat16 const*)": "lstm_bwd",
    "void (anonymous namespace)::lstm_dwhh_reduce_kernel<float>(float const*)": "lstm_dwhh",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy_vectorized<at::native::(anonymous namespace)::OpaqueType<2u>": "copy_cast",
    "void at::native::(anonymous namespace)::upsample_nearest2d_out_frame<c10::BFloat16, &at::native::nearest_neighbor_comput": "resize",
    "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native::CUDAFunctor_add<float> >(at::": "elementwise",
    "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native::direct_copy_kernel_cuda(at::T": "copy_cast",
    "void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)::launch_clamp_scalar(at::TensorItera": "elementwise",
    "void cudnn::bn_fw_inf_1C11_kernel_NCHW<float, float, true, 1>(float, float, cudnnTensorStruct, float const*, cudnnTensor": "batchnorm",
    "void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, __nv_bfloat16, float, false, true, (cudnnKernelDataType": "layout_transpose",
    "void cudnn::engines_precompiled::nhwcToNchwKernel<__nv_bfloat16, __nv_bfloat16, float, true, false, (cudnnKernelDataType": "layout_transpose",
}


@pytest.mark.parametrize("name, kind", sorted(RECORDED.items()))
def test_kernel_kinds(name, kind):
    assert yardstick.kind_of(name) == kind


def test_share_is_none_without_a_base():
    assert yardstick.share(1.0, 0.0) is None
    assert yardstick.share(1.0, 4.0) == 25.0
